// Example: a C++ client driving a running ray_tpu_torch cluster.
//
//   ./example_submit <gcs_host> <gcs_port>
//
// Puts an object, reads it back, submits a task by function descriptor
// (executed by a Python worker), and fetches the result. Prints one
// JSON-ish line per check; exits 0 on success.

#include <cstdio>
#include <cstdlib>

#include "ray_api.hpp"

int main(int argc, char** argv) {
  if (argc != 3) {
    std::fprintf(stderr, "usage: %s <gcs_host> <gcs_port>\n", argv[0]);
    return 2;
  }
  try {
    raytpu::Init(argv[1], std::atoi(argv[2]));

    // put/get round trip
    raytpu::Map payload{{"answer", raytpu::Value(int64_t{41})},
                        {"tags", raytpu::Value(raytpu::Array{
                                     raytpu::Value("a"),
                                     raytpu::Value("b")})}};
    std::string oid = raytpu::Put(raytpu::Value(payload));
    raytpu::Value back = raytpu::Get(oid);
    if (back["answer"].as_int() != 41 ||
        back["tags"].as_array().size() != 2) {
      std::fprintf(stderr, "put/get mismatch\n");
      return 1;
    }
    std::printf("{\"put_get\": \"ok\", \"oid\": \"%s\"}\n", oid.c_str());

    // task submission by function descriptor, executed by a Python worker
    std::string rid = raytpu::Task("ray_tpu_torch.examples.xlang:add")
                          .Arg(raytpu::Value(int64_t{40}))
                          .Arg(raytpu::Value(int64_t{2}))
                          .Remote();
    int64_t sum = raytpu::Get(rid, 60.0).as_int();
    if (sum != 42) {
      std::fprintf(stderr, "task result mismatch: %lld\n",
                   static_cast<long long>(sum));
      return 1;
    }
    std::printf("{\"task\": \"ok\", \"result\": %lld}\n",
                static_cast<long long>(sum));

    // a second shape: list + dict result
    std::string rid2 =
        raytpu::Task("ray_tpu_torch.examples.xlang:stats")
            .Arg(raytpu::Value(raytpu::Array{raytpu::Value(int64_t{3}),
                                             raytpu::Value(int64_t{1}),
                                             raytpu::Value(int64_t{8})}))
            .Remote();
    raytpu::Value st = raytpu::Get(rid2, 60.0);
    if (st["n"].as_int() != 3 || st["max"].as_double() != 8.0) {
      std::fprintf(stderr, "stats mismatch\n");
      return 1;
    }
    std::printf("{\"stats\": \"ok\", \"sum\": %.1f}\n",
                st["sum"].as_double());

    raytpu::Shutdown();
    return 0;
  } catch (const std::exception& e) {
    std::fprintf(stderr, "FAILED: %s\n", e.what());
    return 1;
  }
}
