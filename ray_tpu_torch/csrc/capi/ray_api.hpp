// ray_tpu_torch C++ public API: the port's copy of the JAX package's
// src/capi/ray_api.hpp, speaking to the port's cluster.
//
// Reference analog: cpp/include/ray/api.h — ray::Init / ray::Put /
// ray::Get / ray::Task(...).Remote() over the cluster's RPC plane. This
// client speaks the framed msgpack wire (8-byte big-endian length +
// 'M' + msgpack map; see ray_tpu_torch/runtime/rpc.py and
// runtime/xlang.py):
//
//   raytpu::Init("127.0.0.1", gcs_port);
//   auto oid = raytpu::Put(raytpu::Value(int64_t{41}));
//   raytpu::Value v = raytpu::Get(oid);
//   auto rid = raytpu::Task("ray_tpu_torch.examples.xlang:add")
//                 .Arg(int64_t{1}).Arg(int64_t{2}).Remote();
//   int64_t sum = raytpu::Get(rid).as_int();
//
// Functions are named by DESCRIPTOR ("module:qualname"), resolved by
// import on the executing Python worker — the reference's cross-language
// calling convention (function descriptors, msgpack args), not pickled
// closures.
#pragma once

#include <string>

#include "msgpack_lite.hpp"

namespace raytpu {

// Connect to a running cluster's GCS and resolve the head raylet.
void Init(const std::string& gcs_host, int gcs_port);
void Shutdown();

// Object plane: plain-data values in, object ids (hex) out.
std::string Put(const Value& value);
Value Get(const std::string& oid_hex, double timeout_s = 30.0);

// Task plane.
class TaskBuilder {
 public:
  explicit TaskBuilder(std::string function_ref);
  TaskBuilder& Arg(Value v);
  TaskBuilder& NumCpus(double n);
  // Submit; returns the return-object id (hex) to pass to Get().
  std::string Remote();

 private:
  std::string function_ref_;
  Array args_;
  double num_cpus_ = 1.0;
};

TaskBuilder Task(const std::string& function_ref);

}  // namespace raytpu
