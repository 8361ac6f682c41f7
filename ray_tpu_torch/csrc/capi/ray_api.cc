// ray_tpu_torch C++ public API implementation: framed msgpack RPC
// client. See ray_api.hpp; wire/protocol notes in
// ray_tpu_torch/runtime/rpc.py.

#include "ray_api.hpp"

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstring>
#include <fstream>
#include <mutex>
#include <stdexcept>

namespace raytpu {
namespace {

class RpcClient {
 public:
  RpcClient(const std::string& host, int port) {
    fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd_ < 0) throw std::runtime_error("socket() failed");
    int one = 1;
    ::setsockopt(fd_, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (::inet_pton(AF_INET, host.c_str(), &addr.sin_addr) != 1)
      throw std::runtime_error("bad address: " + host);
    if (::connect(fd_, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0)
      throw std::runtime_error("connect failed to " + host + ":" +
                               std::to_string(port));
  }
  ~RpcClient() {
    if (fd_ >= 0) ::close(fd_);
  }
  RpcClient(const RpcClient&) = delete;
  RpcClient& operator=(const RpcClient&) = delete;

  // One synchronous request/response (requests are serialized per
  // client with a mutex; the server answers msgpack frames in msgpack).
  Value call(const std::string& method, Map params) {
    std::lock_guard<std::mutex> g(mu_);
    params.emplace("method", Value(method));
    params.emplace("_id", Value(static_cast<int64_t>(next_id_++)));
    std::string payload = "M";
    Value(std::move(params)).pack(payload);
    std::string frame;
    for (int i = 7; i >= 0; --i)
      frame.push_back(
          static_cast<char>((payload.size() >> (8 * i)) & 0xff));
    frame += payload;
    send_all(frame.data(), frame.size());

    uint8_t hdr[8];
    recv_all(hdr, 8);
    uint64_t len = 0;
    for (int i = 0; i < 8; ++i) len = (len << 8) | hdr[i];
    std::vector<uint8_t> buf(len);
    recv_all(buf.data(), len);
    if (len == 0 || buf[0] != 'M')
      throw std::runtime_error("server replied in a non-msgpack format");
    size_t off = 1;
    Value reply = Value::unpack(buf.data(), len, off);
    const Value& err = reply["error"];
    if (!err.is_nil())
      throw std::runtime_error("rpc " + method + " failed: " + err.as_str());
    return reply["result"];
  }

 private:
  void send_all(const char* data, size_t n) {
    size_t sent = 0;
    while (sent < n) {
      ssize_t rc = ::send(fd_, data + sent, n - sent, 0);
      if (rc <= 0) throw std::runtime_error("send failed");
      sent += static_cast<size_t>(rc);
    }
  }
  void recv_all(uint8_t* data, size_t n) {
    size_t got = 0;
    while (got < n) {
      ssize_t rc = ::recv(fd_, data + got, n - got, 0);
      if (rc <= 0) throw std::runtime_error("connection lost");
      got += static_cast<size_t>(rc);
    }
  }

  int fd_ = -1;
  int64_t next_id_ = 0;
  std::mutex mu_;
};

struct Session {
  std::unique_ptr<RpcClient> gcs;
  std::unique_ptr<RpcClient> raylet;
};

Session* g_session = nullptr;

std::string random_hex(size_t nbytes) {
  std::ifstream ur("/dev/urandom", std::ios::binary);
  std::vector<uint8_t> buf(nbytes);
  ur.read(reinterpret_cast<char*>(buf.data()),
          static_cast<std::streamsize>(nbytes));
  static const char* hexd = "0123456789abcdef";
  std::string out;
  out.reserve(nbytes * 2);
  for (uint8_t b : buf) {
    out.push_back(hexd[b >> 4]);
    out.push_back(hexd[b & 0x0f]);
  }
  return out;
}

Session& session() {
  if (!g_session)
    throw std::runtime_error("raytpu::Init() has not been called");
  return *g_session;
}

}  // namespace

void Init(const std::string& gcs_host, int gcs_port) {
  auto s = std::make_unique<Session>();
  s->gcs = std::make_unique<RpcClient>(gcs_host, gcs_port);
  Value nodes = s->gcs->call("get_nodes", Map{{"alive_only", Value(true)}});
  if (nodes.as_array().empty())
    throw std::runtime_error("no alive nodes in cluster");
  // prefer the head node (label) like the Python driver does
  const Value* chosen = &nodes.as_array()[0];
  for (const auto& n : nodes.as_array()) {
    const Value& labels = n["labels"];
    if (labels.type() == Value::Type::Obj && !labels["head"].is_nil()) {
      chosen = &n;
      break;
    }
  }
  const Array& addr = (*chosen)["address"].as_array();
  s->raylet = std::make_unique<RpcClient>(
      addr[0].as_str(), static_cast<int>(addr[1].as_int()));
  delete g_session;
  g_session = s.release();
}

void Shutdown() {
  delete g_session;
  g_session = nullptr;
}

std::string Put(const Value& value) {
  Value r = session().raylet->call("xlang_put", Map{{"value", value}});
  return r["oid"].as_str();
}

Value Get(const std::string& oid_hex, double timeout_s) {
  Value r = session().raylet->call(
      "xlang_get",
      Map{{"oid", Value(oid_hex)}, {"timeout_s", Value(timeout_s)}});
  return r["value"];
}

TaskBuilder::TaskBuilder(std::string function_ref)
    : function_ref_(std::move(function_ref)) {}

TaskBuilder& TaskBuilder::Arg(Value v) {
  args_.push_back(std::move(v));
  return *this;
}

TaskBuilder& TaskBuilder::NumCpus(double n) {
  num_cpus_ = n;
  return *this;
}

std::string TaskBuilder::Remote() {
  std::string return_oid = random_hex(16);
  Map task;
  task.emplace("task_id", Value(random_hex(16)));
  task.emplace("name", Value(function_ref_));
  task.emplace("function_ref", Value(function_ref_));
  task.emplace("args", Value(args_));
  task.emplace("return_oids", Value(Array{Value(return_oid)}));
  task.emplace("resources", Value(Map{{"CPU", Value(num_cpus_)}}));
  task.emplace("strategy", Value(Map{{"kind", Value("DEFAULT")}}));
  task.emplace("max_retries", Value(int64_t{0}));
  Value r = session().raylet->call("submit_task",
                                   Map{{"task", Value(std::move(task))}});
  (void)r;
  return return_oid;
}

TaskBuilder Task(const std::string& function_ref) {
  return TaskBuilder(function_ref);
}

}  // namespace raytpu
