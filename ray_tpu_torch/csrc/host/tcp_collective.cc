// Host-side CPU collective backend over TCP: the Gloo analog of the
// reference's ray.util.collective gloo backend (reference:
// python/ray/util/collective/collective_group/gloo_collective_group.py).
// The port's own copy of ray_tpu's src/collective/tcp_collective.cc, built
// by ray_tpu_torch/_private/build.py at first use and bound by
// ray_tpu_torch/_private/tcp_collective.py.
//
// Design: full-mesh blocking TCP sockets between ranks (pair (i,j), i<j:
// j dials i's listen port), bandwidth-optimal ring algorithms:
//   allreduce      = ring reduce-scatter + ring allgather, 2(N-1) steps
//   reduce_scatter = ring, N-1 steps
//   allgather      = ring, N-1 steps
//   broadcast      = binomial tree from root
//   barrier        = allreduce of one int64
//   send/recv      = framed p2p with tag matching (per-peer reorder buffer)
//
// Exposed as a C ABI for ctypes. All buffers are caller-owned contiguous
// memory; ops are synchronous. This is the host data plane only: device
// collectives between rank processes go through torch.distributed
// (ray_tpu_torch/parallel/collectives.py).

#include <arpa/inet.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <string.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <cerrno>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

enum Dtype { F32 = 0, F64 = 1, I32 = 2, I64 = 3 };
enum Op { SUM = 0, PROD = 1, MAX = 2, MIN = 3 };

size_t dtype_size(int dt) {
  switch (dt) {
    case F32: case I32: return 4;
    default: return 8;
  }
}

// ---- socket helpers -------------------------------------------------------

int send_all(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t k = ::send(fd, p, n, MSG_NOSIGNAL);
    if (k < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    p += k;
    n -= static_cast<size_t>(k);
  }
  return 0;
}

int recv_all(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t k = ::recv(fd, p, n, 0);
    if (k < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    if (k == 0) return -ECONNRESET;
    p += k;
    n -= static_cast<size_t>(k);
  }
  return 0;
}

void set_nodelay(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
}

// ---- elementwise reduction ------------------------------------------------

template <typename T>
void reduce_typed(T* acc, const T* in, size_t count, int op) {
  switch (op) {
    case SUM:  for (size_t i = 0; i < count; i++) acc[i] += in[i]; break;
    case PROD: for (size_t i = 0; i < count; i++) acc[i] *= in[i]; break;
    case MAX:  for (size_t i = 0; i < count; i++) acc[i] = std::max(acc[i], in[i]); break;
    case MIN:  for (size_t i = 0; i < count; i++) acc[i] = std::min(acc[i], in[i]); break;
  }
}

void reduce_buf(void* acc, const void* in, size_t count, int dtype, int op) {
  switch (dtype) {
    case F32: reduce_typed(static_cast<float*>(acc), static_cast<const float*>(in), count, op); break;
    case F64: reduce_typed(static_cast<double*>(acc), static_cast<const double*>(in), count, op); break;
    case I32: reduce_typed(static_cast<int32_t*>(acc), static_cast<const int32_t*>(in), count, op); break;
    case I64: reduce_typed(static_cast<int64_t*>(acc), static_cast<const int64_t*>(in), count, op); break;
  }
}

// ---- group ----------------------------------------------------------------

struct Frame {
  int64_t tag;
  std::vector<char> payload;
};

struct Group {
  int rank = -1;
  int world = 0;
  std::vector<int> fds;  // fds[peer]; -1 for self
  // Sockets are full-duplex: independent send/recv locks per peer so a
  // large ring step can send and receive on the same socket concurrently
  // (a single lock deadlocks at world=2 once TCP buffers fill).
  std::vector<std::unique_ptr<std::mutex>> send_mu;
  std::vector<std::unique_ptr<std::mutex>> recv_mu;
  std::map<int, std::vector<Frame>> stash;  // peer -> out-of-order frames
  std::mutex stash_mu;
  // Per-group collective tag counter. Must be per-group (NOT process
  // global): multiple ranks of one group can live in one process
  // (thread-based workers), and every rank must draw identical tag
  // blocks for the same collective sequence (SPMD contract).
  int64_t ring_tag = (int64_t)1 << 40;
  // two-phase setup state (tc_listen -> rendezvous -> tc_connect)
  int lfd = -1;
  int lport = 0;

  ~Group() {
    for (int fd : fds)
      if (fd >= 0) ::close(fd);
  }
};

std::mutex g_mu;
std::map<int, std::shared_ptr<Group>> g_groups;
int g_next = 1;

std::shared_ptr<Group> get_group(int h) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_groups.find(h);
  return it == g_groups.end() ? nullptr : it->second;
}

int parse_peer(const std::string& s, std::string* host, int* port) {
  auto c = s.rfind(':');
  if (c == std::string::npos) return -1;
  *host = s.substr(0, c);
  *port = std::atoi(s.c_str() + c + 1);
  return 0;
}

int dial(const std::string& host, int port, int timeout_ms) {
  struct addrinfo hints{}, *res = nullptr;
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  char portstr[16];
  snprintf(portstr, sizeof portstr, "%d", port);
  if (getaddrinfo(host.c_str(), portstr, &hints, &res) != 0) return -1;
  // Wall-clock deadline: connect() itself can block for the kernel's SYN
  // retry window, so budgeting only the sleeps would overshoot the
  // timeout contract by orders of magnitude. Non-blocking connect + poll
  // keeps every wait accountable to the deadline.
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  int fd = -1;
  // retry loop: the listener may not be up yet during group formation
  while (std::chrono::steady_clock::now() < deadline) {
    fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
    if (fd < 0) break;
    int rc = connect(fd, res->ai_addr, res->ai_addrlen);
    if (rc != 0 && errno == EINPROGRESS) {
      auto left = std::chrono::duration_cast<std::chrono::milliseconds>(
                      deadline - std::chrono::steady_clock::now())
                      .count();
      pollfd pf{fd, POLLOUT, 0};
      if (left > 0 && poll(&pf, 1, static_cast<int>(left)) == 1) {
        int err = 0;
        socklen_t elen = sizeof err;
        getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &elen);
        if (err == 0) rc = 0;
      }
    }
    if (rc == 0) {
      // back to blocking mode for the data path
      int flags = fcntl(fd, F_GETFL, 0);
      fcntl(fd, F_SETFL, flags & ~O_NONBLOCK);
      break;
    }
    ::close(fd);
    fd = -1;
    usleep(50 * 1000);
  }
  freeaddrinfo(res);
  if (fd >= 0) set_nodelay(fd);
  return fd;
}

// framed p2p: [tag:int64][nbytes:int64][payload]
int send_frame(Group& g, int dst, int64_t tag, const void* data, int64_t nbytes) {
  std::lock_guard<std::mutex> lk(*g.send_mu[dst]);
  int64_t hdr[2] = {tag, nbytes};
  int rc = send_all(g.fds[dst], hdr, sizeof hdr);
  if (rc) return rc;
  return send_all(g.fds[dst], data, static_cast<size_t>(nbytes));
}

bool take_stashed(Group& g, int src, int64_t tag, void* data, int64_t nbytes,
                  int* rc_out) {
  std::lock_guard<std::mutex> lk(g.stash_mu);
  auto& q = g.stash[src];
  for (auto it = q.begin(); it != q.end(); ++it) {
    if (it->tag == tag) {
      if (static_cast<int64_t>(it->payload.size()) != nbytes) {
        *rc_out = -EINVAL;
        return true;
      }
      memcpy(data, it->payload.data(), it->payload.size());
      q.erase(it);
      *rc_out = 0;
      return true;
    }
  }
  return false;
}

// timeout_ms <= 0 means block forever.
int recv_frame_t(Group& g, int src, int64_t tag, void* data, int64_t nbytes,
                 int timeout_ms) {
  int rc = 0;
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  auto expired = [&] {
    return timeout_ms > 0 && std::chrono::steady_clock::now() >= deadline;
  };
  for (;;) {
    // Re-check the stash EVERY iteration: a concurrent recv() for a
    // different tag may have read our frame off the socket and stashed
    // it while we waited on recv_mu — checking only once deadlocks two
    // threads that each stash the other's frame.
    if (take_stashed(g, src, tag, data, nbytes, &rc)) return rc;
    if (expired()) return -ETIMEDOUT;
    std::unique_lock<std::mutex> lk(*g.recv_mu[src], std::try_to_lock);
    if (!lk.owns_lock()) {
      // another thread is draining this peer's socket; let it work,
      // then re-check the stash
      usleep(200);
      continue;
    }
    if (timeout_ms > 0) {
      pollfd pf{g.fds[src], POLLIN, 0};
      int pr = poll(&pf, 1, 50);
      if (pr == 0) continue;  // drop the lock, re-check stash/deadline
      if (pr < 0) return -errno;
    }
    int64_t hdr[2];
    rc = recv_all(g.fds[src], hdr, sizeof hdr);
    if (rc) return rc;
    if (hdr[0] == tag) {
      if (hdr[1] != nbytes) return -EINVAL;
      return recv_all(g.fds[src], data, static_cast<size_t>(nbytes));
    }
    Frame f;
    f.tag = hdr[0];
    f.payload.resize(static_cast<size_t>(hdr[1]));
    rc = recv_all(g.fds[src], f.payload.data(), f.payload.size());
    if (rc) return rc;
    std::lock_guard<std::mutex> sk(g.stash_mu);
    g.stash[src].push_back(std::move(f));
  }
}

int recv_frame(Group& g, int src, int64_t tag, void* data, int64_t nbytes) {
  return recv_frame_t(g, src, tag, data, nbytes, 0);
}

// simultaneous send-to-next / recv-from-prev without deadlock
int ring_exchange(Group& g, int64_t tag, const void* out, int64_t out_n,
                  void* in, int64_t in_n) {
  int nxt = (g.rank + 1) % g.world;
  int prv = (g.rank - 1 + g.world) % g.world;
  int send_rc = 0;
  std::thread t([&] { send_rc = send_frame(g, nxt, tag, out, out_n); });
  int recv_rc = recv_frame(g, prv, tag, in, in_n);
  t.join();
  return send_rc ? send_rc : recv_rc;
}

// Collective tags live above user tags; each collective reserves a
// disjoint block from the group's counter.
int64_t take_tags(Group& g, int64_t n) {
  int64_t t = g.ring_tag;
  g.ring_tag += n;
  return t;
}

}  // namespace

namespace {  // setup helpers

std::shared_ptr<Group> make_group(int rank, int world) {
  auto g = std::make_shared<Group>();
  g->rank = rank;
  g->world = world;
  g->fds.assign(world, -1);
  for (int i = 0; i < world; i++) {
    g->send_mu.emplace_back(new std::mutex);
    g->recv_mu.emplace_back(new std::mutex);
  }
  return g;
}

// Bind the rank's listener (port 0 = ephemeral) and record the bound port.
int do_listen(Group& g, int port) {
  int nacc = g.world - 1 - g.rank;
  if (nacc <= 0) {
    g.lport = port;
    return 0;
  }
  int lfd = socket(AF_INET, SOCK_STREAM, 0);
  if (lfd < 0) return -errno;
  int one = 1;
  setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = INADDR_ANY;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(lfd, reinterpret_cast<sockaddr*>(&addr), sizeof addr) < 0 ||
      listen(lfd, g.world) < 0) {
    int e = errno;
    ::close(lfd);
    return -e;
  }
  socklen_t alen = sizeof addr;
  if (getsockname(lfd, reinterpret_cast<sockaddr*>(&addr), &alen) < 0) {
    int e = errno;
    ::close(lfd);
    return -e;
  }
  g.lfd = lfd;
  g.lport = ntohs(addr.sin_port);
  return 0;
}

int do_connect(Group& g, const std::vector<std::string>& peers,
               int timeout_ms) {
  // dial every rank below me (its listener is peers[j]); announce my rank
  for (int j = 0; j < g.rank; j++) {
    std::string h2;
    int p2;
    if (parse_peer(peers[j], &h2, &p2) != 0) return -EINVAL;
    int fd = dial(h2, p2, timeout_ms);
    if (fd < 0) return -ETIMEDOUT;
    int32_t me = g.rank;
    if (send_all(fd, &me, sizeof me)) {
      ::close(fd);
      return -EIO;
    }
    g.fds[j] = fd;
  }
  // accept every rank above me
  int nacc = g.world - 1 - g.rank;
  for (int k = 0; k < nacc; k++) {
    pollfd pf{g.lfd, POLLIN, 0};
    int pr = poll(&pf, 1, timeout_ms);
    if (pr <= 0) return -ETIMEDOUT;
    int fd = accept(g.lfd, nullptr, nullptr);
    if (fd < 0) return -errno;
    set_nodelay(fd);
    int32_t who = -1;
    if (recv_all(fd, &who, sizeof who) || who <= g.rank || who >= g.world ||
        g.fds[who] != -1) {
      ::close(fd);
      return -EPROTO;
    }
    g.fds[who] = fd;
  }
  if (g.lfd >= 0) {
    ::close(g.lfd);
    g.lfd = -1;
  }
  return 0;
}

std::vector<std::string> split_csv(const char* s) {
  std::vector<std::string> out;
  std::string cur, csv(s);
  for (char ch : csv) {
    if (ch == ',') {
      out.push_back(cur);
      cur.clear();
    } else {
      cur.push_back(ch);
    }
  }
  if (!cur.empty()) out.push_back(cur);
  return out;
}

int register_group(std::shared_ptr<Group> g) {
  std::lock_guard<std::mutex> lk(g_mu);
  int h = g_next++;
  g_groups[h] = std::move(g);
  return h;
}

}  // namespace

extern "C" {

// One-shot setup with pre-agreed ports. peers_csv:
// "host0:port0,host1:port1,..." — entry i is rank i's listener.
// Returns handle > 0, or negative errno.
int tc_init(int rank, int world, const char* peers_csv, int timeout_ms) {
  if (rank < 0 || world <= 0 || rank >= world) return -EINVAL;
  auto peers = split_csv(peers_csv);
  if (static_cast<int>(peers.size()) != world) return -EINVAL;
  auto g = make_group(rank, world);
  if (world == 1) return register_group(g);
  std::string host;
  int port = 0;
  if (parse_peer(peers[rank], &host, &port) != 0) return -EINVAL;
  int rc = do_listen(*g, port);
  if (rc) return rc;
  rc = do_connect(*g, peers, timeout_ms);
  if (rc) return rc;
  return register_group(g);
}

// Two-phase setup — eliminates the advertise-then-bind race: the listener
// is bound (ephemeral port) BEFORE the address is advertised through
// rendezvous.
//   h = tc_listen(rank, world); port = tc_listen_port(h);
//   <exchange host:port out of band>; tc_connect(h, peers_csv, timeout).
int tc_listen(int rank, int world) {
  if (rank < 0 || world <= 0 || rank >= world) return -EINVAL;
  auto g = make_group(rank, world);
  int rc = do_listen(*g, 0);
  if (rc) return rc;
  return register_group(g);
}

int tc_listen_port(int h) {
  auto g = get_group(h);
  return g ? g->lport : -EINVAL;
}

int tc_connect(int h, const char* peers_csv, int timeout_ms) {
  auto g = get_group(h);
  if (!g) return -EINVAL;
  if (g->world == 1) return 0;
  auto peers = split_csv(peers_csv);
  if (static_cast<int>(peers.size()) != g->world) return -EINVAL;
  return do_connect(*g, peers, timeout_ms);
}

int tc_destroy(int h) {
  std::lock_guard<std::mutex> lk(g_mu);
  return g_groups.erase(h) ? 0 : -EINVAL;
}

// In-place ring allreduce over `count` elements.
int tc_allreduce(int h, void* data, int64_t count, int dtype, int op) {
  auto g = get_group(h);
  if (!g) return -EINVAL;
  if (g->world == 1) return 0;
  size_t esz = dtype_size(dtype);
  int N = g->world;
  char* buf = static_cast<char*>(data);

  // chunk boundaries (last chunk absorbs the remainder)
  std::vector<int64_t> off(N + 1);
  int64_t per = count / N;
  for (int i = 0; i < N; i++) off[i] = i * per;
  off[N] = count;

  int64_t maxc = 0;
  for (int i = 0; i < N; i++) maxc = std::max(maxc, off[i + 1] - off[i]);
  std::vector<char> tmp(static_cast<size_t>(maxc) * esz);
  int64_t tag = take_tags(*g, 2 * N);

  // reduce-scatter: after N-1 steps, rank r owns reduced chunk (r+1)%N
  for (int s = 0; s < N - 1; s++) {
    int send_c = ((g->rank - s) % N + N) % N;
    int recv_c = ((g->rank - s - 1) % N + N) % N;
    int64_t sn = (off[send_c + 1] - off[send_c]) * esz;
    int64_t rn = (off[recv_c + 1] - off[recv_c]) * esz;
    int rc = ring_exchange(*g, tag + s, buf + off[send_c] * esz, sn,
                           tmp.data(), rn);
    if (rc) return rc;
    reduce_buf(buf + off[recv_c] * esz, tmp.data(),
               off[recv_c + 1] - off[recv_c], dtype, op);
  }
  // allgather the reduced chunks
  for (int s = 0; s < N - 1; s++) {
    int send_c = ((g->rank + 1 - s) % N + N) % N;
    int recv_c = ((g->rank - s) % N + N) % N;
    int64_t sn = (off[send_c + 1] - off[send_c]) * esz;
    int64_t rn = (off[recv_c + 1] - off[recv_c]) * esz;
    int rc = ring_exchange(*g, tag + N + s, buf + off[send_c] * esz, sn,
                           buf + off[recv_c] * esz, rn);
    if (rc) return rc;
    (void)rn;
  }
  return 0;
}

// out must hold world*count elements; rank r's contribution lands at r*count.
int tc_allgather(int h, const void* in, void* out, int64_t count, int dtype) {
  auto g = get_group(h);
  if (!g) return -EINVAL;
  size_t esz = dtype_size(dtype);
  int64_t nb = count * static_cast<int64_t>(esz);
  char* obuf = static_cast<char*>(out);
  memcpy(obuf + g->rank * nb, in, static_cast<size_t>(nb));
  if (g->world == 1) return 0;
  int N = g->world;
  int64_t tag = take_tags(*g, N);
  for (int s = 0; s < N - 1; s++) {
    int send_c = ((g->rank - s) % N + N) % N;
    int recv_c = ((g->rank - s - 1) % N + N) % N;
    int rc = ring_exchange(*g, tag + s, obuf + send_c * nb, nb,
                           obuf + recv_c * nb, nb);
    if (rc) return rc;
  }
  return 0;
}

// in has world*count elements; out gets this rank's reduced chunk (count).
int tc_reduce_scatter(int h, const void* in, void* out, int64_t count,
                      int dtype, int op) {
  auto g = get_group(h);
  if (!g) return -EINVAL;
  size_t esz = dtype_size(dtype);
  int64_t nb = count * static_cast<int64_t>(esz);
  int N = g->world;
  if (N == 1) { memcpy(out, in, static_cast<size_t>(nb)); return 0; }
  // work on a scratch copy so `in` stays const
  std::vector<char> work(static_cast<size_t>(nb) * N);
  memcpy(work.data(), in, work.size());
  std::vector<char> tmp(static_cast<size_t>(nb));
  int64_t tag = take_tags(*g, N);
  // chunk indices shifted by -1 vs the allreduce phase so the ring ends
  // with rank r owning fully-reduced chunk r (matches the API contract)
  for (int s = 0; s < N - 1; s++) {
    int send_c = ((g->rank - s - 1) % N + N) % N;
    int recv_c = ((g->rank - s - 2) % N + N) % N;
    int rc = ring_exchange(*g, tag + s, work.data() + send_c * nb, nb,
                           tmp.data(), nb);
    if (rc) return rc;
    reduce_buf(work.data() + recv_c * nb, tmp.data(), count, dtype, op);
  }
  memcpy(out, work.data() + g->rank * nb, static_cast<size_t>(nb));
  return 0;
}

// Binomial-tree broadcast from root.
int tc_broadcast(int h, void* data, int64_t count, int dtype, int root) {
  auto g = get_group(h);
  if (!g) return -EINVAL;
  if (g->world == 1) return 0;
  int N = g->world;
  int64_t nb = count * static_cast<int64_t>(dtype_size(dtype));
  int vrank = (g->rank - root + N) % N;  // root becomes virtual rank 0
  int64_t tag = take_tags(*g, 1);
  int mask = 1;
  while (mask < N) mask <<= 1;
  // binomial tree: at step `bit`, every rank that already holds the data
  // (vrank multiple of 2*bit) forwards to vrank+bit
  for (int bit = mask >> 1; bit >= 1; bit >>= 1) {
    if (vrank % (2 * bit) == 0) {
      int peer_v = vrank + bit;
      if (peer_v < N) {
        int peer = (peer_v + root) % N;
        int rc = send_frame(*g, peer, tag, data, nb);
        if (rc) return rc;
      }
    } else if (vrank % (2 * bit) == bit) {
      int peer = ((vrank - bit) + root) % N;
      int rc = recv_frame(*g, peer, tag, data, nb);
      if (rc) return rc;
    }
  }
  return 0;
}

int tc_barrier(int h) {
  int64_t x = 1;
  return tc_allreduce(h, &x, 1, I64, SUM);
}

int tc_send(int h, const void* data, int64_t nbytes, int dst, int tag) {
  auto g = get_group(h);
  if (!g || dst < 0 || dst >= g->world || dst == g->rank) return -EINVAL;
  return send_frame(*g, dst, tag, data, nbytes);
}

int tc_recv(int h, void* data, int64_t nbytes, int src, int tag) {
  auto g = get_group(h);
  if (!g || src < 0 || src >= g->world || src == g->rank) return -EINVAL;
  return recv_frame(*g, src, tag, data, nbytes);
}

// timeout_ms <= 0 blocks forever; returns -ETIMEDOUT on expiry.
int tc_recv_timeout(int h, void* data, int64_t nbytes, int src, int tag,
                    int timeout_ms) {
  auto g = get_group(h);
  if (!g || src < 0 || src >= g->world || src == g->rank) return -EINVAL;
  return recv_frame_t(*g, src, tag, data, nbytes, timeout_ms);
}

}  // extern "C"
