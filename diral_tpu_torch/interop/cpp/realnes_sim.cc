// Toy-RealNeS: a C++ discrete-event V2V simulator stand-in that speaks the
// reference's agent protocol (diral_tpu/interop/cpp/realnes_sim.cc, copied;
// schema diral_tpu/interop/ma_messages.proto; roles per reference
// envs/realness_bridge.py -- the simulator is the connecting/requesting
// side, the agent binds and grants).
//
// The real RealNeS (C++/TCL, absent from the reference repo) computed
// channel physics and mobility and drove the agent with per-user
// sequence-numbered scheduling requests carrying piggybacked neighbor
// tables (message catalog: envs/ma_messages_pb2.py).  This stand-in
// reproduces that interaction pattern over the toy world model:
//
//   per round (SN), per vehicle: send MA_SchedulingRequestSynDist
//     {user_id, neighbor table, SN, reward of previous round}
//   <- MA_SchedulingGrant{time_stamp = chosen resource}  (stop on request)
//   then: per-transmitter raw PRR (reported in the request's reward field;
//   the agent maps PRR -> reward, realness_env.py:377-394), seq-gated
//   neighbor-table merges from each receiver's closest transmitter, and
//   modular mobility advance -- the same world rules as the Python oracle.
//
// Request modes (last CLI arg, default "dist"):
//   dist  MA_SchedulingRequestSynDist with the piggybacked neighbor table
//         (reference get_observation_syn_dist path, realness_env.py:360-396)
//   syn   MA_SchedulingRequestSyn with per-channel sensed RSSI (int dB) as
//         state; the UE's own last-transmit channel is zeroed, matching the
//         reference's "already set to zero from the simulator" half-duplex
//         note (realness_env.py:343-344); agent path get_observation_syn
//   sps   SPS_SchedulingRequestSyn with per-channel sensed RSSI (double dB)
//         -- the selection window the reference's v2x_sps consumed
//         (realness_bridge.py:195-208)
//
// An optional reward-collector endpoint serves MA_RewardSentAll on a second
// port (REP role), mirroring the reference's :5557 collector.
//
// Transports (optional last CLI arg, default "framed"):
//   framed  4-byte big-endian length + protobuf payload (transport.py's
//           framed flavor)
//   zmq     real libzmq REQ/REP (the reference's actual wire,
//           realness_bridge.py:25-43), loaded at runtime via dlopen --
//           of the library named by the optional argument after the
//           transport (the agent side passes the one it found, e.g. the
//           copy bundled in pyzmq's wheel), else of libzmq.so.5 /
//           libzmq.so.  No dev headers are needed: the stable zmq C ABI
//           is declared locally below.
//
// Build: see Makefile (g++ -ldl -lpthread).  The messages go through
// wire.h, a hand-written proto2 codec with the generated classes' method
// names and protobuf's bytes, so no protoc and no libprotobuf are needed.

#include <arpa/inet.h>
#include <dlfcn.h>
#include <netdb.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cmath>
#include <mutex>
#include <cstdint>
#include <cstring>
#include <iostream>
#include <memory>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include "wire.h"

using wire::MA_NeighborTableEntry;
using wire::MA_RewardSent;
using wire::MA_RewardSentAll;
using wire::MA_SchedulingGrant;
using wire::MA_SchedulingRequestSyn;
using wire::MA_SchedulingRequestSynDist;
using wire::MA_SimInitAck;
using wire::MA_SimInitMsg;
using wire::SPS_SchedulingRequestSyn;

namespace {

// ---------------------------------------------------------------------
// framed-TCP helpers
// ---------------------------------------------------------------------

bool send_all(int fd, const char* buf, size_t n) {
  while (n > 0) {
    ssize_t w = ::send(fd, buf, n, 0);
    if (w <= 0) return false;
    buf += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool recv_all(int fd, char* buf, size_t n) {
  while (n > 0) {
    ssize_t r = ::recv(fd, buf, n, 0);
    if (r <= 0) return false;
    buf += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

// One send() for the header and the payload together: sent apart, the
// payload waits under Nagle's rule for the ACK of the 4-byte header, which
// the peer delays (~40 ms on Linux) -- a stall on every request.
bool send_frame(int fd, const std::string& payload) {
  uint32_t len = htonl(static_cast<uint32_t>(payload.size()));
  std::string frame(reinterpret_cast<const char*>(&len), 4);
  frame += payload;
  return send_all(fd, frame.data(), frame.size());
}

bool recv_frame(int fd, std::string* out) {
  uint32_t len_be;
  if (!recv_all(fd, reinterpret_cast<char*>(&len_be), 4)) return false;
  uint32_t len = ntohl(len_be);
  out->resize(len);
  return recv_all(fd, out->data(), len);
}

int connect_to(const std::string& host, int port) {
  addrinfo hints{}, *res;
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  std::string port_s = std::to_string(port);
  for (int attempt = 0; attempt < 100; ++attempt) {
    if (getaddrinfo(host.c_str(), port_s.c_str(), &hints, &res) == 0) {
      int fd = socket(res->ai_family, res->ai_socktype, res->ai_protocol);
      if (fd >= 0 && connect(fd, res->ai_addr, res->ai_addrlen) == 0) {
        freeaddrinfo(res);
        return fd;
      }
      if (fd >= 0) close(fd);
      freeaddrinfo(res);
    }
    usleep(100 * 1000);
  }
  return -1;
}

// ---------------------------------------------------------------------
// transport seam: the requesting (sim) side sends one protobuf payload
// and receives one reply, strictly alternating -- REQ semantics in both
// flavors.  The reward collector is the replying (REP) side.
// ---------------------------------------------------------------------

struct Transport {
  virtual bool send(const std::string& payload) = 0;
  virtual bool recv(std::string* out) = 0;
  virtual ~Transport() = default;
};

struct FramedTcpReq : Transport {
  int fd;
  explicit FramedTcpReq(int fd_) : fd(fd_) {}
  bool send(const std::string& p) override { return send_frame(fd, p); }
  bool recv(std::string* out) override { return recv_frame(fd, out); }
  ~FramedTcpReq() override { ::close(fd); }
};

// The libzmq to dlopen: set from the command line before the first
// ZmqLib::get(); empty means libzmq.so.5, then libzmq.so.
std::string g_libzmq_path;

// Minimal libzmq ABI, resolved at runtime (dlopen of g_libzmq_path, or
// libzmq.so.5 / .so).  Constants and signatures per the public, ABI-stable
// zmq.h.
struct ZmqLib {
  static constexpr int REQ = 3, REP = 4, LINGER = 17, RCVTIMEO = 27,
                       SNDTIMEO = 28;
  struct Msg { unsigned char opaque[64]; };  // zmq_msg_t

  void* (*ctx_new)();
  int (*ctx_term)(void*);
  void* (*socket)(void*, int);
  int (*close_)(void*);
  int (*bind)(void*, const char*);
  int (*connect)(void*, const char*);
  int (*setsockopt)(void*, int, const void*, size_t);
  int (*send)(void*, const void*, size_t, int);
  int (*msg_init)(Msg*);
  int (*msg_recv)(Msg*, void*, int);
  void* (*msg_data)(Msg*);
  size_t (*msg_size)(Msg*);
  int (*msg_close)(Msg*);

  static ZmqLib* get() {
    static ZmqLib* lib = [] {
      void* h = nullptr;
      if (!g_libzmq_path.empty()) {
        h = dlopen(g_libzmq_path.c_str(), RTLD_NOW | RTLD_GLOBAL);
      } else {
        h = dlopen("libzmq.so.5", RTLD_NOW | RTLD_GLOBAL);
        if (!h) h = dlopen("libzmq.so", RTLD_NOW | RTLD_GLOBAL);
      }
      if (!h) return static_cast<ZmqLib*>(nullptr);
      auto* z = new ZmqLib();
      auto sym = [&](const char* n) { return dlsym(h, n); };
      z->ctx_new = reinterpret_cast<void* (*)()>(sym("zmq_ctx_new"));
      z->ctx_term = reinterpret_cast<int (*)(void*)>(sym("zmq_ctx_term"));
      z->socket = reinterpret_cast<void* (*)(void*, int)>(sym("zmq_socket"));
      z->close_ = reinterpret_cast<int (*)(void*)>(sym("zmq_close"));
      z->bind = reinterpret_cast<int (*)(void*, const char*)>(sym("zmq_bind"));
      z->connect =
          reinterpret_cast<int (*)(void*, const char*)>(sym("zmq_connect"));
      z->setsockopt = reinterpret_cast<int (*)(void*, int, const void*,
                                               size_t)>(sym("zmq_setsockopt"));
      z->send = reinterpret_cast<int (*)(void*, const void*, size_t, int)>(
          sym("zmq_send"));
      z->msg_init = reinterpret_cast<int (*)(Msg*)>(sym("zmq_msg_init"));
      z->msg_recv =
          reinterpret_cast<int (*)(Msg*, void*, int)>(sym("zmq_msg_recv"));
      z->msg_data = reinterpret_cast<void* (*)(Msg*)>(sym("zmq_msg_data"));
      z->msg_size = reinterpret_cast<size_t (*)(Msg*)>(sym("zmq_msg_size"));
      z->msg_close = reinterpret_cast<int (*)(Msg*)>(sym("zmq_msg_close"));
      // every symbol is called unchecked later; a partially-resolving
      // libzmq must fall back to the clean "unavailable" path, not
      // segfault on the first missing call
      if (!z->ctx_new || !z->ctx_term || !z->socket || !z->close_ ||
          !z->bind || !z->connect || !z->setsockopt || !z->send ||
          !z->msg_init || !z->msg_recv || !z->msg_data || !z->msg_size ||
          !z->msg_close) {
        delete z;
        return static_cast<ZmqLib*>(nullptr);
      }
      return z;
    }();
    return lib;
  }

  void* make_socket(int type, int timeout_ms) {
    static void* ctx = ctx_new();
    void* s = socket(ctx, type);
    int zero = 0;
    setsockopt(s, LINGER, &zero, sizeof(zero));
    if (timeout_ms > 0) {
      setsockopt(s, RCVTIMEO, &timeout_ms, sizeof(timeout_ms));
      setsockopt(s, SNDTIMEO, &timeout_ms, sizeof(timeout_ms));
    }
    return s;
  }

  bool recv_string(void* s, std::string* out) {
    Msg m;
    msg_init(&m);
    int n = msg_recv(&m, s, 0);
    if (n < 0) {
      msg_close(&m);
      return false;
    }
    out->assign(static_cast<char*>(msg_data(&m)), msg_size(&m));
    msg_close(&m);
    return true;
  }
};

struct ZmqReq : Transport {
  ZmqLib* z;
  void* sock;
  // timeout_ms <= 0: block indefinitely, matching the framed-TCP flavor
  // (the agent side may stall for minutes on its first JIT compile or a
  // tunnel hiccup; a bounded recv here would silently end the simulation
  // mid-run while the framed run completes)
  ZmqReq(const std::string& host, int port, int timeout_ms = 0) {
    z = ZmqLib::get();
    sock = z ? z->make_socket(ZmqLib::REQ, timeout_ms) : nullptr;
    if (sock) {
      std::string ep = "tcp://" + host + ":" + std::to_string(port);
      z->connect(sock, ep.c_str());
    }
  }
  bool ok() const { return sock != nullptr; }
  bool send(const std::string& p) override {
    return z->send(sock, p.data(), p.size(), 0) >= 0;
  }
  bool recv(std::string* out) override { return z->recv_string(sock, out); }
  ~ZmqReq() override {
    if (sock) z->close_(sock);
  }
};

// ---------------------------------------------------------------------
// world model (matches the Python oracle's toy rules)
// ---------------------------------------------------------------------

struct World {
  int n, c;
  double highway_len, comm_range;
  std::vector<double> x, y, vel;
  // tables[i][j]: i's knowledge of j (vehicle.py:20-33 semantics)
  std::vector<std::vector<float>> tx, ty;
  std::vector<std::vector<int>> tseq, tage;
  std::vector<float> reward;
  std::mutex reward_mu;  // guards reward: collector thread reads concurrently
  std::mt19937 rng;

  World(int n_, int c_, double len, double range, uint32_t seed)
      : n(n_), c(c_), highway_len(len), comm_range(range),
        x(n), y(n, 0.0), vel(n),
        tx(n, std::vector<float>(n, 0.f)), ty(n, std::vector<float>(n, 0.f)),
        tseq(n, std::vector<int>(n, 0)), tage(n, std::vector<int>(n, 0)),
        reward(n, 0.f), rng(seed) {
    std::uniform_int_distribution<int> px(0, static_cast<int>(len) - 1);
    std::uniform_real_distribution<double> pv(1.1, 2.7);
    for (int i = 0; i < n; ++i) {
      x[i] = px(rng);
      vel[i] = pv(rng);
    }
  }

  double dist(int a, int b) const {
    double dx = x[b] - x[a], dy = y[b] - y[a];
    return std::sqrt(dx * dx + dy * dy);
  }

  // Free-space sensing proxy, the same model as the agent-side toy_rssi
  // (diral_tpu/agents/sps.py): per channel, the strongest received power
  // over last round's transmitters on that channel; idle channels sense
  // the noise floor (v2x_sps.py:20 comment scale).
  std::vector<double> sense_rssi(int u, const std::vector<int>& last) const {
    constexpr double kNoiseFloor = -117.0, kRxBusy = -90.0;
    std::vector<double> out(c, kNoiseFloor);
    for (int t = 0; t < n; ++t) {
      if (t == u) continue;
      double p = kRxBusy - 20.0 * std::log10(std::max(dist(u, t), 1.0));
      out[last[t]] = std::max(out[last[t]], p);
    }
    return out;
  }

  // vehicle.py:56-70 for everyone
  void periodic_update() {
    for (int i = 0; i < n; ++i) {
      for (int j = 0; j < n; ++j) tage[i][j] += 1;
      tseq[i][i] += 1;
      tx[i][i] = static_cast<float>(x[i]);
      ty[i][i] = static_cast<float>(y[i]);
      tage[i][i] = 0;
    }
  }

  // vehicle.py:35-47 seq-gated merge of src's live table into dst's
  void merge(int dst, int src) {
    for (int j = 0; j < n; ++j) {
      if (tseq[src][j] > tseq[dst][j]) {
        tx[dst][j] = tx[src][j];
        ty[dst][j] = ty[src][j];
        tseq[dst][j] = tseq[src][j];
        tage[dst][j] = 0;
      }
    }
  }

  // my_step_ch rules, reward design 2 (test_env.py:351-443)
  void step(const std::vector<int>& actions) {
    periodic_update();
    std::vector<int> count(c, 0);
    for (int u = 0; u < n; ++u) count[actions[u]] += 1;

    // Raw PRR per transmitter -- the agent side maps PRR -> reward
    // (realness_env.py:377-394), as the real RealNeS reported raw PRR.
    std::vector<float> new_reward(n, 0.f);
    for (int u = 0; u < n; ++u) {
      int ch = actions[u];
      if (count[ch] == 1) {
        new_reward[u] = 1.0f;
        continue;
      }
      int in_range = 0, received = 0;
      for (int r = 0; r < n; ++r) {
        if (actions[r] == ch) continue;  // half duplex on this channel
        if (dist(u, r) >= comm_range) continue;
        in_range += 1;
        // nearest in-range co-channel transmitter to r
        double best = 1e18;
        int best_tx = -1;
        for (int t = 0; t < n; ++t) {
          if (actions[t] != ch) continue;
          double d = dist(t, r);
          if (d < comm_range && d < best) {
            best = d;
            best_tx = t;
          }
        }
        if (best_tx == u) received += 1;
      }
      float prr = in_range > 0 ? static_cast<float>(received) / in_range : 1.0f;
      new_reward[u] = prr;
    }
    {
      std::lock_guard<std::mutex> lock(reward_mu);
      reward = new_reward;
    }

    // receivers merge from their closest in-range transmitter per channel
    for (int ch = 0; ch < c; ++ch) {
      if (count[ch] == 0) continue;
      for (int r = 0; r < n; ++r) {
        if (actions[r] == ch) continue;
        double best = 1e18;
        int best_tx = -1;
        for (int t = 0; t < n; ++t) {
          if (actions[t] != ch) continue;
          double d = dist(t, r);
          if (d < comm_range && d < best) {
            best = d;
            best_tx = t;
          }
        }
        if (best_tx >= 0) merge(r, best_tx);
      }
    }

    // mobility (network.py:189-206), all rightbound
    for (int u = 0; u < n; ++u)
      x[u] = std::fmod(x[u] + vel[u] + highway_len, highway_len);
  }
};

MA_RewardSentAll collect_rewards(World* world) {
  MA_RewardSentAll all;
  std::lock_guard<std::mutex> lock(world->reward_mu);
  for (int u = 0; u < world->n; ++u) {
    MA_RewardSent* r = all.add_all_rewards();
    r->set_user_id(u);
    r->set_sn(0);
    r->set_reward(world->reward[u]);
  }
  return all;
}

// reward collector endpoint (REP role on reward_port), zmq flavor: a
// short recv timeout lets the loop poll the stop flag
void reward_collector_zmq(int port, World* world, std::atomic<bool>* stop) {
  ZmqLib* z = ZmqLib::get();
  if (!z) {
    std::cerr << "reward collector: libzmq unavailable\n";
    return;
  }
  void* s = z->make_socket(ZmqLib::REP, /*timeout_ms=*/200);
  std::string ep = "tcp://*:" + std::to_string(port);
  if (z->bind(s, ep.c_str()) != 0) {
    std::cerr << "reward collector: zmq bind failed on " << port << "\n";
    z->close_(s);
    return;
  }
  std::string req;
  while (!stop->load()) {
    if (!z->recv_string(s, &req)) continue;  // timeout: re-check stop
    std::string payload = collect_rewards(world).SerializeAsString();
    if (z->send(s, payload.data(), payload.size(), 0) < 0) {
      // a failed REP send leaves the state machine awaiting send; every
      // later recv would return EFSM and the loop would hot-spin serving
      // nothing -- recreate and rebind instead
      z->close_(s);
      s = z->make_socket(ZmqLib::REP, /*timeout_ms=*/200);
      if (z->bind(s, ep.c_str()) != 0) break;
    }
  }
  z->close_(s);
}

// reward collector endpoint (REP role on reward_port), framed-TCP flavor
void reward_collector(int port, World* world, std::atomic<bool>* stop) {
  int lfd = socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = INADDR_ANY;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(lfd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(lfd, 1) != 0) {
    std::cerr << "reward collector: bind failed on " << port << "\n";
    close(lfd);
    return;
  }
  while (!stop->load()) {
    int fd = accept(lfd, nullptr, nullptr);
    if (fd < 0) break;
    std::string req;
    while (recv_frame(fd, &req)) {
      if (!send_frame(fd, collect_rewards(world).SerializeAsString())) break;
    }
    close(fd);
  }
  close(lfd);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 6) {
    std::cerr << "usage: realnes_sim <host> <port> <num_users> <num_channels>"
                 " <rounds> [seed] [reward_port] [mode: dist|syn|sps]"
                 " [transport: framed|zmq] [libzmq path]\n";
    return 2;
  }
  std::string host = argv[1];
  int port = std::atoi(argv[2]);
  int n = std::atoi(argv[3]);
  int c = std::atoi(argv[4]);
  int rounds = std::atoi(argv[5]);
  uint32_t seed = argc > 6 ? static_cast<uint32_t>(std::strtoul(argv[6], nullptr, 10)) : 0u;
  int reward_port = argc > 7 ? std::atoi(argv[7]) : 0;
  std::string mode = argc > 8 ? argv[8] : "dist";
  std::string transport = argc > 9 ? argv[9] : "framed";
  if (argc > 10) g_libzmq_path = argv[10];
  if (mode != "dist" && mode != "syn" && mode != "sps") {
    std::cerr << "unknown mode " << mode << "\n";
    return 2;
  }
  if (transport != "framed" && transport != "zmq") {
    std::cerr << "unknown transport " << transport << "\n";
    return 2;
  }

  World world(n, c, /*len=*/100.0, /*range=*/250.0, seed);

  std::atomic<bool> stop{false};
  std::thread collector;
  if (reward_port > 0)
    collector = std::thread(
        transport == "zmq" ? reward_collector_zmq : reward_collector,
        reward_port, &world, &stop);

  std::unique_ptr<Transport> t;
  if (transport == "zmq") {
    auto zreq = std::make_unique<ZmqReq>(host, port);
    if (!zreq->ok()) {
      std::cerr << "libzmq unavailable (dlopen of "
                << (g_libzmq_path.empty() ? "libzmq.so.5 / libzmq.so"
                                          : g_libzmq_path)
                << " failed)\n";
      // the zmq collector returns at once without the library (and polls
      // the stop flag with it): join it, so the exit is a clean 1
      stop = true;
      if (collector.joinable()) collector.join();
      return 1;
    }
    t = std::move(zreq);
  } else {
    int fd = connect_to(host, port);
    if (fd < 0) {
      std::cerr << "cannot connect to agent at " << host << ":" << port
                << "\n";
      return 1;
    }
    t = std::make_unique<FramedTcpReq>(fd);
  }

  // init handshake: the agent subtracts one disabled user
  // (realness_bridge.py:88), so advertise n + 1.
  {
    MA_SimInitMsg init;
    init.set_total_users(n + 1);
    init.set_action_space(c);
    // dist: neighbor-table entries per request; syn/sps: per-channel RSSI
    init.set_state_space(mode == "dist" ? n : c);
    init.set_state_space_type(2);  // RSSI-flavored (realness_env.py:335)
    if (!t->send(init.SerializeAsString())) return 1;
    std::string ack_raw;
    if (!t->recv(&ack_raw)) return 1;
    MA_SimInitAck ack;
    ack.ParseFromString(ack_raw);
  }

  std::vector<int> actions(n, 0);
  bool stopped = false;
  for (int sn = 0; sn < rounds && !stopped; ++sn) {
    for (int u = 0; u < n; ++u) {
      // RealNeS user ids are 1-based ("user 0 disabled"); the agent side
      // subtracts one (realness_env.py:368, realness_bridge.py:88).
      std::string payload;
      if (mode == "dist") {
        MA_SchedulingRequestSynDist req;
        req.set_user_id(u + 1);
        req.set_sn(sn);
        req.set_reward(world.reward[u]);
        for (int j = 0; j < n; ++j) {
          MA_NeighborTableEntry* e = req.add_neighbor();
          e->set_pos_x(world.tx[u][j]);
          e->set_pos_y(world.ty[u][j]);
          e->set_seq_num(world.tseq[u][j]);
          e->set_last_update(world.tage[u][j]);
        }
        payload = req.SerializeAsString();
      } else if (mode == "syn") {
        MA_SchedulingRequestSyn req;
        req.set_user_id(u + 1);
        req.set_sn(sn);
        req.set_reward(world.reward[u]);
        std::vector<double> rssi = world.sense_rssi(u, actions);
        // half duplex: the UE cannot sense the channel it transmitted on;
        // the simulator zeroes it (realness_env.py:343-344 note)
        rssi[actions[u]] = 0.0;
        for (double v : rssi) req.add_state(static_cast<int32_t>(v));
        payload = req.SerializeAsString();
      } else {  // sps
        SPS_SchedulingRequestSyn req;
        req.set_user_id(u + 1);
        req.set_sn(sn);
        req.set_reward(world.reward[u]);
        for (double v : world.sense_rssi(u, actions)) req.add_state(v);
        payload = req.SerializeAsString();
      }
      if (!t->send(payload)) { stopped = true; break; }
      std::string grant_raw;
      if (!t->recv(&grant_raw)) { stopped = true; break; }
      MA_SchedulingGrant grant;
      grant.ParseFromString(grant_raw);
      if (grant.stop_simulation()) { stopped = true; break; }
      actions[u] = grant.time_stamp();
    }
    if (!stopped) world.step(actions);
  }

  t.reset();
  stop.store(true);
  if (collector.joinable()) {
    if (transport != "zmq") {
      // poke the framed collector loop out of accept(); the zmq loop
      // polls the stop flag on its recv timeout
      int poke = connect_to("127.0.0.1", reward_port);
      if (poke >= 0) close(poke);
    }
    collector.join();
  }
  std::cerr << "realnes_sim: finished\n";
  return 0;
}
