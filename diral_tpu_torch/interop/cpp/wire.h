// Proto2 wire codec for the agent protocol messages the toy-RealNeS
// simulator sends and receives (schema: diral_tpu/interop/ma_messages.proto),
// in place of protoc's generated classes, so that the simulator builds with
// g++ alone: no protoc, no protobuf headers, no -lprotobuf.
//
// The classes keep the generated ones' method names (set_*, add_*, the
// getters, SerializeAsString, ParseFromString), so realnes_sim.cc reads as
// it does against ma_messages.pb.h.  The bytes are protobuf's own: fields
// in field-number order, every set field written, repeated scalars
// unpacked, int32 as a varint sign-extended to 64 bits, float / double
// little-endian, nested messages length-delimited.  The two parsers (the
// init ack and the grant) skip unknown fields and, like protobuf's, fail on
// malformed bytes or a missing required field.
// diral_tpu_torch/interop/wire.py is the Python side of the same codec,
// for all 11 messages.

#pragma once

#include <cstdint>
#include <cstring>
#include <string>
#include <type_traits>
#include <vector>

namespace wire {

enum WireType { kVarint = 0, kFixed64 = 1, kLength = 2, kFixed32 = 5 };

inline void put_varint(std::string* out, uint64_t v) {
  while (v > 0x7F) {
    out->push_back(static_cast<char>((v & 0x7F) | 0x80));
    v >>= 7;
  }
  out->push_back(static_cast<char>(v));
}

inline void put_tag(std::string* out, int field, WireType type) {
  put_varint(out, (static_cast<uint64_t>(field) << 3) | type);
}

inline void put_int32(std::string* out, int field, int32_t v) {
  put_tag(out, field, kVarint);
  put_varint(out, static_cast<uint64_t>(static_cast<int64_t>(v)));
}

template <typename T>
inline void put_le(std::string* out, T v) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "fixed-width field");
  using U = typename std::conditional<sizeof(T) == 4, uint32_t, uint64_t>::type;
  U bits;
  std::memcpy(&bits, &v, sizeof(T));
  for (size_t i = 0; i < sizeof(T); ++i)
    out->push_back(static_cast<char>((bits >> (8 * i)) & 0xFF));
}

inline void put_float(std::string* out, int field, float v) {
  put_tag(out, field, kFixed32);
  put_le(out, v);
}

inline void put_double(std::string* out, int field, double v) {
  put_tag(out, field, kFixed64);
  put_le(out, v);
}

inline void put_message(std::string* out, int field, const std::string& body) {
  put_tag(out, field, kLength);
  put_varint(out, body.size());
  out->append(body);
}

// A cursor over one message's bytes.  next() reads a field's key; the
// typed readers then read its value; skip() passes an unknown field.
struct Reader {
  const unsigned char* p;
  const unsigned char* end;
  bool ok = true;

  explicit Reader(const std::string& s)
      : p(reinterpret_cast<const unsigned char*>(s.data())),
        end(reinterpret_cast<const unsigned char*>(s.data()) + s.size()) {}

  bool varint(uint64_t* v) {
    *v = 0;
    for (int shift = 0; shift < 70; shift += 7) {
      if (p >= end) return ok = false;
      unsigned char b = *p++;
      *v |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (b < 0x80) return true;
    }
    return ok = false;
  }

  bool next(int* field, int* type) {
    if (p >= end) return false;
    uint64_t key;
    if (!varint(&key)) return false;
    *field = static_cast<int>(key >> 3);
    *type = static_cast<int>(key & 7);
    return true;
  }

  bool int32(int32_t* v) {
    uint64_t raw;
    if (!varint(&raw)) return false;
    *v = static_cast<int32_t>(static_cast<uint32_t>(raw));
    return true;
  }

  bool skip(int type) {
    uint64_t n;
    switch (type) {
      case kVarint: return varint(&n);
      case kFixed64: n = 8; break;
      case kFixed32: n = 4; break;
      case kLength:
        if (!varint(&n)) return false;
        break;
      default: return ok = false;
    }
    if (static_cast<uint64_t>(end - p) < n) return ok = false;
    p += n;
    return true;
  }
};

// -- messages the simulator sends ------------------------------------------

class MA_SimInitMsg {
 public:
  void set_total_users(int32_t v) { total_users_ = v; }
  void set_action_space(int32_t v) { action_space_ = v; }
  void set_state_space(int32_t v) { state_space_ = v; }
  void set_state_space_type(int32_t v) { state_space_type_ = v; }
  std::string SerializeAsString() const {
    std::string out;
    put_int32(&out, 1, total_users_);
    put_int32(&out, 2, action_space_);
    put_int32(&out, 3, state_space_);
    put_int32(&out, 4, state_space_type_);
    return out;
  }

 private:
  int32_t total_users_ = 0, action_space_ = 0, state_space_ = 0,
          state_space_type_ = 0;
};

class MA_NeighborTableEntry {
 public:
  void set_pos_x(float v) { pos_x_ = v; }
  void set_pos_y(float v) { pos_y_ = v; }
  void set_seq_num(int32_t v) { seq_num_ = v; }
  void set_last_update(int32_t v) { last_update_ = v; }
  std::string SerializeAsString() const {
    std::string out;
    put_float(&out, 1, pos_x_);
    put_float(&out, 2, pos_y_);
    put_int32(&out, 3, seq_num_);
    put_int32(&out, 4, last_update_);
    return out;
  }

 private:
  float pos_x_ = 0.f, pos_y_ = 0.f;
  int32_t seq_num_ = 0, last_update_ = 0;
};

class MA_SchedulingRequestSynDist {
 public:
  void set_user_id(int32_t v) { user_id_ = v; }
  void set_sn(int32_t v) { sn_ = v; }
  void set_reward(float v) { reward_ = v; }
  MA_NeighborTableEntry* add_neighbor() {
    neighbor_.emplace_back();
    return &neighbor_.back();
  }
  std::string SerializeAsString() const {
    std::string out;
    put_int32(&out, 1, user_id_);
    for (const auto& e : neighbor_) put_message(&out, 2, e.SerializeAsString());
    put_int32(&out, 3, sn_);
    put_float(&out, 4, reward_);
    return out;
  }

 private:
  int32_t user_id_ = 0, sn_ = 0;
  float reward_ = 0.f;
  std::vector<MA_NeighborTableEntry> neighbor_;
};

class MA_SchedulingRequestSyn {
 public:
  void set_user_id(int32_t v) { user_id_ = v; }
  void set_sn(int32_t v) { sn_ = v; }
  void set_reward(float v) { reward_ = v; }
  void add_state(int32_t v) { state_.push_back(v); }
  std::string SerializeAsString() const {
    std::string out;
    put_int32(&out, 1, user_id_);
    for (int32_t v : state_) put_int32(&out, 2, v);
    put_int32(&out, 3, sn_);
    put_float(&out, 4, reward_);
    return out;
  }

 private:
  int32_t user_id_ = 0, sn_ = 0;
  float reward_ = 0.f;
  std::vector<int32_t> state_;
};

class SPS_SchedulingRequestSyn {
 public:
  void set_user_id(int32_t v) { user_id_ = v; }
  void set_sn(int32_t v) { sn_ = v; }
  void set_reward(float v) { reward_ = v; }
  void add_state(double v) { state_.push_back(v); }
  std::string SerializeAsString() const {
    std::string out;
    put_int32(&out, 1, user_id_);
    for (double v : state_) put_double(&out, 2, v);
    put_int32(&out, 3, sn_);
    put_float(&out, 4, reward_);
    return out;
  }

 private:
  int32_t user_id_ = 0, sn_ = 0;
  float reward_ = 0.f;
  std::vector<double> state_;
};

class MA_RewardSent {
 public:
  void set_user_id(int32_t v) { user_id_ = v; }
  void set_sn(int32_t v) { sn_ = v; }
  void set_reward(float v) { reward_ = v; }
  std::string SerializeAsString() const {
    std::string out;
    put_int32(&out, 1, user_id_);
    put_int32(&out, 2, sn_);
    put_float(&out, 3, reward_);
    return out;
  }

 private:
  int32_t user_id_ = 0, sn_ = 0;
  float reward_ = 0.f;
};

class MA_RewardSentAll {
 public:
  MA_RewardSent* add_all_rewards() {
    all_rewards_.emplace_back();
    return &all_rewards_.back();
  }
  std::string SerializeAsString() const {
    std::string out;
    for (const auto& r : all_rewards_)
      put_message(&out, 1, r.SerializeAsString());
    return out;
  }

 private:
  std::vector<MA_RewardSent> all_rewards_;
};

// -- messages the simulator receives ---------------------------------------

class MA_SimInitAck {
 public:
  bool done() const { return done_; }
  bool stopsimreq() const { return stop_sim_req_; }
  // both fields are optional: any well-formed bytes parse
  bool ParseFromString(const std::string& s) {
    Reader r(s);
    int field, type;
    while (r.next(&field, &type)) {
      uint64_t v;
      if ((field == 1 || field == 2) && type == kVarint) {
        if (!r.varint(&v)) return false;
        (field == 1 ? done_ : stop_sim_req_) = v != 0;
      } else if (!r.skip(type)) {
        return false;
      }
    }
    return r.ok;
  }

 private:
  bool done_ = false, stop_sim_req_ = false;
};

class MA_SchedulingGrant {
 public:
  int32_t time_stamp() const { return time_stamp_; }
  bool stop_simulation() const { return stop_simulation_; }
  // false on malformed bytes or a missing time_stamp (a required field)
  bool ParseFromString(const std::string& s) {
    Reader r(s);
    bool has_time_stamp = false;
    int field, type;
    while (r.next(&field, &type)) {
      if (field == 1 && type == kVarint) {
        if (!r.int32(&time_stamp_)) return false;
        has_time_stamp = true;
      } else if (field == 2 && type == kVarint) {
        uint64_t v;
        if (!r.varint(&v)) return false;
        stop_simulation_ = v != 0;
      } else if (!r.skip(type)) {
        return false;
      }
    }
    return r.ok && has_time_stamp;
  }

 private:
  int32_t time_stamp_ = 0;
  bool stop_simulation_ = false;
};

}  // namespace wire
