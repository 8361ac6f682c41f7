// Minimal msgpack codec for the ray_tpu_torch C++ public API.
//
// Reference analog: the reference's C++ worker serializes task args and
// returns with msgpack (bazel/ray_deps_setup.bzl:304). This is a small
// self-contained implementation covering the cross-language value
// domain: nil, bool, int64, float64, str, bin, array, map<string,Value>
// (mirrors ray_tpu_torch/runtime/xlang.py).
#pragma once

#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

namespace raytpu {

class Value;
using Array = std::vector<Value>;
using Map = std::map<std::string, Value>;

class Value {
 public:
  enum class Type { Nil, Bool, Int, Float, Str, Bin, Arr, Obj };

  Value() : type_(Type::Nil) {}
  Value(std::nullptr_t) : type_(Type::Nil) {}
  Value(bool b) : type_(Type::Bool), b_(b) {}
  Value(int i) : type_(Type::Int), i_(i) {}
  Value(int64_t i) : type_(Type::Int), i_(i) {}
  Value(uint64_t i) : type_(Type::Int), i_(static_cast<int64_t>(i)) {}
  Value(double d) : type_(Type::Float), d_(d) {}
  Value(const char* s) : type_(Type::Str), s_(s) {}
  Value(std::string s) : type_(Type::Str), s_(std::move(s)) {}
  Value(std::vector<uint8_t> b) : type_(Type::Bin), bin_(std::move(b)) {}
  Value(Array a) : type_(Type::Arr), arr_(std::move(a)) {}
  Value(Map m) : type_(Type::Obj), map_(std::move(m)) {}

  Type type() const { return type_; }
  bool is_nil() const { return type_ == Type::Nil; }
  bool as_bool() const { check(Type::Bool); return b_; }
  int64_t as_int() const {
    if (type_ == Type::Float) return static_cast<int64_t>(d_);
    check(Type::Int);
    return i_;
  }
  double as_double() const {
    if (type_ == Type::Int) return static_cast<double>(i_);
    check(Type::Float);
    return d_;
  }
  const std::string& as_str() const { check(Type::Str); return s_; }
  const std::vector<uint8_t>& as_bin() const { check(Type::Bin); return bin_; }
  const Array& as_array() const { check(Type::Arr); return arr_; }
  const Map& as_map() const { check(Type::Obj); return map_; }

  const Value& operator[](const std::string& key) const {
    check(Type::Obj);
    static const Value kNil;
    auto it = map_.find(key);
    return it == map_.end() ? kNil : it->second;
  }

  // ---- encoding -----------------------------------------------------
  void pack(std::string& out) const {
    switch (type_) {
      case Type::Nil: out.push_back('\xc0'); break;
      case Type::Bool: out.push_back(b_ ? '\xc3' : '\xc2'); break;
      case Type::Int: pack_int(out, i_); break;
      case Type::Float: {
        out.push_back('\xcb');
        uint64_t bits;
        std::memcpy(&bits, &d_, 8);
        pack_be(out, bits, 8);
        break;
      }
      case Type::Str: {
        size_t n = s_.size();
        if (n <= 31) {
          out.push_back(static_cast<char>(0xa0 | n));
        } else if (n <= 0xff) {
          out.push_back('\xd9');
          out.push_back(static_cast<char>(n));
        } else if (n <= 0xffff) {
          out.push_back('\xda');
          pack_be(out, n, 2);
        } else {
          out.push_back('\xdb');
          pack_be(out, n, 4);
        }
        out.append(s_);
        break;
      }
      case Type::Bin: {
        size_t n = bin_.size();
        if (n <= 0xff) {
          out.push_back('\xc4');
          out.push_back(static_cast<char>(n));
        } else if (n <= 0xffff) {
          out.push_back('\xc5');
          pack_be(out, n, 2);
        } else {
          out.push_back('\xc6');
          pack_be(out, n, 4);
        }
        out.append(reinterpret_cast<const char*>(bin_.data()), n);
        break;
      }
      case Type::Arr: {
        size_t n = arr_.size();
        if (n <= 15) {
          out.push_back(static_cast<char>(0x90 | n));
        } else if (n <= 0xffff) {
          out.push_back('\xdc');
          pack_be(out, n, 2);
        } else {
          out.push_back('\xdd');
          pack_be(out, n, 4);
        }
        for (const auto& v : arr_) v.pack(out);
        break;
      }
      case Type::Obj: {
        size_t n = map_.size();
        if (n <= 15) {
          out.push_back(static_cast<char>(0x80 | n));
        } else if (n <= 0xffff) {
          out.push_back('\xde');
          pack_be(out, n, 2);
        } else {
          out.push_back('\xdf');
          pack_be(out, n, 4);
        }
        for (const auto& kv : map_) {
          Value(kv.first).pack(out);
          kv.second.pack(out);
        }
        break;
      }
    }
  }

  // ---- decoding -----------------------------------------------------
  static Value unpack(const uint8_t* data, size_t len, size_t& off) {
    if (off >= len) throw std::runtime_error("msgpack: truncated");
    uint8_t b = data[off++];
    if (b <= 0x7f) return Value(static_cast<int64_t>(b));
    if (b >= 0xe0) return Value(static_cast<int64_t>(static_cast<int8_t>(b)));
    if (b >= 0x80 && b <= 0x8f) return unpack_map(data, len, off, b & 0x0f);
    if (b >= 0x90 && b <= 0x9f) return unpack_arr(data, len, off, b & 0x0f);
    if (b >= 0xa0 && b <= 0xbf) return unpack_str(data, len, off, b & 0x1f);
    switch (b) {
      case 0xc0: return Value();
      case 0xc2: return Value(false);
      case 0xc3: return Value(true);
      case 0xc4: return unpack_bin(data, len, off, read_be(data, len, off, 1));
      case 0xc5: return unpack_bin(data, len, off, read_be(data, len, off, 2));
      case 0xc6: return unpack_bin(data, len, off, read_be(data, len, off, 4));
      case 0xca: {
        uint32_t bits = static_cast<uint32_t>(read_be(data, len, off, 4));
        float f;
        std::memcpy(&f, &bits, 4);
        return Value(static_cast<double>(f));
      }
      case 0xcb: {
        uint64_t bits = read_be(data, len, off, 8);
        double d;
        std::memcpy(&d, &bits, 8);
        return Value(d);
      }
      case 0xcc: return Value(static_cast<int64_t>(read_be(data, len, off, 1)));
      case 0xcd: return Value(static_cast<int64_t>(read_be(data, len, off, 2)));
      case 0xce: return Value(static_cast<int64_t>(read_be(data, len, off, 4)));
      case 0xcf: return Value(static_cast<int64_t>(read_be(data, len, off, 8)));
      case 0xd0: return Value(static_cast<int64_t>(
          static_cast<int8_t>(read_be(data, len, off, 1))));
      case 0xd1: return Value(static_cast<int64_t>(
          static_cast<int16_t>(read_be(data, len, off, 2))));
      case 0xd2: return Value(static_cast<int64_t>(
          static_cast<int32_t>(read_be(data, len, off, 4))));
      case 0xd3: return Value(static_cast<int64_t>(read_be(data, len, off, 8)));
      case 0xd9: return unpack_str(data, len, off, read_be(data, len, off, 1));
      case 0xda: return unpack_str(data, len, off, read_be(data, len, off, 2));
      case 0xdb: return unpack_str(data, len, off, read_be(data, len, off, 4));
      case 0xdc: return unpack_arr(data, len, off, read_be(data, len, off, 2));
      case 0xdd: return unpack_arr(data, len, off, read_be(data, len, off, 4));
      case 0xde: return unpack_map(data, len, off, read_be(data, len, off, 2));
      case 0xdf: return unpack_map(data, len, off, read_be(data, len, off, 4));
      default:
        throw std::runtime_error("msgpack: unsupported type byte");
    }
  }

 private:
  void check(Type t) const {
    if (type_ != t) throw std::runtime_error("msgpack: wrong Value type");
  }
  static void pack_be(std::string& out, uint64_t v, int nbytes) {
    for (int i = nbytes - 1; i >= 0; --i)
      out.push_back(static_cast<char>((v >> (8 * i)) & 0xff));
  }
  static void pack_int(std::string& out, int64_t v) {
    if (v >= 0 && v <= 0x7f) {
      out.push_back(static_cast<char>(v));
    } else if (v < 0 && v >= -32) {
      out.push_back(static_cast<char>(v));
    } else if (v >= 0) {
      out.push_back('\xcf');
      pack_be(out, static_cast<uint64_t>(v), 8);
    } else {
      out.push_back('\xd3');
      pack_be(out, static_cast<uint64_t>(v), 8);
    }
  }
  static uint64_t read_be(const uint8_t* data, size_t len, size_t& off,
                          int nbytes) {
    if (off + nbytes > len) throw std::runtime_error("msgpack: truncated");
    uint64_t v = 0;
    for (int i = 0; i < nbytes; ++i) v = (v << 8) | data[off++];
    return v;
  }
  static Value unpack_str(const uint8_t* data, size_t len, size_t& off,
                          uint64_t n) {
    if (off + n > len) throw std::runtime_error("msgpack: truncated str");
    Value v(std::string(reinterpret_cast<const char*>(data + off),
                        static_cast<size_t>(n)));
    off += n;
    return v;
  }
  static Value unpack_bin(const uint8_t* data, size_t len, size_t& off,
                          uint64_t n) {
    if (off + n > len) throw std::runtime_error("msgpack: truncated bin");
    Value v(std::vector<uint8_t>(data + off, data + off + n));
    off += n;
    return v;
  }
  static Value unpack_arr(const uint8_t* data, size_t len, size_t& off,
                          uint64_t n) {
    Array a;
    a.reserve(static_cast<size_t>(n));
    for (uint64_t i = 0; i < n; ++i) a.push_back(unpack(data, len, off));
    return Value(std::move(a));
  }
  static Value unpack_map(const uint8_t* data, size_t len, size_t& off,
                          uint64_t n) {
    Map m;
    for (uint64_t i = 0; i < n; ++i) {
      Value k = unpack(data, len, off);
      Value v = unpack(data, len, off);
      m.emplace(k.as_str(), std::move(v));
    }
    return Value(std::move(m));
  }

  Type type_;
  bool b_ = false;
  int64_t i_ = 0;
  double d_ = 0.0;
  std::string s_;
  std::vector<uint8_t> bin_;
  Array arr_;
  Map map_;
};

}  // namespace raytpu
