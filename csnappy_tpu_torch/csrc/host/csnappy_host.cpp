// Host runtime of the PyTorch port: the "native" backend's codec (its own
// copy of csrc/csnappy_host.cpp:32-226, same algorithm, so its streams are
// byte-identical to csnappy_tpu.runtime.native), the whole-stream boundary
// scan and the ragged-row compactor.  Plain C++17 with a C interface, loaded
// with ctypes by csnappy_tpu_torch/runtime/native.py; built at first use with
//   c++ -O3 -std=c++17 -fPIC -shared -o libcsnappy_host.so csnappy_host.cpp
//
// Error codes match csnappy.h:124-129.  Tag fields are computed
// arithmetically (no opcode lookup table); the encoder is a single-probe
// 2^14-entry hash table with a stride that ramps through incompressible
// spans.

#include <cstdint>
#include <cstring>

namespace {

constexpr int E_OK = 0;
constexpr int E_HEADER_BAD = -1;
constexpr int E_OUTPUT_INSUF = -2;
constexpr int E_OUTPUT_OVERRUN = -3;
constexpr int E_DATA_MALFORMED = -5;

constexpr uint32_t kBlockSize = 32768;
constexpr uint32_t kHashMul = 0x1e35a7bdu;
constexpr int kTableBits = 14;
constexpr uint32_t kTableSize = 1u << kTableBits;

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, sizeof v);
  return v;  // little-endian hosts only (x86-64 / aarch64 build targets)
}

inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, sizeof v);
  return v;
}

inline void store16(uint8_t* p, uint16_t v) { std::memcpy(p, &v, sizeof v); }

inline uint32_t hash32(uint32_t w) { return (w * kHashMul) >> (32 - kTableBits); }

// --- varint32 ---------------------------------------------------------

inline uint8_t* put_varint32(uint8_t* out, uint32_t v) {
  while (v >= 0x80) {
    *out++ = static_cast<uint8_t>(v) | 0x80;
    v >>= 7;
  }
  *out++ = static_cast<uint8_t>(v);
  return out;
}

inline int get_varint32(const uint8_t* p, uint32_t avail, uint32_t* value) {
  uint64_t acc = 0;
  for (uint32_t i = 0; i < 5; ++i) {
    if (i >= avail) return E_HEADER_BAD;
    acc |= static_cast<uint64_t>(p[i] & 0x7f) << (7 * i);
    if (!(p[i] & 0x80)) {
      if (acc >> 32) return E_HEADER_BAD;
      *value = static_cast<uint32_t>(acc);
      return static_cast<int>(i + 1);
    }
  }
  return E_HEADER_BAD;
}

// --- emitters ---------------------------------------------------------

inline uint8_t* put_literal(uint8_t* op, const uint8_t* from, uint32_t len) {
  uint32_t n = len - 1;
  if (n < 60) {
    *op++ = static_cast<uint8_t>(n << 2);
  } else if (n < 0x100) {
    *op++ = 60 << 2;
    *op++ = static_cast<uint8_t>(n);
  } else {
    *op++ = 61 << 2;
    store16(op, static_cast<uint16_t>(n));
    op += 2;
  }
  std::memcpy(op, from, len);
  return op + len;
}

inline uint8_t* put_copy(uint8_t* op, uint32_t offset, uint32_t len) {
  // chunking identical to the reference emitter (csnappy_compress.c:395-415)
  while (len >= 68) {
    *op++ = 2 | (63 << 2);
    store16(op, static_cast<uint16_t>(offset));
    op += 2;
    len -= 64;
  }
  if (len > 64) {
    *op++ = 2 | (59 << 2);
    store16(op, static_cast<uint16_t>(offset));
    op += 2;
    len -= 60;
  }
  if (len < 12 && offset < 2048) {
    *op++ = static_cast<uint8_t>(1 | ((len - 4) << 2) | ((offset >> 8) << 5));
    *op++ = static_cast<uint8_t>(offset);
  } else {
    *op++ = static_cast<uint8_t>(2 | ((len - 1) << 2));
    store16(op, static_cast<uint16_t>(offset));
    op += 2;
  }
  return op;
}

// --- fragment encoder -------------------------------------------------

uint8_t* encode_fragment(const uint8_t* in, uint32_t n, uint8_t* op,
                         uint16_t* table) {
  std::memset(table, 0, kTableSize * sizeof(uint16_t));
  // table stores position+1 so 0 means empty
  const uint8_t* base = in;
  uint32_t i = 0, anchor = 0;
  if (n >= 4) {
    const uint32_t last = n - 4;  // last position where a 4-byte probe fits
    uint32_t miss_budget = 32;    // accelerate through incompressible spans
    uint32_t step_log = 0;
    while (i <= last) {
      uint32_t w = load32(base + i);
      uint32_t h = hash32(w);
      uint32_t cand = table[h];
      table[h] = static_cast<uint16_t>(i + 1);
      if (cand != 0 && load32(base + cand - 1) == w) {
        uint32_t c = cand - 1;
        // extend match with 8-byte XOR compares
        uint32_t len = 4;
        while (i + len + 8 <= n) {
          uint64_t x = load64(base + c + len) ^ load64(base + i + len);
          if (x) {
            len += static_cast<uint32_t>(__builtin_ctzll(x)) >> 3;
            goto found;
          }
          len += 8;
        }
        while (i + len < n && base[c + len] == base[i + len]) ++len;
      found:
        if (i > anchor) op = put_literal(op, base + anchor, i - anchor);
        op = put_copy(op, i - c, len);
        // seed the table inside the covered span (sparse: every 4th byte)
        for (uint32_t j = i + 1; j + 4 <= i + len && j <= last; j += 4)
          table[hash32(load32(base + j))] = static_cast<uint16_t>(j + 1);
        i += len;
        anchor = i;
        miss_budget = 32;
        step_log = 0;
      } else {
        if (--miss_budget == 0) {  // ramp the stride on barren data
          miss_budget = 32;
          if (step_log < 3) ++step_log;
        }
        i += 1u << step_log;
      }
    }
  }
  if (anchor < n) op = put_literal(op, base + anchor, n - anchor);
  return op;
}

}  // namespace

extern "C" {

uint64_t csnappy_torch_max_compressed(uint64_t n) { return 32 + n + n / 6; }

int csnappy_torch_compress_fragment(const uint8_t* in, uint32_t n, uint8_t* out,
                                   uint32_t* out_len) {
  if (n > kBlockSize) return E_DATA_MALFORMED;
  uint16_t table[kTableSize];
  uint8_t* end = encode_fragment(in, n, out, table);
  *out_len = static_cast<uint32_t>(end - out);
  return E_OK;
}

int csnappy_torch_compress(const uint8_t* in, uint32_t n, uint8_t* out,
                          uint32_t* out_len) {
  uint16_t table[kTableSize];
  uint8_t* op = put_varint32(out, n);
  for (uint32_t start = 0; start < n; start += kBlockSize) {
    uint32_t len = n - start < kBlockSize ? n - start : kBlockSize;
    op = encode_fragment(in + start, len, op, table);
  }
  if (n == 0) { /* header only */ }
  *out_len = static_cast<uint32_t>(op - out);
  return E_OK;
}

// Safe decode of a headerless tag stream.  *dst_len carries capacity in,
// produced size out.  Never writes past the capacity, whatever the input.
int csnappy_torch_decompress_noheader(const uint8_t* src, uint32_t src_len,
                                     uint8_t* dst, uint32_t* dst_len) {
  const uint8_t* ip = src;
  const uint8_t* ip_end = src + src_len;
  uint8_t* const base = dst;
  uint8_t* op = dst;
  uint8_t* const op_cap = dst + *dst_len;

  while (ip < ip_end) {
    const uint32_t tag = *ip++;
    if ((tag & 3) == 0) {  // literal
      uint32_t len;
      uint32_t u = tag >> 2;
      if (u < 60) {
        len = u + 1;
      } else {
        const uint32_t nb = u - 59;  // 1..4 trailer bytes
        if (ip + nb > ip_end) return E_DATA_MALFORMED;
        uint32_t v = 0;
        for (uint32_t k = 0; k < nb; ++k) v |= static_cast<uint32_t>(ip[k]) << (8 * k);
        if (v == 0xffffffffu) return E_DATA_MALFORMED;
        len = v + 1;
        ip += nb;
      }
      if (static_cast<uint64_t>(ip_end - ip) < len) return E_DATA_MALFORMED;
      if (static_cast<uint64_t>(op_cap - op) < len) return E_OUTPUT_OVERRUN;
      std::memcpy(op, ip, len);
      ip += len;
      op += len;
    } else {  // copy
      uint32_t len, offset;
      switch (tag & 3) {
        case 1:
          if (ip >= ip_end) return E_DATA_MALFORMED;
          len = ((tag >> 2) & 7) + 4;
          offset = ((tag >> 5) << 8) | *ip++;
          break;
        case 2:
          if (ip + 2 > ip_end) return E_DATA_MALFORMED;
          len = (tag >> 2) + 1;
          offset = ip[0] | (static_cast<uint32_t>(ip[1]) << 8);
          ip += 2;
          break;
        default:
          if (ip + 4 > ip_end) return E_DATA_MALFORMED;
          len = (tag >> 2) + 1;
          offset = load32(ip);
          ip += 4;
          break;
      }
      if (offset == 0 || offset > static_cast<uint64_t>(op - base))
        return E_DATA_MALFORMED;
      if (static_cast<uint64_t>(op_cap - op) < len) return E_OUTPUT_OVERRUN;
      const uint8_t* from = op - offset;
      if (offset >= 8 && static_cast<uint64_t>(op_cap - op) >= len + 8) {
        // non-overlapping within word width: bulk copy
        uint8_t* o = op;
        const uint8_t* f = from;
        uint8_t* stop = op + len;
        while (o < stop) {
          std::memcpy(o, f, 8);
          o += 8;
          f += 8;
        }
      } else {
        for (uint32_t k = 0; k < len; ++k) op[k] = from[k];  // overlap-safe
      }
      op += len;
    }
  }
  *dst_len = static_cast<uint32_t>(op - base);
  return E_OK;
}

int csnappy_torch_decompress(const uint8_t* src, uint32_t src_len, uint8_t* dst,
                            uint32_t dst_cap, uint32_t* produced) {
  uint32_t ulen;
  int hdr = get_varint32(src, src_len, &ulen);
  if (hdr < 0) return E_HEADER_BAD;
  if (ulen > dst_cap) return E_OUTPUT_INSUF;
  uint32_t cap = ulen;
  int rc = csnappy_torch_decompress_noheader(src + hdr, src_len - hdr, dst, &cap);
  if (rc != E_OK) return rc;
  if (cap != ulen) return E_DATA_MALFORMED;
  *produced = cap;
  return E_OK;
}

// One-pass tag-boundary scan of a headerless stream (csnappy_decompress.c
// :319-387 control flow without any output writes).  Decides whether the
// stream splits into independent `seg`-output-byte blocks, which holds for
// every stream the reference's 32 KiB fragment loop emits
// (csnappy_compress.c:636-654): no tag's output may straddle a seg boundary
// and no copy may reach back across its segment's start.
//
// Returns: 0 = segmentable, 1 = legal but not segmentable (offsets within
//          32768), 2 = legal but some copy offset exceeds 32768, otherwise
//          the exact E_* error, decided in sequential order with the offset
//          check before the space check per tag (csnappy_decompress.c
//          :295-317).
// seg_offs[i] receives the compressed offset where output byte i*seg's tag
// begins; *nseg_out the number of segments; *produced the total output.
int csnappy_torch_scan_segments(const uint8_t* src, uint32_t src_len,
                                uint32_t dst_cap, uint32_t seg,
                                uint32_t* seg_offs, uint32_t max_segs,
                                uint32_t* nseg_out, uint32_t* produced) {
  const uint8_t* ip = src;
  const uint8_t* ip_end = src + src_len;
  uint64_t op = 0;                 // output position
  uint64_t seg_start = 0;          // current segment's first output byte
  uint32_t nseg = 0;
  bool segmentable = true;
  bool far_offset = false;         // any copy offset > 32768

  while (ip < ip_end) {
    if (op % seg == 0) {
      seg_start = op;
      uint32_t si = static_cast<uint32_t>(op / seg);
      if (si < max_segs) {
        if (si >= nseg) { seg_offs[si] = static_cast<uint32_t>(ip - src); nseg = si + 1; }
      } else {
        segmentable = false;       // more segments than the caller sized for
      }
    }
    const uint32_t tag = *ip++;
    uint64_t len;
    if ((tag & 3) == 0) {  // literal
      uint32_t u = tag >> 2;
      if (u < 60) {
        len = u + 1;
      } else {
        const uint32_t nb = u - 59;
        if (ip + nb > ip_end) return E_DATA_MALFORMED;
        uint32_t v = 0;
        for (uint32_t k = 0; k < nb; ++k) v |= static_cast<uint32_t>(ip[k]) << (8 * k);
        if (v == 0xffffffffu) return E_DATA_MALFORMED;
        len = static_cast<uint64_t>(v) + 1;
        ip += nb;
      }
      if (static_cast<uint64_t>(ip_end - ip) < len) return E_DATA_MALFORMED;
      ip += len;
    } else {  // copy
      uint64_t offset;
      switch (tag & 3) {
        case 1:
          if (ip >= ip_end) return E_DATA_MALFORMED;
          len = ((tag >> 2) & 7) + 4;
          offset = ((tag >> 5) << 8) | *ip++;
          break;
        case 2:
          if (ip + 2 > ip_end) return E_DATA_MALFORMED;
          len = (tag >> 2) + 1;
          offset = ip[0] | (static_cast<uint32_t>(ip[1]) << 8);
          ip += 2;
          break;
        default:
          if (ip + 4 > ip_end) return E_DATA_MALFORMED;
          len = (tag >> 2) + 1;
          offset = load32(ip);
          ip += 4;
          break;
      }
      if (offset == 0 || offset > op) return E_DATA_MALFORMED;
      if (offset > op - seg_start) segmentable = false;  // reaches prior segment
      if (offset > 32768) far_offset = true;
    }
    if (op + len > dst_cap) return E_OUTPUT_OVERRUN;
    op += len;
    // a tag whose output spans a segment boundary breaks independence
    if (op > seg_start + seg) segmentable = false;
  }
  *nseg_out = nseg;
  *produced = static_cast<uint32_t>(op);
  return segmentable ? 0 : (far_offset ? 2 : 1);
}

// out = concat(padded[i][0:lens[i]]).  Returns total bytes written.
uint64_t csnappy_torch_compact(const uint8_t* padded, uint32_t nblocks,
                               uint32_t stride, const uint32_t* lens,
                               uint8_t* out) {
  uint64_t off = 0;
  for (uint32_t i = 0; i < nblocks; ++i) {
    std::memcpy(out + off, padded + static_cast<uint64_t>(i) * stride, lens[i]);
    off += lens[i];
  }
  return off;
}

}  // extern "C"
