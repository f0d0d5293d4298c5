// Host runtime of the PyTorch port: the whole-stream boundary scan and the
// ragged-row compactor.  Plain C++17 with a C interface, loaded with ctypes
// by csnappy_tpu_torch/runtime/native.py; built at first use with
//   c++ -O3 -std=c++17 -fPIC -shared -o libcsnappy_torch_host.so csnappy_host.cpp
//
// Error codes match csnappy.h:124-129.

#include <cstdint>
#include <cstring>

namespace {

constexpr int E_OUTPUT_OVERRUN = -3;
constexpr int E_DATA_MALFORMED = -5;

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, sizeof v);
  return v;  // little-endian hosts only (x86-64 / aarch64)
}

}  // namespace

extern "C" {

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
