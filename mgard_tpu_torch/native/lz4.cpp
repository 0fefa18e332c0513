// LZ4 block-format codec (host stage of the composed lossless pipeline).
//
// The reference carries a portable *device* LZ4 (reference:
// include/mgard-x/Lossless/LZ4/LZ4Kernels.hpp, LZ4Fused.hpp). LZ4's
// byte-serial greedy match search is a data-dependent chain, so the port
// runs it where byte chasing is cheap: the host, in native code, over the
// bytes of a stream section -- the same placement as the reference's Zstd
// stage (Zstd.hpp:30-120). A copy of mgard_tpu/native/lz4.cpp, so both
// packages write the same LZ4 blocks.
//
// This is an independent implementation of the public LZ4 block format
// (token / literals / 16-bit offset / match-length extension), greedy
// single-probe hash matcher. Not copied from the reference or from
// lz4/lz4.c.
//
// Build: g++ -O3 -shared -fPIC lz4.cpp -o libmgardlz4.so

#include <cstdint>
#include <cstring>

namespace {

inline uint32_t read32(const uint8_t *p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint32_t hash4(uint32_t v) { return (v * 2654435761u) >> 16; }

constexpr int64_t KLastLiterals = 5;   // spec: last 5 bytes are literals
constexpr int64_t KMatchGuard = 12;    // spec: no match starts in last 12

} // namespace

extern "C" {

// Worst-case compressed size for n input bytes.
int64_t mgard_lz4_bound(int64_t n) { return n + n / 255 + 16; }

// Compress src[0..n) into dst (capacity >= mgard_lz4_bound(n)).
// Returns compressed size, or -1 on insufficient capacity.
int64_t mgard_lz4_compress(const uint8_t *src, int64_t n, uint8_t *dst,
                           int64_t cap) {
  if (cap < mgard_lz4_bound(n)) return -1;
  static thread_local int64_t table[1 << 16];
  std::memset(table, 0xFF, sizeof(table)); // -1 everywhere

  int64_t ip = 0, anchor = 0, op = 0;
  const int64_t match_limit = n - KLastLiterals;

  while (ip + KMatchGuard <= n) {
    const uint32_t seq = read32(src + ip);
    const uint32_t h = hash4(seq);
    const int64_t ref = table[h];
    table[h] = ip;
    if (ref >= 0 && ip - ref <= 65535 && read32(src + ref) == seq) {
      int64_t mlen = 4;
      while (ip + mlen < match_limit && src[ref + mlen] == src[ip + mlen])
        ++mlen;
      const int64_t lit = ip - anchor;
      uint8_t *tok = dst + op++;
      if (lit >= 15) {
        *tok = 15u << 4;
        int64_t r = lit - 15;
        while (r >= 255) { dst[op++] = 255; r -= 255; }
        dst[op++] = static_cast<uint8_t>(r);
      } else {
        *tok = static_cast<uint8_t>(lit << 4);
      }
      std::memcpy(dst + op, src + anchor, lit);
      op += lit;
      const uint16_t off = static_cast<uint16_t>(ip - ref);
      dst[op++] = off & 0xFF;
      dst[op++] = off >> 8;
      int64_t ml = mlen - 4;
      if (ml >= 15) {
        *tok |= 15;
        ml -= 15;
        while (ml >= 255) { dst[op++] = 255; ml -= 255; }
        dst[op++] = static_cast<uint8_t>(ml);
      } else {
        *tok |= static_cast<uint8_t>(ml);
      }
      ip += mlen;
      anchor = ip;
      // seed the table inside the match so long runs stay findable
      if (ip + 4 <= n) table[hash4(read32(src + ip - 2))] = ip - 2;
    } else {
      ++ip;
    }
  }
  // trailing literals
  const int64_t lit = n - anchor;
  uint8_t *tok = dst + op++;
  if (lit >= 15) {
    *tok = 15u << 4;
    int64_t r = lit - 15;
    while (r >= 255) { dst[op++] = 255; r -= 255; }
    dst[op++] = static_cast<uint8_t>(r);
  } else {
    *tok = static_cast<uint8_t>(lit << 4);
  }
  std::memcpy(dst + op, src + anchor, lit);
  op += lit;
  return op;
}

// Decompress src[0..n) into dst[0..out_n). Returns bytes written, or -1 on
// malformed input / capacity overrun.
int64_t mgard_lz4_decompress(const uint8_t *src, int64_t n, uint8_t *dst,
                             int64_t out_n) {
  int64_t ip = 0, op = 0;
  while (ip < n) {
    const uint8_t token = src[ip++];
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (ip >= n) return -1;
        b = src[ip++];
        lit += b;
      } while (b == 255);
    }
    if (ip + lit > n || op + lit > out_n) return -1;
    std::memcpy(dst + op, src + ip, lit);
    ip += lit;
    op += lit;
    if (ip >= n) break; // final literals-only sequence
    if (ip + 2 > n) return -1;
    const int64_t off = src[ip] | (static_cast<int64_t>(src[ip + 1]) << 8);
    ip += 2;
    if (off == 0 || off > op) return -1;
    int64_t mlen = (token & 0xF) + 4;
    if ((token & 0xF) == 15) {
      uint8_t b;
      do {
        if (ip >= n) return -1;
        b = src[ip++];
        mlen += b;
      } while (b == 255);
    }
    if (op + mlen > out_n) return -1;
    const uint8_t *m = dst + op - off;
    for (int64_t i = 0; i < mlen; ++i) dst[op + i] = m[i]; // overlap-safe
    op += mlen;
  }
  return op;
}

} // extern "C"
