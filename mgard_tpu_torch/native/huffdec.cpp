// Serial bit-walk decoder for reference CPU-generation Huffman streams
// (mgard::huffman_decoding's per-symbol tree walk -- an inherently
// sequential chain, so it runs as native host code here; the Python side
// in formats/cpu_stream.py builds the exact tree). A copy of
// mgard_tpu/native/huffdec.cpp.
//
// Bit order: codes are packed MSB-first into little-endian u32 words
// (reference src/mgard/compressors.cpp:345-384): stream bit b is bit
// (31 - b%32) of word b/32.

#include <cstdint>

extern "C" {

// Returns the number of bits consumed on success, or:
//   -1: bitstream underrun   -2: miss stream underrun   -3: bad tree node
int64_t mgard_huffdec_cpu(const uint8_t *hit, int64_t nbits,
                          const int32_t *left, const int32_t *right,
                          const int32_t *qv, int32_t root, int32_t nnodes,
                          const int32_t *miss, int64_t nmiss, int64_t half,
                          int64_t *out, int64_t ndof) {
  int64_t pos = 0;
  int64_t mi = 0;
  for (int64_t k = 0; k < ndof; ++k) {
    int32_t n = root;
    while (left[n] >= 0) {
      if (pos >= nbits) return -1;
      const int64_t w = pos >> 5;
      const uint32_t word = (uint32_t)hit[4 * w] |
                            ((uint32_t)hit[4 * w + 1] << 8) |
                            ((uint32_t)hit[4 * w + 2] << 16) |
                            ((uint32_t)hit[4 * w + 3] << 24);
      const int bit = (word >> (31 - (pos & 31))) & 1;
      n = bit ? right[n] : left[n];
      if (n < 0 || n >= nnodes) return -3;
      ++pos;
    }
    const int32_t q = qv[n];
    if (q != 0) {
      out[k] = (int64_t)q - half;
    } else {
      if (mi >= nmiss) return -2;
      out[k] = (int64_t)miss[mi++] - half;
    }
  }
  return pos;
}

} // extern "C"
