// The JPEG entropy decoders' shared pieces (csrc/jpeg_entropy.cu,
// csrc/jpeg_progressive.cu): the table layout of
// rodynrf_tpu_torch/data/jpeg.py, a 64-bit bit buffer over one segment's
// unstuffed bytes, the Huffman decode through a 9-bit lookahead table with
// the canonical maxcode walk for longer codes (jdhuff.c), and HUFF_EXTEND.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define LOOKAHEAD 9
#define HUFF_WORDS ((1 << LOOKAHEAD) + 18 + 18 + 256)
#define SCAN_WORDS 17
#define PLANE_WORDS 8

enum { OK = 0, BAD_CODE = 1, BAD_AC = 2, SHORT_SEGMENT = 3, BAD_BAND = 4 };

__constant__ int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Bits {
  const uint8_t* p;
  long long nbytes;
  long long next;  // next byte to load
  long long used;  // bits consumed
  uint64_t acc;    // unconsumed bits, most significant first
  int have;        // bits in acc
};

// top the buffer up to at least 57 bits; bytes past the segment read as 0
__device__ __forceinline__ void fill(Bits& b) {
  while (b.have <= 56) {
    uint64_t byte = b.next < b.nbytes ? b.p[b.next] : 0;
    b.next++;
    b.acc |= byte << (56 - b.have);
    b.have += 8;
  }
}

__device__ __forceinline__ uint32_t peek(const Bits& b, int n) {
  return (uint32_t)(b.acc >> (64 - n));
}

__device__ __forceinline__ void skip(Bits& b, int n) {
  b.acc <<= n;
  b.have -= n;
  b.used += n;
}

// one symbol of the table, or -1 for a code that is in no table; the buffer
// holds at least 57 bits on entry
__device__ __forceinline__ int decode(Bits& b, const int* tab) {
  int e = tab[peek(b, LOOKAHEAD)];
  if (e) {
    skip(b, e >> 8);
    return e & 255;
  }
  const int* maxcode = tab + (1 << LOOKAHEAD);
  const int* valoff = maxcode + 18;
  const int* vals = valoff + 18;
  uint32_t code16 = peek(b, 16);
  for (int l = LOOKAHEAD + 1; l <= 16; ++l) {
    int code = (int)(code16 >> (16 - l));
    if (code <= maxcode[l]) {
      skip(b, l);
      return vals[code + valoff[l]];
    }
  }
  return -1;
}

// the s-bit value that follows a symbol, sign-extended (jdhuff.h HUFF_EXTEND)
__device__ __forceinline__ int receive_extend(Bits& b, int s) {
  int x = (int)peek(b, s);
  skip(b, s);
  return x < (1 << (s - 1)) ? x + (int)((-1u) << s) + 1 : x;
}
