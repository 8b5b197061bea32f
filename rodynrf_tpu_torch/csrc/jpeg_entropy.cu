// Baseline JPEG entropy decode: Huffman DC and AC symbols of every
// entropy-coded segment of a batch of frames into int16 coefficient blocks.
//
// Replaces no TPU kernel: the JAX package decodes its frames on the host
// through PIL (libjpeg-turbo, jdhuff.c decode_mcu), and the port reads the
// same frames on the card (rodynrf_tpu_torch/data/jpeg.py, whose
// `entropy_decode_plain` is this kernel's plain version).
//
// Design: one thread per entropy-coded segment (a restart interval, or the
// whole scan of a frame without DRI), over all segments of all frames, each
// on a warp of its own: lanes of one warp decoding different segments
// diverge at every symbol and take turns (8 frames in one warp took 1.8
// times one frame's time on an H100 80GB HBM3 at 700 W). A segment's bits
// depend on every bit before them, so inside a segment the decode is
// serial; what bounds it on this card is that dependence (one table lookup
// per symbol, over a million symbols in a 1080p frame), not the bytes it
// moves. A thread keeps a 64-bit bit buffer, decodes each symbol through a 9-bit
// lookahead table (longer codes by the canonical maxcode walk, as jdhuff.c),
// keeps the DC predictor of each component (reset at each segment), and
// writes each nonzero coefficient into its block in natural order (the
// wrapper zeroes the blocks first). Each segment leaves a status word that
// the host reads once per batch: 0, or a corrupt code, an AC run past the
// 64th coefficient, or a segment that ends before its last MCU.
//
// Inputs (rodynrf_tpu_torch/data/jpeg.py `JpegBatch`):
//   data  uint8, every segment's unstuffed bytes back to back;
//   seg   int32 [S, 5]: byte offset, byte length, frame, first MCU, MCUs;
//   scan  int32 [F, SCAN_WORDS]: scan components, MCUs per row, then per
//         scan component (plane, h, v, DC slot, AC slot);
//   huff  int32 [F, 8, HUFF_WORDS]: lookahead[512] (length << 8 | symbol),
//         maxcode[18], valoffset[18], symbols[256];
//   plane_block0 int64 [P + 1]; plane int32 [P, 8] (blocks per row first).
// Output: coef int16 [blocks, 64], status int32 [S].

#include <cuda_runtime.h>
#include <stdint.h>

#define LOOKAHEAD 9
#define HUFF_WORDS ((1 << LOOKAHEAD) + 18 + 18 + 256)
#define SCAN_WORDS 17
#define PLANE_WORDS 8

enum { OK = 0, BAD_CODE = 1, BAD_AC = 2, SHORT_SEGMENT = 3 };

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

__global__ void entropy_kernel(const uint8_t* __restrict__ data, const int* __restrict__ seg,
                               int n_seg, const int* __restrict__ scan,
                               const int* __restrict__ huff,
                               const long long* __restrict__ plane_block0,
                               const int* __restrict__ plane, short* __restrict__ coef,
                               int* __restrict__ status) {
  // one segment per warp, on its first lane: the segments' decodes branch
  // apart at every symbol, and lanes of one warp would take turns
  const int s = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if ((threadIdx.x & 31) != 0 || s >= n_seg) return;
  const int* sg = seg + 5LL * s;
  const int f = sg[2], m0 = sg[3], nmcu = sg[4];
  const int* sc = scan + (long long)f * SCAN_WORDS;
  const int ncomp = sc[0], mcus_x = sc[1];
  const int* tabs = huff + (long long)f * 8 * HUFF_WORDS;

  Bits b;
  b.p = data + sg[0];
  b.nbytes = sg[1];
  b.next = 0;
  b.used = 0;
  b.acc = 0;
  b.have = 0;
  const long long nbits = 8LL * sg[1];

  int pred[3] = {0, 0, 0};
  int st = OK;
  for (int m = m0; m < m0 + nmcu && st == OK; ++m) {
    const int my = m / mcus_x, mx = m % mcus_x;
    for (int c = 0; c < ncomp && st == OK; ++c) {
      const int* cs = sc + 2 + 5 * c;
      const int pl = cs[0], h = cs[1], v = cs[2];
      const int* dct = tabs + cs[3] * HUFF_WORDS;
      const int* act = tabs + cs[4] * HUFF_WORDS;
      const long long bw = plane[(long long)pl * PLANE_WORDS];
      const long long b0 = plane_block0[pl];
      for (int yy = 0; yy < v && st == OK; ++yy) {
        for (int xx = 0; xx < h; ++xx) {
          short* blk = coef + 64 * (b0 + ((long long)my * v + yy) * bw + (long long)mx * h + xx);
          fill(b);
          int t = decode(b, dct);
          if (t < 0) { st = BAD_CODE; break; }
          if (t) {
            fill(b);
            pred[c] += receive_extend(b, t);
          }
          blk[0] = (short)pred[c];
          for (int k = 1; k < 64;) {
            fill(b);
            int rs = decode(b, act);
            if (rs < 0) { st = BAD_CODE; break; }
            int r = rs >> 4, sz = rs & 15;
            if (sz) {
              k += r;
              if (k > 63) { st = BAD_AC; break; }
              blk[kNatural[k]] = (short)receive_extend(b, sz);
              ++k;
            } else if (r == 15) {
              k += 16;
            } else {
              break;
            }
          }
          if (st != OK) break;
        }
      }
    }
    if (st == OK && b.used > nbits) st = SHORT_SEGMENT;
  }
  status[s] = st;
}

extern "C" int rodynrf_jpeg_entropy(const void* data, const void* seg, int n_seg,
                                    const void* scan, const void* huff,
                                    const void* plane_block0, const void* plane, void* coef,
                                    void* status, void* stream) {
  if (n_seg <= 0) return 0;
  const int threads = 128;  // 4 warps, 4 segments
  const int blocks = (n_seg + threads / 32 - 1) / (threads / 32);
  entropy_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int*)seg, n_seg, (const int*)scan, (const int*)huff,
      (const long long*)plane_block0, (const int*)plane, (short*)coef, (int*)status);
  return (int)cudaGetLastError();
}
