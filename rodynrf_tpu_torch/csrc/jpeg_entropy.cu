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

#include "jpeg_huff.cuh"

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
