// Baseline JPEG sample reconstruction: dequantisation + the islow inverse
// DCT + level shift + clamp into uint8 component planes (`idct_kernel`),
// then fancy upsampling + YCbCr -> RGB into [H, W, 3] uint8 frames
// (`color_kernel`).
//
// Replaces no TPU kernel: the JAX package decodes its frames on the host
// through PIL, whose libjpeg-turbo runs jidctint.c jpeg_idct_islow,
// jdsample.c's fancy upsampling and jdcolor.c ycc_rgb_convert; both kernels
// reproduce those bit for bit (rodynrf_tpu_torch/data/jpeg.py holds their
// plain versions, `idct_plain` and `color_plain`).
//
// Written in CUDA C++ rather than Triton: the work is integer and
// elementwise or a small stencil, and what has to be right is libjpeg's
// exact integer rounding (DESCALE, the 10-bit range-limit wrap) and
// jdsample.c's edge and context-row rules, which are easier to state and to
// check line by line against the C they come from.
//
// Bound: bytes. The IDCT reads 128 bytes of coefficients and writes 64
// samples per block; the colour pass reads its planes and writes 3 bytes a
// pixel (about 12.4 MB together for a 1920×1080 4:2:0 frame, 3.7 µs at the
// H100's 3.35 TB/s). Design: 8 threads per 8×8 block, a column pass into a
// shared-memory workspace, then a row pass that stores 8 samples as one
// 8-byte word; one thread per output pixel in the colour pass, which
// computes each component's upsampled sample from the 2 or 4 plane samples
// around it (replicated at the component's real edges, as jdmainct.c
// replicates the first and last rows and jdsample.c the first and last
// columns).

#include <cuda_runtime.h>
#include <stdint.h>

#define PLANE_WORDS 8
#define FRAME_WORDS 5
#define BLOCKS_PER_CTA 32

#define FIX_0_298631336 2446LL
#define FIX_0_390180644 3196LL
#define FIX_0_541196100 4433LL
#define FIX_0_765366865 6270LL
#define FIX_0_899976223 7373LL
#define FIX_1_175875602 9633LL
#define FIX_1_501321110 12299LL
#define FIX_1_847759065 15137LL
#define FIX_1_961570560 16069LL
#define FIX_2_053119869 16819LL
#define FIX_2_562915447 20995LL
#define FIX_3_072711026 25172LL

// the last entry <= key of a sorted array of n + 1 starts
__device__ __forceinline__ int find(const long long* starts, int n, long long key) {
  int lo = 0, hi = n;  // starts[lo] <= key < starts[hi]
  while (hi - lo > 1) {
    int mid = (lo + hi) >> 1;
    if (starts[mid] <= key) lo = mid; else hi = mid;
  }
  return lo;
}

// one 1-D pass of jidctint.c (the LL&M islow algorithm), outputs DESCALEd
// by `shift` (CONST_BITS - PASS1_BITS = 11 for columns, CONST_BITS +
// PASS1_BITS + 3 = 18 for rows)
__device__ __forceinline__ void islow_1d(const long long x[8], long long out[8], int shift) {
  long long z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
  z2 = x[2];
  z3 = x[6];
  z1 = (z2 + z3) * FIX_0_541196100;
  tmp2 = z1 + z3 * (-FIX_1_847759065);
  tmp3 = z1 + z2 * FIX_0_765366865;
  tmp0 = (x[0] + x[4]) * 8192LL;  // << CONST_BITS
  tmp1 = (x[0] - x[4]) * 8192LL;
  tmp10 = tmp0 + tmp3;
  tmp13 = tmp0 - tmp3;
  tmp11 = tmp1 + tmp2;
  tmp12 = tmp1 - tmp2;

  tmp0 = x[7];
  tmp1 = x[5];
  tmp2 = x[3];
  tmp3 = x[1];
  z1 = tmp0 + tmp3;
  z2 = tmp1 + tmp2;
  z3 = tmp0 + tmp2;
  z4 = tmp1 + tmp3;
  z5 = (z3 + z4) * FIX_1_175875602;
  tmp0 = tmp0 * FIX_0_298631336;
  tmp1 = tmp1 * FIX_2_053119869;
  tmp2 = tmp2 * FIX_3_072711026;
  tmp3 = tmp3 * FIX_1_501321110;
  z1 = z1 * (-FIX_0_899976223);
  z2 = z2 * (-FIX_2_562915447);
  z3 = z3 * (-FIX_1_961570560);
  z4 = z4 * (-FIX_0_390180644);
  z3 += z5;
  z4 += z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;

  const long long r = 1LL << (shift - 1);
  out[0] = (tmp10 + tmp3 + r) >> shift;
  out[7] = (tmp10 - tmp3 + r) >> shift;
  out[1] = (tmp11 + tmp2 + r) >> shift;
  out[6] = (tmp11 - tmp2 + r) >> shift;
  out[2] = (tmp12 + tmp1 + r) >> shift;
  out[5] = (tmp12 - tmp1 + r) >> shift;
  out[3] = (tmp13 + tmp0 + r) >> shift;
  out[4] = (tmp13 - tmp0 + r) >> shift;
}

__global__ void idct_kernel(const short* __restrict__ coef, long long n_blocks,
                            const long long* __restrict__ plane_block0, int n_planes,
                            const int* __restrict__ plane,
                            const long long* __restrict__ plane_pix0,
                            const int* __restrict__ quant, uint8_t* __restrict__ out) {
  __shared__ int ws[BLOCKS_PER_CTA][64];
  const int lb = threadIdx.x >> 3, t = threadIdx.x & 7;
  const long long b = (long long)blockIdx.x * BLOCKS_PER_CTA + lb;
  const bool live = b < n_blocks;
  int p = 0;
  long long x[8], y[8];
  if (live) {
    p = find(plane_block0, n_planes, b);
    const short* cb = coef + 64 * b;
    const int* q = quant + 64 * p;
    // pass 1: column t (DEQUANTIZE: coefficient × quantiser, an int product)
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = (long long)((int)cb[8 * k + t] * q[8 * k + t]);
    islow_1d(x, y, 11);
#pragma unroll
    for (int k = 0; k < 8; ++k) ws[lb][8 * k + t] = (int)y[k];
  }
  __syncthreads();
  if (!live) return;
  // pass 2: row t
#pragma unroll
  for (int k = 0; k < 8; ++k) x[k] = ws[lb][8 * t + k];
  islow_1d(x, y, 18);
  uint64_t word = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    // range_limit[v & RANGE_MASK]: v wraps at ±512, then + CENTERJSAMPLE, clamped
    int v = (int)(((y[k] & 1023) ^ 512) - 512) + 128;
    v = v < 0 ? 0 : (v > 255 ? 255 : v);
    word |= (uint64_t)v << (8 * k);
  }
  const int* pl = plane + PLANE_WORDS * p;
  const long long bw = pl[0], local = b - plane_block0[p];
  const long long by = local / bw, bx = local % bw;
  *(uint64_t*)(out + plane_pix0[p] + (by * 8 + t) * (bw * 8) + bx * 8) = word;
}

struct Plane {
  const uint8_t* s;
  long long stride;
  int cw, ch;
  __device__ __forceinline__ int at(int r, int c) const { return s[r * stride + c]; }
};

// one component's sample at output pixel (y, x) after jdsample.c's upsampling
__device__ __forceinline__ int upsampled(const Plane& P, int rh, int rv, int fancy, int y,
                                         int x) {
  if (rh == 1 && rv == 1) return P.at(y, x);
  if (rh == 2 && !fancy) return P.at(rv == 2 ? y >> 1 : y, x >> 1);  // box (h2v1/h2v2_upsample)
  if (rh == 1) {  // h1v2_fancy_upsample: (3·nearer + further + 1 or 2) >> 2
    const int r = y >> 1, odd = y & 1;
    const int rn = odd ? min(r + 1, P.ch - 1) : max(r - 1, 0);
    return (3 * P.at(r, x) + P.at(rn, x) + (odd ? 2 : 1)) >> 2;
  }
  const int i = x >> 1, oddx = x & 1;
  const int j = oddx ? min(i + 1, P.cw - 1) : max(i - 1, 0);
  if (rv == 1)  // h2v1_fancy_upsample
    return (3 * P.at(y, i) + P.at(y, j) + (oddx ? 2 : 1)) >> 2;
  // h2v2_fancy_upsample: column sums 3·nearer + further row, then
  // (3·this + other + 8 or 7) >> 4
  const int r = y >> 1, oddy = y & 1;
  const int rn = oddy ? min(r + 1, P.ch - 1) : max(r - 1, 0);
  const int ci = 3 * P.at(r, i) + P.at(rn, i);
  const int cj = 3 * P.at(r, j) + P.at(rn, j);
  return (3 * ci + cj + (oddx ? 7 : 8)) >> 4;
}

__device__ __forceinline__ uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

__global__ void color_kernel(const uint8_t* __restrict__ planes, long long n_pixels,
                             const long long* __restrict__ frame_pix0, int n_frames,
                             const int* __restrict__ frame, const int* __restrict__ plane,
                             const long long* __restrict__ plane_pix0,
                             uint8_t* __restrict__ out) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_pixels) return;
  const int f = find(frame_pix0, n_frames, g);
  const int* fr = frame + FRAME_WORDS * f;
  const int W = fr[1], color = fr[2], nc = fr[3], p0 = fr[4];
  const long long local = g - frame_pix0[f];
  const int y = (int)(local / W), x = (int)(local % W);
  int v[3];
  for (int c = 0; c < nc; ++c) {
    const int* pl = plane + PLANE_WORDS * (p0 + c);
    Plane P{planes + plane_pix0[p0 + c], 8LL * pl[0], pl[2], pl[3]};
    v[c] = upsampled(P, pl[4], pl[5], pl[6], y, x);
  }
  uint8_t* o = out + 3 * g;
  if (color == 0) {  // gray, repeated
    o[0] = o[1] = o[2] = (uint8_t)v[0];
  } else if (color == 1) {  // jdcolor.c ycc_rgb_convert, SCALEBITS 16
    const int cb = v[1] - 128, cr = v[2] - 128;
    o[0] = clamp255(v[0] + ((91881 * cr + 32768) >> 16));
    o[1] = clamp255(v[0] + ((-22554 * cb + 32768 - 46802 * cr) >> 16));
    o[2] = clamp255(v[0] + ((116130 * cb + 32768) >> 16));
  } else {  // Adobe RGB
    o[0] = (uint8_t)v[0];
    o[1] = (uint8_t)v[1];
    o[2] = (uint8_t)v[2];
  }
}

extern "C" int rodynrf_jpeg_idct(const void* coef, long long n_blocks, const void* plane_block0,
                                 int n_planes, const void* plane, const void* plane_pix0,
                                 const void* quant, void* out, void* stream) {
  if (n_blocks <= 0) return 0;
  const long long ctas = (n_blocks + BLOCKS_PER_CTA - 1) / BLOCKS_PER_CTA;
  idct_kernel<<<(unsigned)ctas, 8 * BLOCKS_PER_CTA, 0, (cudaStream_t)stream>>>(
      (const short*)coef, n_blocks, (const long long*)plane_block0, n_planes,
      (const int*)plane, (const long long*)plane_pix0, (const int*)quant, (uint8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int rodynrf_jpeg_color(const void* planes, long long n_pixels, const void* frame_pix0,
                                  int n_frames, const void* frame, const void* plane,
                                  const void* plane_pix0, void* out, void* stream) {
  if (n_pixels <= 0) return 0;
  const int threads = 256;
  const long long ctas = (n_pixels + threads - 1) / threads;
  color_kernel<<<(unsigned)ctas, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)planes, n_pixels, (const long long*)frame_pix0, n_frames,
      (const int*)frame, (const int*)plane, (const long long*)plane_pix0, (uint8_t*)out);
  return (int)cudaGetLastError();
}
