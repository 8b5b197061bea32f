// Baseline JPEG sample reconstruction: dequantisation + the islow inverse
// DCT + level shift + clamp into uint8 component planes (`idct_kernel`),
// then fancy upsampling + YCbCr -> RGB into [H, W, 3] uint8 frames
// (`color_kernel`).
//
// Replaces no TPU kernel: the JAX package decodes its frames on the host
// through PIL, whose libjpeg-turbo runs jidctint.c jpeg_idct_islow,
// jdsample.c's fancy upsampling and jdcolor.c ycc_rgb_convert; both kernels
// reproduce those bit for bit (rodynrf_tpu_torch/data/jpeg.py holds their
// plain versions, `idct_plain` and `color_plain`, and Python models of
// these designs, `idct_int32_model` and `color_tiled_model`).
//
// Written in CUDA C++ rather than Triton: the work is integer and
// elementwise or a small stencil, and what has to be right is libjpeg's
// exact integer rounding (DESCALE, the 10-bit range-limit wrap) and
// jdsample.c's edge and context-row rules, which are easier to state and to
// check line by line against the C they come from.
//
// Bound: bytes, as chip_smoke.jpeg_bytes counts them. The IDCT reads 128
// bytes of coefficients a block (and the quantisers) and writes its 64
// samples; the colour pass reads the planes and writes 3 bytes a pixel:
// 75 MB each for the 8-frame 1920×1080 4:2:0 batch, 22 µs at the H100's
// 3.35 TB/s.
//
// What held the first design back (NVIDIA H100, on that batch: the IDCT
// 0.0706 ms, the colour pass 0.2413 ms, 32% and 9% of their bounds): index
// arithmetic, not memory. Every IDCT thread binary-searched 64-bit plane
// starts, divided and took a modulo in 64 bits (software routines on the
// card) and ran islow in `long long`; every colour thread (one a pixel)
// binary-searched the frame starts, divided in 64 bits, reloaded the plane
// words, loaded single bytes, recomputed the h2v2 column sums for each of
// the 4 pixels that share them and stored 3 single bytes.
//
// Design now: host-built tables (data/jpeg.pack) give each CTA its work in
// one row that holds everything it reads besides the data, so no thread
// searches, divides in 64 bits or chases a chain of descriptors.
// - idct_kernel: a CTA takes a run of up to IDCT_RUN blocks along one block
//   row of one plane (`idct_runs`: plane, block row, first block, blocks,
//   blocks per row, the run's first block, its first sample's byte); 8
//   threads a block, each loading one coefficient row as a 16-byte word.
//   The dequantised rows meet the column pass, and the column pass the row
//   pass, in a shared workspace padded to 9 words a row (conflict-free both
//   ways). Pass 1 runs in 32 bits for every column whose largest |coef·q|
//   is at most IDCT32_MAX (below), else in 64 bits, in the same launch;
//   pass 2 always runs in 32 bits (below), its range limit one DPX
//   instruction. Row t of a pair of neighbouring blocks goes out as one
//   16-byte word (the odd block's half by a shuffle), or each block's as an
//   8-byte word where the plane's row stride is an odd number of them.
// - color_kernel: a CTA takes an output tile of COLOR_TH rows × COLOR_TW
//   columns of one frame (`color_tiles`: the tile, its frame's words and
//   its planes' words). Each component's samples under the tile and a
//   one-sample halo are staged in shared memory by 16-byte loads (8-byte
//   where a plane's row stride is an odd number of 8 bytes), source rows
//   clamped to the component and the halo columns -1 and cw written as
//   copies of columns 0 and cw - 1 by the threads that stage those:
//   jdsample.c's and jdmainct.c's edge replication at the component's real
//   size (cw, ch). Each thread makes 2 rows of 4 columns at 4·lane and 4 at
//   128 + 4·lane (a warp's 12-byte groups then fall in distinct banks):
//   under h2v2, two chroma samples' 2×2 outputs from the column sums of
//   four columns. YCbCr -> RGB ends in one DPX add-min-relu a channel. The
//   RGB rows are staged in shared memory at the alignment of their place in
//   the frame, and each warp stores its two rows as 16-byte words (bytes at
//   a row's two ends). Gray, Adobe RGB, 4:4:4, h2v1, h1v2 and the box
//   filter (no fancy upsampling for an h2 component 2 or fewer samples
//   wide) take the same staging; frames of any size and mix share one
//   launch.
// What holds the colour pass back now (measured by ablation on the card,
// PERF.md §6.15): its three phases run in turn in each CTA — the staging
// loads' latency, the integer work and the shared-memory byte traffic of
// the 3-byte interleave, then the stores — and overlap only across CTAs;
// a persistent double-buffered variant with cp.async measured slower.
//
// The 32-bit route. islow's pass 1 ends each output in a DESCALE by 11 bits
// of an integer linear form of the column's 8 products x = coef·q; pass 2
// ends in one by 18 bits followed by `& 1023` (RANGE_MASK). Computed in
// unsigned 32-bit arithmetic, every sum is right modulo 2^32:
// - pass 2 needs only bits 18..27 of its sums, so it is exact for any
//   input: 32 bits always;
// - pass 1 keeps bits 11 and up, so it is exact when the true sum + 1024
//   lies in [-2^31, 2^31). The largest L1 norm of a row of pass 1's integer
//   matrix is 61214 (data/jpeg.islow_pass1_l1), so that holds for every
//   column with max |x| <= (2^31 - 1 - 1024) / 61214 = 35081, and fails just
//   past it (x = ±35082 in the signs of the worst row). Valid 8-bit data
//   stays far below; damaged streams reach 32767 · 255.

#include <cuda_runtime.h>
#include <stdint.h>

#define IDCT_RUN 32
#define IDCT_WS 72  // a block's workspace: 8 rows of 9 words
#define IDCT32_MAX 35081
// CTAs an SM holds at once, the launch bounds' second argument: both
// kernels are latency-bound, and measured fastest at these (32 registers a
// thread, no spills)
#define IDCT_MIN_CTAS 8
#define COLOR_MIN_CTAS 7
#define COLOR_TH 16
#define COLOR_TW 256
#define WIN_ROWS (COLOR_TH + 2)
#define WIN_BYTES 304  // a window row: 16 + the staged words (COLOR_TW + 2 samples + 15)
#define OUT_WORDS 49  // 16-byte words of a staged RGB row: 3 · COLOR_TW bytes + 15 of alignment

#define FIX_0_298631336 2446
#define FIX_0_390180644 3196
#define FIX_0_541196100 4433
#define FIX_0_765366865 6270
#define FIX_0_899976223 7373
#define FIX_1_175875602 9633
#define FIX_1_501321110 12299
#define FIX_1_847759065 15137
#define FIX_1_961570560 16069
#define FIX_2_053119869 16819
#define FIX_2_562915447 20995
#define FIX_3_072711026 25172

// one 1-D pass of jidctint.c (the LL&M islow algorithm) before its DESCALE:
// out[j] = tmp10 + tmp3, tmp11 + tmp2, ... in T (unsigned: modulo 2^32)
template <typename T>
__device__ __forceinline__ void islow_sums(const T x[8], T out[8]) {
  T z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
  z2 = x[2];
  z3 = x[6];
  z1 = (z2 + z3) * (T)FIX_0_541196100;
  tmp2 = z1 + z3 * (T)(-FIX_1_847759065);
  tmp3 = z1 + z2 * (T)FIX_0_765366865;
  tmp0 = (x[0] + x[4]) * (T)8192;  // << CONST_BITS
  tmp1 = (x[0] - x[4]) * (T)8192;
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
  z5 = (z3 + z4) * (T)FIX_1_175875602;
  tmp0 = tmp0 * (T)FIX_0_298631336;
  tmp1 = tmp1 * (T)FIX_2_053119869;
  tmp2 = tmp2 * (T)FIX_3_072711026;
  tmp3 = tmp3 * (T)FIX_1_501321110;
  z1 = z1 * (T)(-FIX_0_899976223);
  z2 = z2 * (T)(-FIX_2_562915447);
  z3 = z3 * (T)(-FIX_1_961570560);
  z4 = z4 * (T)(-FIX_0_390180644);
  z3 += z5;
  z4 += z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;

  out[0] = tmp10 + tmp3;
  out[7] = tmp10 - tmp3;
  out[1] = tmp11 + tmp2;
  out[6] = tmp11 - tmp2;
  out[2] = tmp12 + tmp1;
  out[5] = tmp12 - tmp1;
  out[3] = tmp13 + tmp0;
  out[4] = tmp13 - tmp0;
}

__global__ void __launch_bounds__(8 * IDCT_RUN, IDCT_MIN_CTAS)
idct_kernel(const short* __restrict__ coef, const int4* __restrict__ runs,
            const int* __restrict__ quant, uint8_t* __restrict__ out) {
  __shared__ int ws[IDCT_RUN * IDCT_WS];
  // the run's row (data/jpeg.idct_runs): plane, block row, first block in
  // the row, blocks; blocks per row, the run's first block, the byte of its
  // top-left sample
  const int4 r0 = runs[2 * blockIdx.x], r1 = runs[2 * blockIdx.x + 1];
  const int p = r0.x, n = r0.w;
  const int lb = threadIdx.x >> 3, t = threadIdx.x & 7;
  const long long stride = 8LL * r1.x;
  const bool live = lb < n;
  int* w = ws + lb * IDCT_WS;
  if (live) {  // row t, dequantised (DEQUANTIZE: an int product)
    const uint4 raw = reinterpret_cast<const uint4*>(coef + 64LL * (r1.y + lb))[t];
    const int4* qr = reinterpret_cast<const int4*>(quant + 64 * p + 8 * t);
    const int4 q0 = qr[0], q1 = qr[1];
    const int qv[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
    const unsigned rw[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int k = 0; k < 8; ++k)
      w[9 * t + k] = (int)(short)(rw[k >> 1] >> (16 * (k & 1))) * qv[k];
  }
  __syncwarp();
  if (live) {  // pass 1: column t, DESCALEd by CONST_BITS - PASS1_BITS = 11
    int x[8], y[8], m = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      x[k] = w[9 * k + t];
      m = max(m, abs(x[k]));
    }
    if (m <= IDCT32_MAX) {
      unsigned u[8], s[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) u[k] = (unsigned)x[k];
      islow_sums<unsigned>(u, s);
#pragma unroll
      for (int k = 0; k < 8; ++k) y[k] = (int)(s[k] + 1024u) >> 11;
    } else {
      long long v[8], s[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = x[k];
      islow_sums<long long>(v, s);
#pragma unroll
      for (int k = 0; k < 8; ++k) y[k] = (int)((s[k] + 1024) >> 11);  // the workspace holds ints
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) w[9 * k + t] = y[k];  // column t: read by this thread alone
  }
  __syncwarp();
  unsigned lo = 0, hi = 0;  // row t's 8 samples
  if (live) {  // pass 2: row t, DESCALEd by CONST_BITS + PASS1_BITS + 3 = 18
    unsigned u[8], s[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) u[k] = (unsigned)w[9 * t + k];
    islow_sums<unsigned>(u, s);
    int v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)  // range_limit[v & RANGE_MASK]: bits 18..27 as a signed
      // 10-bit value (it wraps at ±512), + CENTERJSAMPLE, clamped to 0..255
      v[k] = __viaddmin_s32_relu((int)((s[k] + (1u << 17)) << 4) >> 22, 128, 255);
    lo = __byte_perm(__byte_perm(v[0], v[1], 0x0040), __byte_perm(v[2], v[3], 0x0040), 0x5410);
    hi = __byte_perm(__byte_perm(v[4], v[5], 0x0040), __byte_perm(v[6], v[7], 0x0040), 0x5410);
  }
  // row t of the block pair (2j, 2j + 1) as one 16-byte word where the
  // plane's rows are 16-byte aligned (its first sample and the run's are), else
  // each block's row as an 8-byte word
  const unsigned lo1 = __shfl_xor_sync(0xffffffffu, lo, 8);
  const unsigned hi1 = __shfl_xor_sync(0xffffffffu, hi, 8);
  uint8_t* o = out + (((long long)r1.w << 32) | (unsigned)r1.z) + t * stride + 8 * lb;
  if (!live) return;
  if ((stride & 15) == 0) {
    if ((lb & 1) == 0) {
      if (lb + 1 < n)
        *reinterpret_cast<uint4*>(o) = make_uint4(lo, hi, lo1, hi1);
      else
        *reinterpret_cast<uint2*>(o) = make_uint2(lo, hi);
    }
  } else {
    *reinterpret_cast<uint2*>(o) = make_uint2(lo, hi);
  }
}

// one component's staged window under a tile: sample rows r0 .. r0 +
// COLOR_TH / rv + 1 and columns c0 .. c0 + COLOR_TW / rh + 1 (a one-sample
// halo around the samples the tile's outputs read), replicated at the
// component's real size (cw, ch) as jdsample.c and jdmainct.c replicate its
// edges — columns past cw are read only by outputs past the frame's edge,
// which are not stored; sample (r, c) at `at + r · WIN_BYTES + c`
struct Window {
  const uint8_t* at;
  int rh, rv, fancy;
};

// one component's upsampled samples at output row y, columns x .. x + 3 (x
// a multiple of 4), after jdsample.c
__device__ __forceinline__ void upsample4(const Window& P, int y, int x, int v[4]) {
  if (P.rh == 1 && P.rv == 1) {
    const uint8_t* s = P.at + y * WIN_BYTES + x;
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = s[k];
  } else if (P.rh == 2 && !P.fancy) {  // box (h2v1/h2v2_upsample)
    const uint8_t* s = P.at + (P.rv == 2 ? y >> 1 : y) * WIN_BYTES + (x >> 1);
    v[0] = v[1] = s[0];
    v[2] = v[3] = s[1];
  } else if (P.rh == 1) {  // h1v2_fancy_upsample: (3·nearer + further + 1 or 2) >> 2
    const int odd = y & 1;
    const uint8_t* mid = P.at + (y >> 1) * WIN_BYTES + x;
    const uint8_t* far = mid + (odd ? WIN_BYTES : -WIN_BYTES);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = (3 * mid[k] + far[k] + 1 + odd) >> 2;
  } else {  // sample columns j - 1 .. j + 2 of output columns 2j .. 2j + 3
    int q[4];
    if (P.rv == 1) {  // h2v1_fancy_upsample: (3·nearer + further + 1 or 2) >> 2
      const uint8_t* s = P.at + y * WIN_BYTES + (x >> 1) - 1;
#pragma unroll
      for (int m = 0; m < 4; ++m) q[m] = s[m];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = 3 * q[k + 1];
        v[2 * k] = (t + q[k] + 1) >> 2;
        v[2 * k + 1] = (t + q[k + 2] + 2) >> 2;
      }
    } else {  // h2v2_fancy_upsample: column sums 3·nearer + further row, then
      // (3·this + other + 8 or 7) >> 4
      const uint8_t* mid = P.at + (y >> 1) * WIN_BYTES + (x >> 1) - 1;
      const uint8_t* far = mid + ((y & 1) ? WIN_BYTES : -WIN_BYTES);
#pragma unroll
      for (int m = 0; m < 4; ++m) q[m] = 3 * mid[m] + far[m];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = 3 * q[k + 1];
        v[2 * k] = (t + q[k] + 8) >> 4;
        v[2 * k + 1] = (t + q[k + 2] + 7) >> 4;
      }
    }
  }
}

// stage rows r0 .. r0 + nr - 1 of a component (source rows clamped to its
// ch rows) into a window: the words of WB bytes spanning columns clo .. chi
// at byte 16 + their offset from the first one's start; returns the byte of
// sample column 0 in window row 0. With `left` (the window starts at column
// -1) and `right` (it reaches past column cw - 1 = chi) the edge columns'
// replicas -1 and chi + 1 are written by the threads that stage columns 0
// and chi.
template <int WB>
__device__ __forceinline__ uint8_t* stage_window(uint8_t* win, const uint8_t* base,
                                                 long long stride, int r0, int nr, int ch,
                                                 int clo, int chi, bool left, bool right) {
  constexpr int per_row = (WIN_BYTES - 16) / WB;
  const int a0 = clo & -WB, last = (chi - a0) / WB;
  for (int i = threadIdx.x; i < nr * per_row; i += blockDim.x) {
    const int k = i / per_row, j = i - k * per_row;
    if (j > last) continue;
    uint8_t* row = win + k * WIN_BYTES + 16 - a0;  // sample column c at row[c]
    const int r = min(max(r0 + k, 0), ch - 1);
    const uint8_t* src = base + r * stride + a0 + j * WB;
    if (WB == 16)
      *reinterpret_cast<uint4*>(row + a0 + j * WB) = *reinterpret_cast<const uint4*>(src);
    else
      *reinterpret_cast<uint2*>(row + a0 + j * WB) = *reinterpret_cast<const uint2*>(src);
    if (left && j == 0) row[-1] = row[0];
    if (right && j == last) row[chi + 1] = row[chi];
  }
  return win + 16 - a0;
}

__global__ void __launch_bounds__(256, COLOR_MIN_CTAS)
color_kernel(const uint8_t* __restrict__ planes, const int4* __restrict__ tiles,
             uint8_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t win[3][WIN_ROWS * WIN_BYTES];
  __shared__ __align__(16) uint8_t rgb[COLOR_TH * 16 * OUT_WORDS];
  // the tile's row (data/jpeg.color_tiles): frame, first row, first column,
  // components | colour << 8, H, W, the frame's first output byte; then per
  // component its plane's first sample, blocks per row, cw, ch, rh, rv, fancy
  const int4* row = tiles + 8 * blockIdx.x;
  const int4 h0 = row[0], h1 = row[1];
  const int y0 = h0.y, x0 = h0.z, nc = h0.w & 255, color = h0.w >> 8, H = h1.x, W = h1.y;
  const long long o0 = ((long long)h1.w << 32) | (unsigned)h1.z;

  // stage each component's window: source rows clamped to the component,
  // the span of real columns as 16-byte words (8-byte where the plane's row
  // stride is an odd number of 8-byte words) at their alignment in the
  // plane; the halo's columns past the component's edges are the edge
  // columns: -1 is 0 and cw is cw - 1, the only ones past the edges that an
  // output inside the frame reads, written by the thread that stages the
  // edge column
  Window P[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (c >= nc) continue;
    const int4 a = row[2 + 2 * c], b = row[3 + 2 * c];
    const uint8_t* base = planes + (((long long)a.y << 32) | (unsigned)a.x);
    const long long stride = 8LL * a.z;
    const int cw = a.w, ch = b.x, rh = b.y, rv = b.z;
    const int r0 = (y0 >> (rv - 1)) - 1, c0 = (x0 >> (rh - 1)) - 1;
    const int c1 = c0 + (COLOR_TW >> (rh - 1)) + 1, clo = max(c0, 0), chi = min(c1, cw - 1);
    const int nr = (COLOR_TH >> (rv - 1)) + 2;
    uint8_t* lead;  // the staged byte of sample column 0 in window row 0
    if (stride & 15)
      lead = stage_window<8>(win[c], base, stride, r0, nr, ch, clo, chi, c0 < 0, c1 >= cw);
    else
      lead = stage_window<16>(win[c], base, stride, r0, nr, ch, clo, chi, c0 < 0, c1 >= cw);
    P[c] = Window{lead - r0 * WIN_BYTES, rh, rv, b.w};
  }
  __syncthreads();

  // warp w makes output rows 2w and 2w + 1 of the tile, a row at a time, 4
  // columns at 4·lane and 4 at 128 + 4·lane (so that a warp's byte stores of
  // 12 bytes a thread fall in distinct banks), converts them into staged RGB
  // rows and stores them
  const int lane = threadIdx.x & 31, oy = 2 * (threadIdx.x >> 5);
  long long g[2];  // each row's first output byte
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    g[i] = o0 + 3 * ((long long)(y0 + oy + i) * W + x0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ox = 128 * h + 4 * lane;
      int v[3][4];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        if (c < nc) upsample4(P[c], y0 + oy + i, x0 + ox, v[c]);
      uint8_t* s = rgb + (oy + i) * 16 * OUT_WORDS + (int)(g[i] & 15) + 3 * ox;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int r, gg, b;
        if (color == 0) {  // gray, repeated
          r = gg = b = v[0][k];
        } else if (color == 1) {  // jdcolor.c ycc_rgb_convert, SCALEBITS 16, with
          // cb, cr - 128 folded into the constants; + y, clamped to 0..255
          const int Y = v[0][k], cb = v[1][k], cr = v[2][k];
          r = __viaddmin_s32_relu(Y, (91881 * cr + (32768 - 91881 * 128)) >> 16, 255);
          gg = __viaddmin_s32_relu(
              Y, (-22554 * cb - 46802 * cr + (32768 + (22554 + 46802) * 128)) >> 16, 255);
          b = __viaddmin_s32_relu(Y, (116130 * cb + (32768 - 116130 * 128)) >> 16, 255);
        } else {  // Adobe RGB
          r = v[0][k];
          gg = v[1][k];
          b = v[2][k];
        }
        s[3 * k] = (uint8_t)r;
        s[3 * k + 1] = (uint8_t)gg;
        s[3 * k + 2] = (uint8_t)b;
      }
    }
  }
  __syncwarp();

  // each row's 3·tw bytes: whole 16-byte words, bytes at its two ends
  const int L = 3 * min(COLOR_TW, W - x0), n = min(2, H - y0 - oy) * OUT_WORDS;
  for (int i = lane; i < n; i += 32) {
    const int r = i >= OUT_WORDS, q = i - r * OUT_WORDS;
    const long long gr = r ? g[1] : g[0];
    const int off = (int)(gr & 15);
    const int lo = max(off, 16 * q), hi = min(off + L, 16 * q + 16);
    if (lo >= hi) continue;
    const uint8_t* src = rgb + (oy + r) * 16 * OUT_WORDS;
    uint8_t* d = out + (gr & ~15LL);
    if (hi - lo == 16)
      *reinterpret_cast<uint4*>(d + 16 * q) = *reinterpret_cast<const uint4*>(src + 16 * q);
    else
      for (int j = lo; j < hi; ++j) d[j] = src[j];
  }
}

extern "C" int rodynrf_jpeg_idct(const void* coef, int n_runs, const void* runs,
                                 const void* quant, void* out, void* stream) {
  if (n_runs <= 0) return 0;
  idct_kernel<<<(unsigned)n_runs, 8 * IDCT_RUN, 0, (cudaStream_t)stream>>>(
      (const short*)coef, (const int4*)runs, (const int*)quant, (uint8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int rodynrf_jpeg_color(const void* planes, int n_tiles, const void* tiles, void* out,
                                  void* stream) {
  if (n_tiles <= 0) return 0;
  color_kernel<<<(unsigned)n_tiles, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)planes, (const int4*)tiles, (uint8_t*)out);
  return (int)cudaGetLastError();
}
