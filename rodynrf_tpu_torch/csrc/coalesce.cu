// Plane-table gradient of the corner-packed sampler, for sm_90a.
//
//   grad[r, k*C + c] = sum over m with rows[m] == r of  w4[m, k] * ct[m, c]
//   rows [M] int32 in [0, R), w4 [M, 4] f32, ct [M, C] f32  ->  grad [R, 4C] f32
//
// Replaces the Pallas TPU kernel rodynrf_tpu/ops/coalesced.py
// `_coalesce_kernel` (wrapper `_coalesce_pallas`). Same function, another
// design: the TPU kernel walks the sorted stream chunk by chunk on one core
// and turns each output block into a one-hot matmul; here thousands of warps
// run at once, each over its own piece of the sorted stream.
//
// Bound: bytes. Each input is read once and each output row written once:
// at the dynamic field's o0 shape (M = 829,440, R = 161,215, C = 80) that is
// about 0.28 GB read and 0.21 GB written, ~0.15 ms at 3.35 TB/s. There is no
// arithmetic to speak of (one FMA per input element and corner).
//
// Design:
//  * The caller sorts `rows` (stable) and passes the sorted keys with the
//    permutation; the kernel reads w4/ct through the permutation, so no
//    permuted copy is written out, and the factored (w4, ct) form is never
//    expanded to [M, 4C] in memory.
//  * Load balance over entries, not rows: samples pile onto few texels
//    (all 270 samples of a ray share its o0 texel), so a row can hold
//    thousands of entries. Warp c owns the fixed chunk of kChunk sorted
//    entries [c*kChunk, (c+1)*kChunk) and walks it in order, accumulating
//    the current row in f32 registers; lane l owns output columns l, l+32,
//    ... of the row (J = ceil(4C / 32) per lane, C <= 128).
//  * A row whose entries lie inside one chunk is written straight to grad.
//    A row that crosses chunk boundaries leaves one partial per chunk:
//    `tail[c]` in the chunk where it starts, `head[c]` in every later chunk.
//    A second kernel lets the chunk where such a row ends add those
//    partials in chunk order and write the row.
//  * Entries are fetched 32 at a time (one coalesced load of keys and
//    sources per lane, then warp shuffles) and their ct rows kUnroll at a
//    time, so several row loads are in flight per warp.
//  * Rows no sample reaches: a third kernel gives each warp 32 rows, each
//    lane looks its row up in the sorted keys (binary search), and the warp
//    writes zeros to the rows found absent. So `grad` needs no zero fill:
//    every output row is written exactly once, by one of the three kernels.
//  * No atomics: every output element is written by one thread, and every
//    sum is taken in the same order on every run (deterministic).
//  * Keys outside [0, R) trip a device-side assert, as index_add_ does on
//    the card (the sorted keys put them in the first or the last chunk); the
//    writes stay guarded so that a build without asserts cannot write
//    outside grad.

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kChunk = 64;   // sorted entries per warp
constexpr int kUnroll = 4;   // ct rows loaded ahead
constexpr int kMaxJ = 16;    // 4C <= 512
constexpr unsigned kFull = 0xffffffffu;

template <int J>
__device__ __forceinline__ void store_row(float* __restrict__ dst, const float (&acc)[J],
                                          const int (&corner)[J], int lane) {
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (corner[j] < 4) dst[lane + kWarp * j] = acc[j];
}

template <int J>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
coalesce_chunks(const int* __restrict__ keys, const int* __restrict__ perm,
                const float4* __restrict__ w4, const float* __restrict__ ct,
                float* __restrict__ out, float* __restrict__ head, float* __restrict__ tail,
                int M, int R, int C) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int c = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int start = c * kChunk;
  if (start >= M) return;
  const int end = min(start + kChunk, M);
  const int KC = 4 * C;

  int corner[J], chan[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int o = lane + kWarp * j;
    corner[j] = o / C;  // >= 4 past the row end: that slot is idle
    chan[j] = o - corner[j] * C;
  }

  const int first_key = __ldg(keys + start);
  if (lane == 0 && start == 0) assert(first_key >= 0);
  if (lane == 0 && end == M) assert(__ldg(keys + M - 1) < R);
  const bool first_from_before = start > 0 && __ldg(keys + start - 1) == first_key;
  const bool last_to_after = end < M && __ldg(keys + end) == __ldg(keys + end - 1);

  float acc[J];
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = 0.f;
  int cur = first_key;
  bool first_seg = true;

  // the segment of key `cur` ended; last_seg: it ends at the chunk's end
  auto flush = [&](bool last_seg) {
    const bool from_before = first_seg && first_from_before;
    const bool to_after = last_seg && last_to_after;
    if (from_before || to_after) {
      store_row<J>((from_before ? head : tail) + static_cast<size_t>(c) * KC, acc, corner, lane);
    } else if (cur >= 0 && cur < R) {
      store_row<J>(out + static_cast<size_t>(cur) * KC, acc, corner, lane);
    }
  };

  for (int base = start; base < end; base += kWarp) {
    const int n = min(kWarp, end - base);
    const int k_l = lane < n ? __ldg(keys + base + lane) : 0;
    const int s_l = lane < n ? __ldg(perm + base + lane) : 0;
    for (int j0 = 0; j0 < n; j0 += kUnroll) {
      int kk[kUnroll];
      float4 w[kUnroll];
      float v[kUnroll][J];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jj = j0 + u;
        kk[u] = __shfl_sync(kFull, k_l, jj & (kWarp - 1));
        const int src = __shfl_sync(kFull, s_l, jj & (kWarp - 1));
        const bool live = jj < n;
        w[u] = live ? __ldg(w4 + src) : make_float4(0.f, 0.f, 0.f, 0.f);
        const float* row = ct + static_cast<size_t>(src) * C;
#pragma unroll
        for (int j = 0; j < J; ++j)
          v[u][j] = (live && corner[j] < 4) ? __ldg(row + chan[j]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j0 + u >= n) break;
        if (kk[u] != cur) {  // warp-uniform: every lane sees the same key
          flush(false);
          first_seg = false;
          cur = kk[u];
#pragma unroll
          for (int j = 0; j < J; ++j) acc[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = corner[j];
          const float wk = k == 0 ? w[u].x : (k == 1 ? w[u].y : (k == 2 ? w[u].z : w[u].w));
          acc[j] = fmaf(wk, v[u][j], acc[j]);
        }
      }
    }
  }
  flush(true);
}

// Rows that cross chunk boundaries: the chunk where such a row ends sums
// tail[first chunk] + head[every later chunk up to its own], in order.
template <int J>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
coalesce_fixup(const int* __restrict__ keys, const float* __restrict__ head,
               const float* __restrict__ tail, float* __restrict__ out, int M, int R, int C) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int c = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int start = c * kChunk;
  if (start >= M || start == 0) return;
  const int end = min(start + kChunk, M);
  const int key = __ldg(keys + start);
  if (__ldg(keys + start - 1) != key) return;             // row starts in this chunk
  if (end < M && __ldg(keys + end) == key) return;        // row goes on past this chunk
  if (key < 0 || key >= R) return;
  int c0 = c - 1;  // the chunk where the row starts
  while (c0 > 0 && __ldg(keys + c0 * kChunk - 1) == key) --c0;
  const int KC = 4 * C;
  int corner[J];
#pragma unroll
  for (int j = 0; j < J; ++j) corner[j] = (lane + kWarp * j) / C;
  float acc[J];
#pragma unroll
  for (int j = 0; j < J; ++j)
    acc[j] = corner[j] < 4 ? tail[static_cast<size_t>(c0) * KC + lane + kWarp * j] : 0.f;
  for (int cc = c0 + 1; cc <= c; ++cc) {
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (corner[j] < 4) acc[j] += head[static_cast<size_t>(cc) * KC + lane + kWarp * j];
  }
  store_row<J>(out + static_cast<size_t>(key) * KC, acc, corner, lane);
}

// Rows with no entry: warp w covers rows [32w, 32w + 32); lane l finds
// whether row 32w + l occurs in the sorted keys; the warp then writes zeros
// to each absent row, C float4 stores per row (rows are 16C bytes apart).
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
zero_empty_rows(const int* __restrict__ keys, float* __restrict__ out, int M, int R, int C) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int r0 = (blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp) * kWarp;
  if (r0 >= R) return;  // warp-uniform
  const int r = r0 + lane;
  bool empty = false;
  if (r < R) {
    int lo = 0, hi = M;  // first i with keys[i] >= r
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(keys + mid) < r) lo = mid + 1; else hi = mid;
    }
    empty = lo == M || __ldg(keys + lo) != r;
  }
  unsigned todo = __ballot_sync(kFull, empty);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  while (todo) {
    const int b = __ffs(todo) - 1;
    todo &= todo - 1;
    float4* dst = reinterpret_cast<float4*>(out + static_cast<size_t>(r0 + b) * 4 * C);
    for (int i = lane; i < C; i += kWarp) dst[i] = zero;
  }
}

template <int J>
cudaError_t launch(int j, const int* keys, const int* perm, const float4* w4, const float* ct,
                   float* out, float* head, float* tail, int M, int R, int C,
                   cudaStream_t stream) {
  if (j == J) {
    const int row_warps = (R - 1) / kWarp + 1;
    zero_empty_rows<<<(row_warps + kWarpsPerBlock - 1) / kWarpsPerBlock, kWarp * kWarpsPerBlock,
                      0, stream>>>(keys, out, M, R, C);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int chunks = (M + kChunk - 1) / kChunk;
    const int blocks = (chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
    coalesce_chunks<J><<<blocks, kWarp * kWarpsPerBlock, 0, stream>>>(
        keys, perm, w4, ct, out, head, tail, M, R, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    coalesce_fixup<J><<<blocks, kWarp * kWarpsPerBlock, 0, stream>>>(keys, head, tail, out, M, R,
                                                                      C);
    return cudaGetLastError();
  }
  if constexpr (J < kMaxJ) {
    return launch<J + 1>(j, keys, perm, w4, ct, out, head, tail, M, R, C, stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Chunk size the caller sizes `head`/`tail` with: [ceil(M / chunk), 4C] f32 each.
int rodynrf_coalesce_chunk() { return kChunk; }

// keys: sorted rows [M] int32; perm: int32 [M] with keys[i] == rows[perm[i]];
// w4: [M, 4] f32 (16-byte aligned rows); ct: [M, C] f32; out: [R, 4C] f32,
// 16-byte aligned, every element written here; head, tail: scratch as
// above. M >= 1 (with no entries the gradient is a zero fill, which the
// caller makes). Returns the cudaError_t of the launches (0 on success).
int rodynrf_coalesce_table_grad(const void* keys, const void* perm, const void* w4,
                                const void* ct, void* out, void* head, void* tail,
                                int M, int R, int C, void* stream) {
  if (M <= 0 || R <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (C <= 0 || 4 * C > kWarp * kMaxJ) return static_cast<int>(cudaErrorInvalidValue);
  const int j = (4 * C + kWarp - 1) / kWarp;
  return static_cast<int>(launch<1>(
      j, static_cast<const int*>(keys), static_cast<const int*>(perm),
      static_cast<const float4*>(w4), static_cast<const float*>(ct), static_cast<float*>(out),
      static_cast<float*>(head), static_cast<float*>(tail), M, R, C,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
