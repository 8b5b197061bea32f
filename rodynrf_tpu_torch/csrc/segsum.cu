// Sorted segment row-sum (the merged-layout table gradient), for sm_90a.
//
//   out[r, :] = sum over k with keys[k] == r of  upd[src(k), :]
//   keys [M] int32 ascending in [0, R] (R is a trash bin: those entries are
//   dropped), src(k) = perm[k] (or k when perm is null), upd [*, C] bf16 or
//   f32  ->  out [R, C] f32 (f32 accumulation)
//
// Replaces the Pallas TPU kernel rodynrf_tpu/ops/pallas_segsum.py `_kernel`
// (wrapper `sorted_segment_rows_sum`). Same function, another design: the
// TPU kernel gives each 256-row output block to one program and folds its
// update range in with one-hot matmuls; here thousands of warps run at once,
// each over its own piece of the sorted stream and one column tile.
//
// Bound: bytes. Read keys and perm (int32) and upd once, write out once. At
// the dynamic field's merged o0 shape (M = 276,480, R ~ 374,745, C = 960,
// bf16 upd) that is 0.53 GB read and 1.44 GB written: 1.97 GB, ~0.59 ms at
// 3.35 TB/s (o1/o2, C = 240: ~0.11 ms each). One add per input element.
//
// Design (that of csrc/coalesce.cu, with column tiles):
//  * The caller sorts the keys (stable) and passes the permutation; the
//    kernel reads upd rows through it, so no sorted copy of upd is written.
//  * Load balance over entries, not rows: all 270 samples of a ray can land
//    on one o0 cell, so a row can hold hundreds of entries. Warp w owns the
//    chunk of kChunk sorted entries [w*kChunk, (w+1)*kChunk) and one column
//    tile of 32 lanes x 16 bytes of upd (256 bf16 or 128 f32 columns); it
//    walks the chunk in order, accumulating the current row in f32 registers.
//  * A row whose entries lie inside one chunk is written straight to out. A
//    row that crosses chunk boundaries leaves one partial per chunk:
//    `tail[c]` in the chunk where it starts, `head[c]` in every later chunk.
//    A second kernel lets the chunk where such a row ends add those partials
//    in chunk order and write the row.
//  * Rows no entry reaches: a third kernel gives each warp 32 rows, each
//    lane looks its row up in the sorted keys (binary search), and the warp
//    writes zeros to the rows found absent. So out needs no zero fill: every
//    output row is written exactly once, by one of the three kernels.
//  * No atomics: every output element is written by one thread, and every
//    sum is taken in the same order on every run (deterministic).
//  * Keys outside [0, R] trip a device-side assert (the sorted keys put them
//    in the first or the last chunk); writes stay guarded so that a build
//    without asserts cannot write outside out.

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kChunk = 64;   // sorted entries per warp
constexpr int kUnroll = 4;   // upd rows loaded ahead
constexpr unsigned kFull = 0xffffffffu;

// 16 bytes of upd per lane: 4 f32 or 8 bf16 values, widened to f32.
struct F32x4 {
  static constexpr int kN = 4;
  __device__ static void load(const void* p, bool live, float (&v)[kN]) {
    const float4 r = live ? __ldg(static_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
};

struct Bf16x8 {
  static constexpr int kN = 8;
  __device__ static void load(const void* p, bool live, float (&v)[kN]) {
    const uint4 r = live ? __ldg(static_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // little endian: element 2i is the low half
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <int N>
__device__ __forceinline__ void store_vec(float* __restrict__ dst, const float (&acc)[N]) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    d[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
}

template <typename V>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
segsum_chunks(const int* __restrict__ keys, const int* __restrict__ perm,
              const char* __restrict__ upd, int elem_bytes, float* __restrict__ out,
              float* __restrict__ head, float* __restrict__ tail, int M, int R, int C) {
  constexpr int N = V::kN;
  const int lane = threadIdx.x & (kWarp - 1);
  const int c = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int start = c * kChunk;
  if (start >= M) return;  // warp-uniform
  const int end = min(start + kChunk, M);
  const int col = (blockIdx.y * kWarp + lane) * N;  // this lane's first column
  const bool live_col = col < C;                     // C is a multiple of N

  const int first_key = __ldg(keys + start);
  if (lane == 0 && start == 0) assert(first_key >= 0);
  if (lane == 0 && end == M) assert(__ldg(keys + M - 1) <= R);
  const bool first_from_before = start > 0 && __ldg(keys + start - 1) == first_key;
  const bool last_to_after = end < M && __ldg(keys + end) == __ldg(keys + end - 1);

  float acc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.f;
  int cur = first_key;
  bool first_seg = true;

  // the segment of key `cur` ended; last_seg: it ends at the chunk's end
  auto flush = [&](bool last_seg) {
    if (!live_col) return;
    const bool from_before = first_seg && first_from_before;
    const bool to_after = last_seg && last_to_after;
    if (from_before || to_after) {
      store_vec<N>((from_before ? head : tail) + static_cast<size_t>(c) * C + col, acc);
    } else if (cur >= 0 && cur < R) {
      store_vec<N>(out + static_cast<size_t>(cur) * C + col, acc);
    }
  };

  const size_t row_bytes = static_cast<size_t>(C) * elem_bytes;
  const size_t col_bytes = static_cast<size_t>(col) * elem_bytes;
  for (int base = start; base < end; base += kWarp) {
    const int n = min(kWarp, end - base);
    const int k_l = lane < n ? __ldg(keys + base + lane) : 0;
    const int s_l = lane < n ? (perm ? __ldg(perm + base + lane) : base + lane) : 0;
    for (int j0 = 0; j0 < n; j0 += kUnroll) {
      int kk[kUnroll];
      float v[kUnroll][N];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jj = j0 + u;
        kk[u] = __shfl_sync(kFull, k_l, jj & (kWarp - 1));
        const int src = __shfl_sync(kFull, s_l, jj & (kWarp - 1));
        V::load(upd + static_cast<size_t>(src) * row_bytes + col_bytes, jj < n && live_col, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j0 + u >= n) break;
        if (kk[u] != cur) {  // warp-uniform: every lane sees the same key
          flush(false);
          first_seg = false;
          cur = kk[u];
#pragma unroll
          for (int j = 0; j < N; ++j) acc[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < N; ++j) acc[j] += v[u][j];
      }
    }
  }
  flush(true);
}

// Rows that cross chunk boundaries: the chunk where such a row ends sums
// tail[first chunk] + head[every later chunk up to its own], in order.
template <int N>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
segsum_fixup(const int* __restrict__ keys, const float* __restrict__ head,
             const float* __restrict__ tail, float* __restrict__ out, int M, int R, int C) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int c = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int start = c * kChunk;
  if (start >= M || start == 0) return;
  const int end = min(start + kChunk, M);
  const int key = __ldg(keys + start);
  if (__ldg(keys + start - 1) != key) return;       // row starts in this chunk
  if (end < M && __ldg(keys + end) == key) return;  // row goes on past this chunk
  if (key < 0 || key >= R) return;                  // trash bin (or a bad key)
  const int col = (blockIdx.y * kWarp + lane) * N;
  if (col >= C) return;
  int c0 = c - 1;  // the chunk where the row starts
  while (c0 > 0 && __ldg(keys + c0 * kChunk - 1) == key) --c0;
  float acc[N];
  const float4* t = reinterpret_cast<const float4*>(tail + static_cast<size_t>(c0) * C + col);
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 x = t[i];
    acc[4 * i] = x.x; acc[4 * i + 1] = x.y; acc[4 * i + 2] = x.z; acc[4 * i + 3] = x.w;
  }
  for (int cc = c0 + 1; cc <= c; ++cc) {
    const float4* h = reinterpret_cast<const float4*>(head + static_cast<size_t>(cc) * C + col);
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 x = h[i];
      acc[4 * i] += x.x; acc[4 * i + 1] += x.y; acc[4 * i + 2] += x.z; acc[4 * i + 3] += x.w;
    }
  }
  store_vec<N>(out + static_cast<size_t>(key) * C + col, acc);
}

// Rows with no entry: warp w covers rows [32w, 32w + 32); lane l finds
// whether row 32w + l occurs in the sorted keys; the warp then writes zeros
// to each absent row, C/4 float4 stores per row.
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
  const int C4 = C / 4;
  while (todo) {
    const int b = __ffs(todo) - 1;
    todo &= todo - 1;
    float4* dst = reinterpret_cast<float4*>(out + static_cast<size_t>(r0 + b) * C);
    for (int i = lane; i < C4; i += kWarp) dst[i] = zero;
  }
}

template <typename V>
cudaError_t launch(const int* keys, const int* perm, const char* upd, int elem_bytes, float* out,
                   float* head, float* tail, int M, int R, int C, cudaStream_t stream) {
  constexpr int N = V::kN;
  const int row_warps = (R - 1) / kWarp + 1;
  zero_empty_rows<<<(row_warps + kWarpsPerBlock - 1) / kWarpsPerBlock, kWarp * kWarpsPerBlock, 0,
                    stream>>>(keys, out, M, R, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int chunks = (M + kChunk - 1) / kChunk;
  const dim3 grid((chunks + kWarpsPerBlock - 1) / kWarpsPerBlock, (C + kWarp * N - 1) / (kWarp * N));
  segsum_chunks<V><<<grid, kWarp * kWarpsPerBlock, 0, stream>>>(keys, perm, upd, elem_bytes, out,
                                                               head, tail, M, R, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  segsum_fixup<N><<<grid, kWarp * kWarpsPerBlock, 0, stream>>>(keys, head, tail, out, M, R, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Chunk size the caller sizes `head`/`tail` with: [ceil(M / chunk), C] f32 each.
int rodynrf_segsum_chunk() { return kChunk; }

// keys: sorted [M] int32 in [0, R]; perm: int32 [M] (upd row of entry k) or
// null for upd rows in key order; upd: [*, C] with elem_bytes 2 (bf16) or 4
// (f32), rows 16-byte aligned (C * elem_bytes a multiple of 16); out: [R, C]
// f32, every element written here; head, tail: scratch as above. M >= 1,
// R >= 1. Returns the cudaError_t of the launches (0 on success).
int rodynrf_segsum(const void* keys, const void* perm, const void* upd, int elem_bytes, void* out,
                   void* head, void* tail, int M, int R, int C, void* stream) {
  if (M <= 0 || R <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((elem_bytes != 2 && elem_bytes != 4) || (C * elem_bytes) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* k = static_cast<const int*>(keys);
  const int* p = static_cast<const int*>(perm);
  const char* u = static_cast<const char*>(upd);
  float* o = static_cast<float*>(out);
  float* h = static_cast<float*>(head);
  float* t = static_cast<float*>(tail);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) return static_cast<int>(launch<Bf16x8>(k, p, u, 2, o, h, t, M, R, C, s));
  return static_cast<int>(launch<F32x4>(k, p, u, 4, o, h, t, M, R, C, s));
}

}  // extern "C"
