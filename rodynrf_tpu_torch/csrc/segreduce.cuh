// Shared pieces of the two table-gradient kernels (csrc/coalesce.cu and
// csrc/segsum.cu), for sm_90a:
//
//  * `sort_rows`: the stable sort of the row ids, CUB's radix sort over
//    only the low `bits` bits the ids need (17-19 at the 300^3 grid, not
//    32), with an int32 iota as the values, so the permutation comes out
//    as int32 and no int64 pass or cast is made.
//  * `launch`: the sorted segmented row reduction
//        out[r, :] = sum over sorted entries i with keys[i] == r of
//                    contribution(perm[i], :)
//    in f32, stored once in the output type (f32 or bf16, round to nearest
//    even, as `.to(torch.bfloat16)` rounds). A `Form` says how an entry's
//    contribution is read: `Corners` forms w[m, s, k] * ct[m, s, c] in
//    registers from the factored cotangent (kernel 1, and kernel 2's
//    factored form), `Rows` reads a formed update row (kernel 2's upd
//    form). Two launches after the sort: one whose blocks either zero the
//    rows no entry reaches or walk the sorted entries (so the zero fill's
//    writes overlap the walk's gathers), and the fixup that adds up the
//    rows that cross chunks.
//
// What bounds it: bytes in the limit. At the train step's shapes the walk
// is held by the warp steps it takes (entries / E, times the column tiles)
// and their instructions more than by memory latency: a deeper ring of
// prefetched inputs did not make it faster (PERF.md §6.4). Each lane copies
// the next step's inputs into a ring in shared memory with cp.async while
// it sums the current one, so no registers wait on loads in flight.
//
// Layout of the walk. A row of the output is cut into slots (up to 4
// channels x 4 corners of one stride, or 16 bytes of an update row), one
// slot a lane. `L` lanes cover one entry's slots (rows of more than 32
// slots are cut into column tiles, one tile a block row), so a warp takes
// E = 32 / L consecutive sorted entries a step: 8 at C = 16 (kernel 1's
// narrow static shapes), 1 at C = 80. With E > 1 the warp sums equal keys
// across its E lane groups with a segmented inclusive scan (shuffles up by
// L, 2L, 4L lanes: a fixed tree, so the order is the same on every run),
// carries a segment that goes on into the next step in registers, and the
// lane group where a segment ends stores it. With E = 1 the warp walks its
// entries in order, accumulating the open segment in place.
//
// Load balance over entries, not rows: all 270 samples of a ray can land
// on one row, so a row can hold hundreds of entries. Warp c owns the chunk
// of sorted entries [c * kChunk, (c + 1) * kChunk) and stages their keys and
// sources in shared memory. A row whose entries lie inside one chunk is
// written straight to the output; a row that crosses chunk boundaries
// leaves one f32 partial per chunk (`tail[c]` where it starts, `head[c]` in
// every later chunk), and the fixup kernel lets the chunk where it ends add
// them in chunk order. Rows no entry reaches: each zero warp takes 32 rows,
// each lane looks its row up in the sorted keys (binary search), and the
// warp zeroes the rows found absent, spread over all its lanes. So every
// output element is written exactly once, by one thread, and no atomics
// are used: two launches give bit-identical results.
//
// Keys must lie in [0, key_hi] (key_hi = R - 1, or R where R is a trash
// bin whose entries are dropped). The bit-limited sort does not order keys
// outside [0, 2^bits), so the walk checks every key it reads with a
// device-side assert, as index_add_ does on the card; its writes stay
// guarded so that a build without asserts cannot write outside the output.

#pragma once

#include <assert.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/device/device_radix_sort.cuh>

namespace segreduce {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kChunk = 64;  // sorted entries per warp
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// stores: f32 values, rounded once to the output type
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) { *p = __float2bfloat16_rn(a); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);  // a at the lower address
}
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// N consecutive values at p (p aligned to N elements' width, up to 16 bytes)
template <int N, typename T>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) store4(p + i, v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (N == 2) {
    store2(p, v[0], v[1]);
  } else {
    static_assert(N == 1, "N is 1, 2 or a multiple of 4");
    store1(p, v[0]);
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---------------------------------------------------------------------------
// asynchronous copies global -> shared (sm_80+): N bytes, zeros if !live
// (then nothing is read)
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool live) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = live ? N : 0;
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(gmem),
                 "n"(N), "r"(src_bytes) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {  // at most N groups still in flight
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// forms: what one sorted entry adds to one slot of its row
// ---------------------------------------------------------------------------

// out[r, s*4C + k*C + c] += w[m, s, k] * ct[m, s, c]: the corner outer product
// from the factored cotangent, formed in registers (never as [M, nS*4*C] in
// memory). A slot is V channels of one stride and all 4 corners: 4V values.
// Each product is rounded to f32 (and with kRound to bf16, as
// `(w * ct).to(torch.bfloat16)` rounds it), then summed in f32.
// w: [*, nS, 4] f32 (16-byte rows), ct: [*, nS, C] f32, C % V == 0.
template <int V, bool kRound>
struct Corners {
  static constexpr int kVals = 4 * V;
  struct alignas(16) Raw {
    float4 w;
    float c[V];
  };
  const float* w;
  const float* ct;
  int nS, C, CG;  // CG = C / V slots per stride

  __host__ __device__ int slots() const { return nS * CG; }
  __host__ __device__ int width() const { return nS * 4 * C; }

  // copy the entry's inputs for `slot` into dst (shared memory),
  // asynchronously; zeros where !live
  __device__ __forceinline__ void issue(int src, int slot, bool live, Raw* dst) const {
    const int s = slot / CG, g = slot - s * CG;
    const size_t ms = live ? static_cast<size_t>(src) * nS + s : 0;
    cp_async<16>(&dst->w, reinterpret_cast<const float4*>(w) + ms, live);
    cp_async<4 * V>(dst->c, ct + ms * C + g * V, live);
  }

  __device__ __forceinline__ void expand(const Raw& r, float (&v)[kVals]) const {
    const float wk[4] = {r.w.x, r.w.y, r.w.z, r.w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        // no FMA contraction: the plain version's product, then its sum
        const float t = __fmul_rn(wk[k], r.c[i]);
        v[k * V + i] = kRound ? round_bf16(t) : t;
      }
    }
  }

  template <typename T>
  __device__ __forceinline__ void store(T* row, int slot, const float (&v)[kVals]) const {
    const int s = slot / CG, g = slot - s * CG;
    T* p = row + s * 4 * C + g * V;
#pragma unroll
    for (int k = 0; k < 4; ++k) store_vec<V>(p + k * C, v + k * V);
  }
};

// out[r, :] += upd[m, :]: a formed update row of `W` values of type In
// (bf16 or f32) read 16 bytes a slot and widened to f32 exactly.
template <typename In>
struct Rows {
  static constexpr int kVals = 16 / sizeof(In);
  struct alignas(16) Raw {
    uint4 u;
  };
  const char* upd;
  int W;

  __host__ __device__ int slots() const { return W / kVals; }
  __host__ __device__ int width() const { return W; }

  __device__ __forceinline__ void issue(int src, int slot, bool live, Raw* dst) const {
    const size_t off = live ? (static_cast<size_t>(src) * W + slot * kVals) * sizeof(In) : 0;
    cp_async<16>(&dst->u, upd + off, live);
  }

  __device__ __forceinline__ void expand(const Raw& r, float (&v)[kVals]) const {
    const unsigned w[4] = {r.u.x, r.u.y, r.u.z, r.u.w};
    if constexpr (sizeof(In) == 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = __uint_as_float(w[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // little endian: element 2i is the low half
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }

  template <typename T>
  __device__ __forceinline__ void store(T* row, int slot, const float (&v)[kVals]) const {
    store_vec<kVals>(row + slot * kVals, v);
  }
};

// ---------------------------------------------------------------------------
// the launches: zero fill and chunk walk, fixup
// ---------------------------------------------------------------------------

constexpr int kStages = 2;  // steps' inputs in flight per lane (the cp.async ring)

struct Layout {
  int L;      // lanes per entry
  int E;      // entries per warp step: 32 / L
  int tiles;  // column tiles of L slots (blockIdx.y)
};

// One slot a lane; a row of more than 32 slots is cut into column tiles.
inline Layout choose_layout(int T) {
  const int L = T < kWarp ? T : kWarp;
  return {L, kWarp / L, (T + L - 1) / L};
}

template <class F>
constexpr size_t walk_smem_bytes() {
  return kWarpsPerBlock * (kStages * kWarp * sizeof(typename F::Raw) + 2 * sizeof(int) * kChunk);
}

// Where a finished segment of `key` goes: the chunk's first segment, if the
// row began in an earlier chunk, to head[c]; its last, if the row goes on,
// to tail[c]; any other to its output row (dropped for the trash bin R).
template <class F, typename OutT, int K>
__device__ __forceinline__ void store_segment(const F& form, const float (&x)[K], int key,
                                              bool from_before, bool to_after, int c, int W,
                                              int R, OutT* out, float* head, float* tail,
                                              int slot, bool slot_ok) {
  if (!slot_ok) return;
  if (from_before || to_after) {
    form.store((from_before ? head : tail) + static_cast<size_t>(c) * W, slot, x);
  } else if (key >= 0 && key < R) {
    form.store(out + static_cast<size_t>(key) * W, slot, x);
  }
}

// Rows with no entry: warp w covers rows [32w, 32w + 32); lane l finds
// whether row 32w + l occurs in the sorted keys (binary search); the warp
// then zeroes the absent rows, its lanes spread over all of them (16- or
// 8-byte stores).
template <typename OutT>
__device__ __forceinline__ void zero_empty_rows(const int* __restrict__ keys,
                                                OutT* __restrict__ out, int M, int R, int W,
                                                int w, int lane) {
  const int r0 = w * kWarp;
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
  const unsigned todo = __ballot_sync(kFull, empty);
  if (!todo) return;
  const size_t row_bytes = static_cast<size_t>(W) * sizeof(OutT);  // a multiple of 8
  char* base = reinterpret_cast<char*>(out) + static_cast<size_t>(r0) * row_bytes;
  if (row_bytes % 16 == 0) {
    const int per_row = static_cast<int>(row_bytes / 16);
    for (int q = lane; q < kWarp * per_row; q += kWarp)
      if (todo >> (q / per_row) & 1u)
        reinterpret_cast<uint4*>(base)[q] = make_uint4(0u, 0u, 0u, 0u);
  } else {
    const int per_row = static_cast<int>(row_bytes / 8);
    for (int q = lane; q < kWarp * per_row; q += kWarp)
      if (todo >> (q / per_row) & 1u) reinterpret_cast<uint2*>(base)[q] = make_uint2(0u, 0u);
  }
}

// The zero fill and the chunk walk in one launch: of the grid's first
// dimension, `walk_blocks` blocks spread evenly among the rest walk chunks
// (8 warps a block, one chunk a warp), the others zero rows (256 a block).
// kScan = false: E == 1, the warp walks its chunk in order; kScan = true:
// E > 1 entries a step, summed by the segmented scan.
template <class F, typename OutT, bool kScan>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock, 3)
zero_and_walk(const int* __restrict__ keys, const int* __restrict__ perm, const F form,
              OutT* __restrict__ out, float* __restrict__ head, float* __restrict__ tail, int M,
              int R, int key_hi, int L, int E, int walk_blocks, int zero_stage,
              int walk_stage) {
  using Raw = typename F::Raw;
  constexpr int K = F::kVals;
  constexpr int kEnd = -2;  // "no next entry in this chunk": never a legal key
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int W = form.width();
  const long long b = blockIdx.x, total = gridDim.x;
  const int walks_before = static_cast<int>(b * walk_blocks / total);
  if (static_cast<int>((b + 1) * walk_blocks / total) == walks_before) {  // a zero block
    if (zero_stage && blockIdx.y == 0)
      zero_empty_rows(keys, out, M, R, W,
                      (static_cast<int>(b) - walks_before) * kWarpsPerBlock + warp, lane);
    return;
  }
  if (!walk_stage) return;
  const int c = walks_before * kWarpsPerBlock + warp;
  const int start = c * kChunk;
  if (start >= M) return;  // warp-uniform
  const int n_ent = min(kChunk, M - start);
  const int end = start + n_ent;

  // this warp's shared memory: the ring of inputs (kStages x 32 lanes),
  // then the chunk's keys and sources
  Raw* ring = reinterpret_cast<Raw*>(smem) + warp * kStages * kWarp;
  int* sk = reinterpret_cast<int*>(reinterpret_cast<Raw*>(smem) +
                                   kWarpsPerBlock * kStages * kWarp) + warp * 2 * kChunk;
  int* sp = sk + kChunk;
  for (int i = lane; i < n_ent; i += kWarp) {
    const int k = __ldg(keys + start + i);
    assert(k >= 0 && k <= key_hi);
    sk[i] = k;
    sp[i] = perm ? __ldg(perm + start + i) : start + i;
  }
  __syncwarp();

  const int e = kScan ? lane / L : 0, g = lane - e * L;  // entry group, lane within it
  const int E_ = kScan ? E : 1;
  const int slot = blockIdx.y * L + g;
  const bool slot_ok = (kScan ? e < E : lane < L) && slot < form.slots();
  const int first_key = sk[0];
  const bool first_from_before = start > 0 && __ldg(keys + start - 1) == first_key;
  const bool last_to_after = end < M && __ldg(keys + end) == sk[n_ent - 1];
  const int n_steps = (n_ent + E_ - 1) / E_;

  // step t's inputs into ring slot t % kStages: one commit group a step
  auto issue = [&](int t) {
    const int idx = t * E_ + e;
    const bool live = slot_ok && t < n_steps && idx < n_ent;
    form.issue(live ? sp[idx] : 0, slot, live, ring + (t % kStages) * kWarp + lane);
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);

  float acc[K];  // kScan: the segment carried into the next step; else the open one
#pragma unroll
  for (int q = 0; q < K; ++q) acc[q] = 0.f;
  int cur = kEnd;  // warp-uniform: the key of acc's segment

  for (int t = 0; t < n_steps; ++t) {
    issue(t + kStages - 1);
    cp_async_wait<kStages - 1>();  // step t's group has landed (each lane reads its own)
    const Raw r = ring[(t % kStages) * kWarp + lane];
    float x[K];
    form.expand(r, x);
    if constexpr (!kScan) {
      const int k = sk[t];
      if (k != cur) {  // warp-uniform: the open segment ends
        if (cur != kEnd)
          store_segment(form, acc, cur, first_from_before && cur == first_key, false, c, W, R,
                        out, head, tail, slot, slot_ok);
        cur = k;
#pragma unroll
        for (int q = 0; q < K; ++q) acc[q] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < K; ++q) acc[q] += x[q];
    } else {
      const int sb = t * E;
      const int n = min(E, n_ent - sb);
      const int idx = sb + e;
      const bool live = e < n && lane < E * L;
      const int key = live ? sk[idx] : kEnd;
      // segmented inclusive scan over the step's entries (equal keys are
      // adjacent: the keys are sorted)
      for (int d = 1; d < n; d <<= 1) {
        const int kd = __shfl_up_sync(kFull, key, d * L);
        const bool take = live && e >= d && kd == key;
#pragma unroll
        for (int q = 0; q < K; ++q) {
          const float y = __shfl_up_sync(kFull, x[q], d * L);
          if (take) x[q] += y;
        }
      }
      if (live && key == cur) {  // the segment carried from the last step
#pragma unroll
        for (int q = 0; q < K; ++q) x[q] += acc[q];
      }
      // the lane group where a segment ends stores it
      const int k_next = idx + 1 < n_ent ? sk[idx + 1] : kEnd;
      if (live && k_next != key)
        store_segment(form, x, key, first_from_before && key == first_key,
                      idx + 1 == n_ent && last_to_after, c, W, R, out, head, tail, slot,
                      slot_ok);
      // the step's last segment goes on into the next step: carry it
      const int last = sb + n - 1;
      cur = last + 1 < n_ent && sk[last + 1] == sk[last] ? sk[last] : kEnd;
      if (cur != kEnd) {
#pragma unroll
        for (int q = 0; q < K; ++q) acc[q] = __shfl_sync(kFull, x[q], (n - 1) * L + g);
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (!kScan) {  // the chunk's last segment
    store_segment(form, acc, cur, first_from_before && cur == first_key, last_to_after, c, W, R,
                  out, head, tail, slot, slot_ok);
  }
}

// Rows that cross chunk boundaries: the chunk where such a row ends sums
// tail[first chunk] + head[every later chunk up to its own], in order.
template <typename OutT>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
fixup(const int* __restrict__ keys, const float* __restrict__ head,
      const float* __restrict__ tail, OutT* __restrict__ out, int M, int R, int W) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int c = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int start = c * kChunk;
  if (start >= M || start == 0) return;
  const int end = min(start + kChunk, M);
  const int key = __ldg(keys + start);
  if (__ldg(keys + start - 1) != key) return;       // row starts in this chunk
  if (end < M && __ldg(keys + end) == key) return;  // row goes on past this chunk
  if (key < 0 || key >= R) return;                  // trash bin (or a bad key)
  int c0 = c - 1;  // the chunk where the row starts
  while (c0 > 0 && __ldg(keys + c0 * kChunk - 1) == key) --c0;
  const float4* t = reinterpret_cast<const float4*>(tail + static_cast<size_t>(c0) * W);
  for (int q = lane; q < W / 4; q += kWarp) {
    float4 a = t[q];
    for (int cc = c0 + 1; cc <= c; ++cc) {
      const float4 h = reinterpret_cast<const float4*>(head + static_cast<size_t>(cc) * W)[q];
      a.x += h.x; a.y += h.y; a.z += h.z; a.w += h.w;
    }
    store4(out + static_cast<size_t>(key) * W + 4 * q, a.x, a.y, a.z, a.w);
  }
}

// ---------------------------------------------------------------------------
// the sort
// ---------------------------------------------------------------------------

__global__ void iota(int* __restrict__ v, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) v[i] = i;
}

// Scratch bytes CUB's radix sort of M (key, int32) pairs over `bits` bits needs.
inline cudaError_t sort_temp_bytes(int M, int bits, size_t* bytes) {
  return cub::DeviceRadixSort::SortPairs(
      nullptr, *bytes, static_cast<const unsigned*>(nullptr), static_cast<unsigned*>(nullptr),
      static_cast<const int*>(nullptr), static_cast<int*>(nullptr), M, 0, bits);
}

// Stable sort of rows [M] int32 by their low `bits` bits into keys, with
// perm[i] the position of keys[i] in rows (int32); iota [M] int32 scratch.
// Rows outside [0, 2^bits) come out in no defined place: the walk's assert
// catches them.
inline cudaError_t sort_rows(const int* rows, int* keys, int* perm, int* iota_buf, void* temp,
                             size_t temp_bytes, int M, int bits, cudaStream_t stream) {
  const int blocks = (M + 255) / 256 < 4096 ? (M + 255) / 256 : 4096;
  iota<<<blocks, 256, 0, stream>>>(iota_buf, M);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return cub::DeviceRadixSort::SortPairs(
      temp, temp_bytes, reinterpret_cast<const unsigned*>(rows),
      reinterpret_cast<unsigned*>(keys), iota_buf, perm, M, 0, bits, stream);
}

// ---------------------------------------------------------------------------
// one call: the sort (unless sorted keys are given) and the launches,
// all scratch in one buffer the caller allocates
// ---------------------------------------------------------------------------

inline size_t align256(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

struct Scratch {
  int* keys;  // [M] sorted rows
  int* perm;  // [M]
  int* iota;  // [M]
  float* head;  // [ceil(M / kChunk), W] partials
  float* tail;
  void* temp;  // CUB's, the rest of the buffer
  size_t temp_bytes;
};

inline size_t part_bytes(int M, int W) {
  return align256(4 * static_cast<size_t>((M + kChunk - 1) / kChunk) * W);
}

inline size_t fixed_bytes(int M, int W) {
  return 3 * align256(4 * static_cast<size_t>(M)) + 2 * part_bytes(M, W);
}

inline Scratch carve(void* buffer, size_t bytes, int M, int W) {
  char* p = static_cast<char*>(buffer);
  const size_t kb = align256(4 * static_cast<size_t>(M)), pb = part_bytes(M, W);
  Scratch s;
  s.keys = reinterpret_cast<int*>(p);
  s.perm = reinterpret_cast<int*>(p + kb);
  s.iota = reinterpret_cast<int*>(p + 2 * kb);
  s.head = reinterpret_cast<float*>(p + 3 * kb);
  s.tail = reinterpret_cast<float*>(p + 3 * kb + pb);
  s.temp = p + fixed_bytes(M, W);
  s.temp_bytes = bytes - fixed_bytes(M, W);
  return s;
}

struct Call {
  const int* rows;  // unsorted [M] (sorted here), or null with keys given
  const int* keys;  // sorted [M], or null
  const int* perm;  // with keys: the input row of each sorted entry, or null for key order
  void* scratch;    // rodynrf_scratch_bytes(M, bits, W) bytes, 256-byte aligned
  size_t scratch_bytes;
  int bits;         // key bits the sort orders
  int M, R, key_hi;
  int stages;       // bit 3 the sort, bit 0 the zero fill, bit 1 the walk, bit 2 the fixup
  cudaStream_t stream;
};


template <class F, typename OutT>
cudaError_t launch(const Call& call, const F& form, OutT* out) {
  const int W = form.width();
  const Layout lay = choose_layout(form.slots());
  if (call.scratch_bytes < fixed_bytes(call.M, W)) return cudaErrorInvalidValue;
  const Scratch s = carve(call.scratch, call.scratch_bytes, call.M, W);
  const int* keys = call.keys;
  const int* perm = call.perm;
  cudaError_t err = cudaSuccess;
  if (!keys) {
    if (!call.rows || call.bits < 1 || call.bits > 32) return cudaErrorInvalidValue;
    keys = s.keys;
    perm = s.perm;
    if (call.stages & 8)
      err = sort_rows(call.rows, s.keys, s.perm, s.iota, s.temp, s.temp_bytes, call.M,
                      call.bits, call.stream);
    if (err != cudaSuccess) return err;
  }
  const int threads = kWarp * kWarpsPerBlock;
  const int chunks = (call.M + kChunk - 1) / kChunk;
  const int blocks = (chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (call.stages & 3) {
    const int zero_stage = call.stages & 1, walk_stage = (call.stages >> 1) & 1;
    const int row_warps = (call.R - 1) / kWarp + 1;
    const int zero_blocks = zero_stage ? (row_warps + kWarpsPerBlock - 1) / kWarpsPerBlock : 0;
    const int walk_blocks = walk_stage ? blocks : 0;
    const dim3 grid(zero_blocks + walk_blocks, walk_stage ? lay.tiles : 1);
    const size_t smem = walk_smem_bytes<F>();
    auto kernel = lay.E > 1 ? zero_and_walk<F, OutT, true> : zero_and_walk<F, OutT, false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<grid, threads, smem, call.stream>>>(keys, perm, form, out, s.head, s.tail, call.M,
                                                 call.R, call.key_hi, lay.L, lay.E, walk_blocks,
                                                 zero_stage, walk_stage);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (call.stages & 4) {
    fixup<OutT><<<blocks, threads, 0, call.stream>>>(keys, s.head, s.tail, out, call.M, call.R,
                                                     W);
    err = cudaGetLastError();
  }
  return err;
}

template <class F>
cudaError_t launch_out(const Call& call, const F& form, void* out, int out_bf16) {
  if (out_bf16) return launch(call, form, static_cast<__nv_bfloat16*>(out));
  return launch(call, form, static_cast<float*>(out));
}

// Channels a Corners slot takes: the widest of 4, 2, 1 that divides C and
// ct's alignment (one float4, float2 or float of ct a lane).
inline int corner_channels(const void* ct, int C) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(ct);
  if (C % 4 == 0 && a % 16 == 0) return 4;
  return (C % 2 == 0 && a % 8 == 0) ? 2 : 1;
}

// launch_out with the Corners form of V channels a slot
template <bool kRound>
cudaError_t launch_corners(const Call& call, const float* w, const float* ct, int nS, int C,
                           void* out, int out_bf16) {
  switch (corner_channels(ct, C)) {
    case 4: return launch_out(call, Corners<4, kRound>{w, ct, nS, C, C / 4}, out, out_bf16);
    case 2: return launch_out(call, Corners<2, kRound>{w, ct, nS, C, C / 2}, out, out_bf16);
    default: return launch_out(call, Corners<1, kRound>{w, ct, nS, C, C}, out, out_bf16);
  }
}

}  // namespace segreduce

extern "C" {

// Bytes of the one scratch buffer a call with M entries, `bits` sort bits
// (0: sorted keys are given) and rows of W output values needs; -1 on error.
long long rodynrf_scratch_bytes(int M, int bits, int W) {
  size_t temp = 0;
  if (bits > 0 && segreduce::sort_temp_bytes(M, bits, &temp) != cudaSuccess) return -1;
  return static_cast<long long>(segreduce::fixed_bytes(M, W) + temp);
}

// The sort alone: keys, perm, iota [M] int32; temp of
// rodynrf_scratch_bytes(M, bits, 0) - 3 * align256(4M) bytes or more.
int rodynrf_sort_rows(const void* rows, void* keys, void* perm, void* iota, void* temp,
                      long long temp_bytes, int M, int bits, void* stream) {
  if (M <= 0 || bits < 1 || bits > 32) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(segreduce::sort_rows(
      static_cast<const int*>(rows), static_cast<int*>(keys), static_cast<int*>(perm),
      static_cast<int*>(iota), temp, static_cast<size_t>(temp_bytes), M, bits,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
