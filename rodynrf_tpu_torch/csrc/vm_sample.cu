// Forward of the fused VM sampler in one launch, for sm_90a.
//
//   out_g[n, si*P_g + B_{o,g} + c'] = plane_{o,si}(xyz[n]) * line_{o,si}(xyz[n])
//
// for every grid g of a pack, orientation o, stride si and channel c' of
// grid g in orientation o: the features of ops/fused_vm.py
// `sample_vm_fused`, stride-major then orientation, one contiguous
// [N, F_g] f32 tensor per grid. Both table layouts of ops/fused_vm.py: the
// merged one (one row per joint multiscale cell, seg = sum_s (i_s + 1) per
// axis) and the strided one (one row per stride, at the stride's row
// offset); bf16 or f32 tables.
//
// Replaces no TPU kernel: the JAX package's `sample_vm_fused` is XLA. It was
// added for the calls that need no gradient (rendering, evaluation, the
// train step's detached static passes), where the autograd path's forward
// writes and reads back its intermediates: the gathered [M, nS*4*C] rows, a
// float32 copy of each corner, the weighted sums, an f32 copy of each line
// table and the per-grid concatenation, ~137 KB a sample at the 640^3
// dynamic field.
//
// Bound: bytes. Each sample reads its xyz, its plane row(s) (all of a
// merged row's strides; four corners of C channels a stride), two line taps
// per orientation and stride, and writes its features once: at the 640^3
// dynamic field (merged, bf16, C = 80 / 20 / 20) 2,880 B of rows, 1,440 B of
// taps and 1,440 B out, ~5.8 KB a sample against ~137 KB on the autograd
// path. Counted so, as if no two samples shared a row, the bytes overstate
// what device memory serves: a render chunk's neighbouring samples share
// rows, which L2 serves, and the least bytes read each row the chunk
// touches once (PERF.md §6.0). There is no arithmetic to speak of (~10
// flops an output channel).
//
// Design: one thread computes V neighbouring channels of one orientation of
// one sample, for every stride: it reads the sample's xyz, computes the
// rows and corner weights of every stride, then per stride loads the four
// corners and the two line taps (V * element bytes each: 8 B at V = 4 bf16,
// up to 16 B) and stores V floats. Neighbouring threads take neighbouring
// channel groups of the same row, so each corner load of a warp covers a
// contiguous run of the row. A block holds whole samples (`tile` of them);
// the line tables (tens of KB) stay in L1/L2 through the read-only path.
// Nothing else reaches device memory: no corner block, no f32 copy, no
// concatenation.
//
// Bit for bit with the autograd path's forward: the same operations in the
// same order, each rounded once (__fadd_rn / __fmul_rn are never contracted
// into an FMA): g = ((u + 1) * 0.5) * (n - 1), floor, ((1 - wy)(1 - wx))
// * valid, ((v0 w0 + v1 w1) + v2 w2) + v3 w3, the line lerp (bf16 hat
// weights rounded to nearest even), then the product.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxStrides = 8;
constexpr int kMaxGrids = 4;

}  // namespace

// The pack's static layout (ops/vm_sample.py `VmArgs` mirrors it field for
// field: pointers, then 64-bit, then 32-bit integers).
struct VmArgs {
  const void* tables[3];                 // [R_o, nS*4*Cp_o] merged, [R_o, 4*Cp_o] strided
  const void* lines[3][kMaxStrides];     // [Ls_{o,si}, Cp_o]
  float* out[kMaxGrids];                 // [N, F_g]
  const float* xyz;                      // [N, 3] with row stride xyz_stride
  long long n;                           // samples
  long long xyz_stride;                  // elements between rows of xyz
  int merged, bf16, n_strides, n_grids;
  int vec;                               // V: channels a thread, divides every C_{g,o}
  int units;                             // threads a sample: sum_o Cp_o / V
  int unit_start[4];                     // first unit of each orientation
  int cp[3];                             // Cp_o = sum_g C_{g,o}
  int dims[3][kMaxStrides][2];           // (Hs, Ws)
  int line_dims[3][kMaxStrides];         // Ls
  int row_offsets[3][kMaxStrides];       // strided: first row of each stride
  int seg_lx[3];                         // merged: rows per seg_y
  int c0[3][kMaxGrids + 1];              // first channel of grid g in Cp_o
  int col_base[3][kMaxGrids];            // sum_{o' < o} C_{g,o'}
  int pitch[kMaxGrids];                  // P_g = sum_o C_{g,o}; F_g = nS * P_g
};

namespace {

struct Axis {
  int i0;       // floor(g) clamped to [-1, n - 1]
  float w1;     // g - floor(g)
  bool valid;   // floor(g) in [-1, n - 1]
};

// ops/fused_vm.py `_axis_lerp`.
__device__ __forceinline__ Axis axis_lerp(float u, int n) {
  const float g = __fmul_rn(__fmul_rn(__fadd_rn(u, 1.0f), 0.5f), static_cast<float>(n - 1));
  const float i0f = floorf(g);
  const int i0 = static_cast<int>(i0f);  // saturating, as torch's cast on the card
  Axis a;
  a.w1 = __fsub_rn(g, i0f);
  a.valid = i0 >= -1 && i0 <= n - 1;
  a.i0 = min(max(i0, -1), n - 1);
  return a;
}

__device__ __forceinline__ float clamp01(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, 0.0f), 1.0f);  // torch.clamp keeps a NaN
}

// f32 -> bf16 -> f32, round to nearest even (c10::BFloat16's rounding).
__device__ __forceinline__ float round_bf16(float x) {
  if (isnan(x)) return __uint_as_float(0x7FC00000u);
  const uint32_t u = __float_as_uint(x);
  return __uint_as_float(((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16) << 16);
}

// V consecutive table elements as floats, one load of V * sizeof(T) bytes.
template <int V, bool BF16>
__device__ __forceinline__ void load_vec(const void* base, long long off, float* v) {
  if constexpr (BF16) {
    const uint16_t* p = static_cast<const uint16_t*>(base) + off;
    uint32_t w[(V + 1) / 2];
    if constexpr (V == 8) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
    } else if constexpr (V == 4) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = q.x; w[1] = q.y;
    } else if constexpr (V == 2) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else {
      w[0] = __ldg(p);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const uint32_t h = (j & 1) ? (w[j / 2] >> 16) : (w[j / 2] & 0xFFFFu);
      v[j] = __uint_as_float(h << 16);
    }
  } else {
    const float* p = static_cast<const float*>(base) + off;
    if constexpr (V == 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else if constexpr (V == 2) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(p));
      v[0] = q.x; v[1] = q.y;
    } else {
      v[0] = __ldg(p);
    }
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (V >= 4) {
#pragma unroll
    for (int j = 0; j < V; j += 4)
      *reinterpret_cast<float4*>(p + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

template <int V, bool BF16>
__global__ void __launch_bounds__(256) vm_sample_kernel(const __grid_constant__ VmArgs a,
                                                         int tile) {
  const int t = threadIdx.x;
  const int local = t / a.units;
  if (local >= tile) return;
  const long long n = static_cast<long long>(blockIdx.x) * tile + local;
  if (n >= a.n) return;
  const int u = t - local * a.units;
  const int o = u < a.unit_start[1] ? 0 : (u < a.unit_start[2] ? 1 : 2);
  const int c = (u - a.unit_start[o]) * V;
  const int cp = a.cp[o];
  const int nS = a.n_strides;

  const float* p = a.xyz + n * a.xyz_stride;
  // MAT_MODE ((0, 1), (0, 2), (1, 2)) and VEC_MODE (2, 1, 0) of ops/grid_sample.py
  const float xu = p[o == 2 ? 1 : 0], yu = p[o == 0 ? 1 : 2], zu = p[2 - o];

  int g = 0;
  while (c >= a.c0[o][g + 1]) ++g;
  float* out = a.out[g] + n * (nS * a.pitch[g]) + a.col_base[o][g] + (c - a.c0[o][g]);

  long long row_base = 0;  // merged: the sample's one row, in elements
  if (a.merged) {
    int seg_x = 0, seg_y = 0;
    for (int si = 0; si < nS; ++si) {
      seg_x += axis_lerp(xu, a.dims[o][si][1]).i0 + 1;
      seg_y += axis_lerp(yu, a.dims[o][si][0]).i0 + 1;
    }
    const int row = seg_y * a.seg_lx[o] + seg_x;
    row_base = static_cast<long long>(row) * (nS * 4 * cp);
  }

  for (int si = 0; si < nS; ++si) {
    const int Hs = a.dims[o][si][0], Ws = a.dims[o][si][1];
    const Axis ax = axis_lerp(xu, Ws), ay = axis_lerp(yu, Hs);
    long long base;
    if (a.merged) {
      base = row_base + static_cast<long long>(si) * 4 * cp + c;
    } else {
      const int row = (ay.i0 + 1) * (Ws + 1) + (ax.i0 + 1) + a.row_offsets[o][si];
      base = static_cast<long long>(row) * (4 * cp) + c;
    }
    float v0[V], v1[V], v2[V], v3[V];
    load_vec<V, BF16>(a.tables[o], base, v0);
    load_vec<V, BF16>(a.tables[o], base + cp, v1);
    load_vec<V, BF16>(a.tables[o], base + 2 * cp, v2);
    load_vec<V, BF16>(a.tables[o], base + 3 * cp, v3);

    // ops/fused_vm.py `_line_feats`
    const int Ls = a.line_dims[o][si];
    const float gl = __fmul_rn(__fmul_rn(__fadd_rn(zu, 1.0f), 0.5f), static_cast<float>(Ls - 1));
    const float i0f = floorf(gl);
    const long long i0 = static_cast<long long>(i0f);  // saturating, as torch's int64 cast
    const long long i1 = static_cast<long long>(static_cast<unsigned long long>(i0) + 1ull);
    const float ib0 = (i0 >= 0 && i0 <= Ls - 1) ? 1.0f : 0.0f;
    const float ib1 = (i1 >= 0 && i1 <= Ls - 1) ? 1.0f : 0.0f;
    const long long r0 = min(max(i0, 0LL), static_cast<long long>(Ls - 1));
    const long long r1 = min(max(i1, 0LL), static_cast<long long>(Ls - 1));
    float t0[V], t1[V];
    load_vec<V, BF16>(a.lines[o][si], r0 * cp + c, t0);
    load_vec<V, BF16>(a.lines[o][si], r1 * cp + c, t1);
    float lw0, lw1;
    if constexpr (BF16) {
      lw0 = round_bf16(clamp01(__fsub_rn(1.0f, fabsf(__fsub_rn(i0f, gl)))));
      lw1 = round_bf16(clamp01(__fsub_rn(1.0f, fabsf(__fsub_rn(__fadd_rn(i0f, 1.0f), gl)))));
    } else {
      lw1 = __fsub_rn(gl, i0f);
      lw0 = __fsub_rn(1.0f, lw1);
    }

    // ops/fused_vm.py `_corner_weights`
    const float valid = (ax.valid && ay.valid) ? 1.0f : 0.0f;
    const float ox = __fsub_rn(1.0f, ax.w1), oy = __fsub_rn(1.0f, ay.w1);
    const float w0 = __fmul_rn(__fmul_rn(oy, ox), valid);
    const float w1 = __fmul_rn(__fmul_rn(oy, ax.w1), valid);
    const float w2 = __fmul_rn(__fmul_rn(ay.w1, ox), valid);
    const float w3 = __fmul_rn(__fmul_rn(ay.w1, ax.w1), valid);

    float r[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float f = __fadd_rn(__fmul_rn(v0[j], w0), __fmul_rn(v1[j], w1));
      f = __fadd_rn(f, __fmul_rn(v2[j], w2));
      f = __fadd_rn(f, __fmul_rn(v3[j], w3));
      const float line = __fadd_rn(__fmul_rn(__fmul_rn(t0[j], ib0), lw0),
                                   __fmul_rn(__fmul_rn(t1[j], ib1), lw1));
      r[j] = __fmul_rn(f, line);
    }
    store_vec<V>(out + si * a.pitch[g], r);
  }
}

template <int V, bool BF16>
cudaError_t launch(const VmArgs& a, int tile, int block, cudaStream_t stream) {
  const long long blocks = (a.n + tile - 1) / tile;
  vm_sample_kernel<V, BF16><<<static_cast<unsigned>(blocks), block, 0, stream>>>(a, tile);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// args: the layout, n >= 1, every pointer aligned to V * element bytes (the
// out rows to V floats); tile samples a block, block >= tile * units
// threads (a multiple of 32, at most 256). Returns the cudaError_t of the
// launch (0 on success).
int rodynrf_vm_sample(const VmArgs* args, int tile, int block, void* stream) {
  const VmArgs& a = *args;
  if (a.n <= 0 || tile <= 0 || block > 256 || block < tile * a.units ||
      a.n_strides < 1 || a.n_strides > kMaxStrides || a.n_grids < 1 || a.n_grids > kMaxGrids)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((a.n + tile - 1) / tile > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.bf16) {
    switch (a.vec) {
      case 8: return static_cast<int>(launch<8, true>(a, tile, block, s));
      case 4: return static_cast<int>(launch<4, true>(a, tile, block, s));
      case 2: return static_cast<int>(launch<2, true>(a, tile, block, s));
      case 1: return static_cast<int>(launch<1, true>(a, tile, block, s));
    }
  } else {
    switch (a.vec) {
      case 4: return static_cast<int>(launch<4, false>(a, tile, block, s));
      case 2: return static_cast<int>(launch<2, false>(a, tile, block, s));
      case 1: return static_cast<int>(launch<1, false>(a, tile, block, s));
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// sizeof(VmArgs), for the wrapper's check of its mirror.
int rodynrf_vm_sample_args_bytes() { return static_cast<int>(sizeof(VmArgs)); }

}  // extern "C"
