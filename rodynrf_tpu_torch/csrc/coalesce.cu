// Plane-table gradient of the corner-packed sampler, for sm_90a.
//
//   grad[r, k*C + c] = sum over m with rows[m] == r of  w4[m, k] * ct[m, c]
//   rows [M] int32 in [0, R), w4 [M, 4] f32, ct [M, C] f32
//     ->  grad [R, 4C] f32 or bf16 (the f32 sum rounded once)
//
// Replaces the Pallas TPU kernel rodynrf_tpu/ops/coalesced.py
// `_coalesce_kernel` (wrapper `_coalesce_pallas`). Same function, another
// design: the TPU kernel walks the sorted stream chunk by chunk on one core
// and turns each output block into a one-hot matmul; here thousands of warps
// run at once, each over its own chunk of the sorted stream.
//
// Bound: bytes. Each input is read once and each output row written once:
// at the dynamic field's o0 shape (M = 829,440, R = 161,215, C = 80, f32
// out) about 0.28 GB read and 0.21 GB written, ~0.15 ms at 3.35 TB/s; at the
// static field's o1 shape (M = 276,480, R = 73,372, C = 16, bf16 out) 33 MB,
// ~0.01 ms. There is no arithmetic to speak of (one product and one add per
// input element and corner).
//
// Design (csrc/segreduce.cuh): the caller sorts the rows with the
// bit-limited radix sort there (int32 permutation), and the walk reads w4
// and ct through the permutation, so neither a permuted copy nor the
// [M, 4C] outer product is ever written. A slot is 4 channels (one float4
// of ct) times 4 corners; a row takes L = C/4 lanes, so a warp sums
// 32 / L entries at a time (8 at C = 16, 1 at C = 80) and reduces equal
// rows across them with a segmented shuffle scan. Rows no sample reaches
// are zeroed by the other blocks of the walk's launch, rows that cross warp
// chunks are summed by the fixup; no atomics, deterministic.

#include "segreduce.cuh"

extern "C" {

// rows: [M] int32 in [0, R) to sort here, or null with keys: sorted rows
// [M] int32 and perm: int32 [M] with keys[i] == rows[perm[i]]; w4: [M, 4]
// f32 (16-byte aligned rows); ct: [M, C] f32 with C / V <= 32 for the
// widest V in {4, 2, 1} floats that divides C and the pointer's alignment
// (so C <= 128 when C % 4 == 0); out: [R, 4C] f32 (out_bf16 = 0) or bf16
// (1), every element written here; scratch: rodynrf_scratch_bytes(M, bits,
// 4C) bytes, 256-byte aligned; bits: the key bits to sort (rows given);
// stages: 15 (see segreduce::Call). M >= 1, R >= 1. Returns the
// cudaError_t of the launches (0 on success).
int rodynrf_coalesce_table_grad(const void* rows, const void* keys, const void* perm,
                                const void* w4, const void* ct, void* out, int out_bf16,
                                void* scratch, long long scratch_bytes, int bits, int M, int R,
                                int C, int stages, void* stream) {
  using namespace segreduce;
  if (M <= 0 || R <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (C / corner_channels(ct, C) > kWarp)
    return static_cast<int>(cudaErrorInvalidValue);  // a row of more than 32 slots
  const Call call{static_cast<const int*>(rows), static_cast<const int*>(keys),
                  static_cast<const int*>(perm), scratch, static_cast<size_t>(scratch_bytes),
                  bits, M, R, R - 1, stages, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch_corners<false>(call, static_cast<const float*>(w4),
                                                static_cast<const float*>(ct), 1, C, out,
                                                out_bf16));
}

}  // extern "C"
