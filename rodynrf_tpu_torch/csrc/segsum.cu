// Sorted segment row-sum (the merged-layout table gradient), for sm_90a.
//
//   out[r, :] = sum over sorted entries i with keys[i] == r of  upd[perm[i], :]
//   keys [M] int32 ascending in [0, R] (R is a trash bin: those entries are
//   dropped)  ->  out [R, W] f32 or bf16 (f32 sums rounded once)
//
// in two input forms:
//  * upd form: upd [*, W] bf16 or f32 rows, formed by the caller;
//  * factored form: upd[m, (s, k, c)] = w[m, s, k] * ct[m, s, c] with
//    w [M, nS, 4] f32 and ct [M, nS, C] f32, each product formed in
//    registers and rounded to the table dtype exactly as
//    `(w * ct).to(dtype)` rounds it, so the [M, nS*4*C] update is never
//    written to memory (0.53 GB at the merged o0 shape).
//
// Replaces the Pallas TPU kernel rodynrf_tpu/ops/pallas_segsum.py `_kernel`
// (wrapper `sorted_segment_rows_sum`). Same function, another design: the
// TPU kernel gives each 256-row output block to one program and folds its
// update range in with one-hot matmuls; here thousands of warps run at once,
// each over its own chunk of the sorted stream.
//
// Bound: bytes. Read keys (int32) and the inputs once, write out once. At
// the dynamic field's merged o0 shape (M = 276,480, R = 374,745, nS = 3,
// C = 80, bf16 table) the factored form reads 0.28 GB and writes 0.72 GB:
// ~0.30 ms at 3.35 TB/s (o1/o2, C = 20: ~0.06 ms each). Almost all of o0's
// rows are empty (the 270 samples of a ray share one o0 cell): the zero
// fill of the bf16 output is most of the bytes.
//
// Design (csrc/segreduce.cuh): the sort and the launches of
// coalesce.cu. Factored form: a slot is 4 channels of one stride times 4
// corners (a float4 of ct and the stride's float4 of w; 2 or 1 channels
// where C is not a multiple of 4): 15 slots a row at C = 20, so a warp sums
// 2 entries a step; 60 at C = 80, cut into two column tiles of 32 and 28
// lanes, one entry a step.
// Upd form: a slot is 16 bytes of the update row (8 bf16 or 4 f32 values),
// up to 4 slots a lane, wider rows in column tiles.

#include "segreduce.cuh"

extern "C" {

// rows: [M] int32 in [0, R] to sort here, or null with keys: sorted [M]
// int32 in [0, R] and perm: int32 [M] (upd row of entry i) or null for upd
// rows in key order; upd: [*, W] with elem_bytes 2 (bf16) or 4 (f32), rows
// 16-byte aligned (W * elem_bytes a multiple of 16); out: [R, W] f32
// (out_bf16 = 0) or bf16 (1), every element written here; scratch:
// rodynrf_scratch_bytes(M, bits, W) bytes, 256-byte aligned; bits: the key
// bits to sort (rows given); stages: 15 (see segreduce::Call). M >= 1,
// R >= 1. Returns the cudaError_t of the launches (0 on success).
int rodynrf_segsum(const void* rows, const void* keys, const void* perm, const void* upd,
                   int elem_bytes, void* out, int out_bf16, void* scratch,
                   long long scratch_bytes, int bits, int M, int R, int W, int stages,
                   void* stream) {
  using namespace segreduce;
  if (M <= 0 || R <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((elem_bytes != 2 && elem_bytes != 4) || (W * elem_bytes) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Call call{static_cast<const int*>(rows), static_cast<const int*>(keys),
                  static_cast<const int*>(perm), scratch, static_cast<size_t>(scratch_bytes),
                  bits, M, R, R, stages, static_cast<cudaStream_t>(stream)};
  const char* u = static_cast<const char*>(upd);
  if (elem_bytes == 2)
    return static_cast<int>(launch_out(call, Rows<__nv_bfloat16>{u, W}, out, out_bf16));
  return static_cast<int>(launch_out(call, Rows<float>{u, W}, out, out_bf16));
}

// The factored form: w [M, nS, 4] f32, 16-byte aligned, and ct [M, nS, C]
// f32, read V = 4, 2 or 1 floats a slot (segreduce::corner_channels);
// round_bf16: round each product to bf16 (a bf16 table) or keep it f32;
// out [R, nS*4*C] f32 or bf16; scratch: rodynrf_scratch_bytes(M, bits,
// nS*4*C) bytes; the rest as above.
int rodynrf_segsum_factored(const void* rows, const void* keys, const void* perm,
                            const void* w, const void* ct, int nS, int C, int round_bf16,
                            void* out, int out_bf16, void* scratch, long long scratch_bytes,
                            int bits, int M, int R, int stages, void* stream) {
  using namespace segreduce;
  if (M <= 0 || R <= 0 || nS <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Call call{static_cast<const int*>(rows), static_cast<const int*>(keys),
                  static_cast<const int*>(perm), scratch, static_cast<size_t>(scratch_bytes),
                  bits, M, R, R, stages, static_cast<cudaStream_t>(stream)};
  const float* wf = static_cast<const float*>(w);
  const float* cf = static_cast<const float*>(ct);
  return static_cast<int>(round_bf16 ? launch_corners<true>(call, wf, cf, nS, C, out, out_bf16)
                                     : launch_corners<false>(call, wf, cf, nS, C, out, out_bf16));
}

}  // extern "C"
