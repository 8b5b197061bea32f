// Baseline JPEG entropy decode: Huffman DC and AC symbols of every
// entropy-coded segment of a batch of frames into int16 coefficient blocks.
//
// Replaces no TPU kernel: the JAX package decodes its frames on the host
// through PIL (libjpeg-turbo, jdhuff.c decode_mcu), and the port reads the
// same frames on the card (rodynrf_tpu_torch/data/jpeg.py, whose
// `entropy_decode_plain` is this kernel's plain version and
// `entropy_decode_model` the model of its algorithm).
//
// Design: a segment's bits depend on every bit before them, so one thread
// walking a segment is bound by that dependence (one table lookup per
// symbol, over a million symbols in a 1080p frame), not by the bytes it
// moves. The decode is instead the self-synchronising parallel decode of
// csrc/jpeg_huff.cuh in three launches: sync (every subsequence of every
// segment decoded from a guess, then re-decoded from its predecessor's
// exit until no exit changes), scan (each decoder's first block and DC
// predictors), write (each decoder's coefficients). A restart marker only
// starts another segment, whose first decoder starts in a known state. The
// wrapper zeroes the blocks and the status words first; each segment ends
// with 0, or a corrupt code, an AC run past the 64th coefficient, or a
// segment that ends before its last MCU, as the serial walk would leave it.
//
// Inputs (rodynrf_tpu_torch/data/jpeg.py `JpegBatch`):
//   data  uint8, every segment's unstuffed bytes back to back, zero-padded
//         to whole words;
//   seg   int32 [S, 5]: byte offset, byte length, frame, first MCU, MCUs;
//   scan  int32 [F, SCAN_WORDS]: scan components, MCUs per row, then per
//         scan component (plane, h, v, DC slot, AC slot);
//   huff  int32 [F, 8, HUFF_WORDS]: lookahead[512] (length << 8 | symbol),
//         maxcode[18], valoffset[18], symbols[256];
//   plane_block0 int64 [P + 1]; plane int32 [P, 8] (blocks per row first);
//   sub0  int32 [S + 1]: each segment's first subsequence; subseg int32
//         [subsequences]: each subsequence's segment.
// Scratch: rec int32 [3, N, REC_WORDS], ctl int32 [8] (zeros), start int32
// [N, START_WORDS], first_ev int32 [S] (INT_MAX). Output: coef int16
// [blocks, 64], status int32 [S].

#include "jpeg_huff.cuh"

static Batch batch_of(const void* data, const void* seg, const void* scan, const void* huff,
                      const void* plane_block0, const void* plane) {
  return {(const uint32_t*)data, (const int*)seg, (const int*)scan, (const int*)huff,
          (const long long*)plane_block0, (const int*)plane};
}

extern "C" int rodynrf_jpeg_entropy_sync(const void* data, const void* seg, const void* scan,
                                         const void* huff, const void* plane_block0,
                                         const void* plane, const void* sub0,
                                         const void* subseg, int n_sub, int max_rounds,
                                         int subseq_bits, void* rec, void* ctl, void* stream) {
  if (n_sub <= 0) return 0;
  return launch_sync<false>(batch_of(data, seg, scan, huff, plane_block0, plane), 0,
                            (const int*)sub0, (const int*)subseg, n_sub, max_rounds,
                            subseq_bits, (int*)rec, (int*)ctl, (cudaStream_t)stream);
}

extern "C" int rodynrf_jpeg_entropy_scan(const void* data, const void* seg, const void* scan,
                                         const void* huff, const void* plane_block0,
                                         const void* plane, const void* sub0,
                                         const void* subseg, int n_sub, const void* rec,
                                         const void* ctl, void* start, void* first_ev,
                                         void* stream) {
  if (n_sub <= 0) return 0;
  return launch_scan<false>(batch_of(data, seg, scan, huff, plane_block0, plane), 0,
                            (const int*)sub0, (const int*)subseg, n_sub, (const int*)rec,
                            (const int*)ctl, (int*)start, (int*)first_ev, (cudaStream_t)stream);
}

extern "C" int rodynrf_jpeg_entropy_write(const void* data, const void* seg, const void* scan,
                                          const void* huff, const void* plane_block0,
                                          const void* plane, const void* sub0,
                                          const void* subseg, int n_sub, int subseq_bits,
                                          const void* rec, const void* ctl, const void* start,
                                          const void* first_ev, void* coef, void* status,
                                          void* stream) {
  if (n_sub <= 0) return 0;
  return launch_write<false>(batch_of(data, seg, scan, huff, plane_block0, plane), 0,
                             (const int*)sub0, (const int*)subseg, n_sub, subseq_bits,
                             (const int*)rec, (const int*)ctl, (const int*)start,
                             (const int*)first_ev, (short*)coef, (int*)status,
                             (cudaStream_t)stream);
}
