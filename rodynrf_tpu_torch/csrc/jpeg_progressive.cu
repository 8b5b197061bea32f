// Progressive JPEG entropy decode: every entropy-coded segment of one round
// of scans (scan k of every progressive frame of a batch) into the int16
// coefficient blocks that csrc/jpeg_idct.cu reads.
//
// Replaces no TPU kernel: the JAX package decodes its frames on the host
// through PIL (libjpeg-turbo, jdphuff.c), and the port reads the same frames
// on the card (rodynrf_tpu_torch/data/jpeg.py, whose
// `progressive_decode_plain` is this kernel's plain version).
//
// Design: as csrc/jpeg_entropy.cu, one thread per entropy-coded segment,
// each on a warp of its own (lanes decoding different segments diverge at
// every symbol), the 64-bit bit buffer and 9-bit lookahead tables of
// csrc/jpeg_huff.cuh. A scan refines what the earlier scans of its frame
// wrote, so the host launches one round after another on one stream: about
// 10 launches for libjpeg's standard script, whatever the number of frames.
// Inside a segment the decode is serial; each segment starts with the DC
// predictors and the end-of-band run at 0 (a restart marker resets both).
// Per scan kind (jdphuff.c):
//   DC first: a Huffman-coded difference per block, predicted per
//     component, stored << Al;
//   DC refinement: one raw bit per block, ORed in at 1 << Al;
//   AC first: run/size symbols over the band Ss..Se, values << Al, ZRL,
//     and end-of-band runs EOBn = 2^n + n appended bits blocks;
//   AC refinement: a correction bit for each coefficient already nonzero;
//     a zero run counts only coefficients still zero; a newly nonzero
//     coefficient is +-(1 << Al); an end-of-band run refines the rest of
//     the band of each block it covers.
// A unit is an MCU of an interleaved scan (DC scans of several components)
// or one block of the scan's component otherwise (h = v = 1, the
// component's own blocks per row). Each segment leaves a status word: 0, a
// code in no table, a run or refinement past the band, or a segment that
// ends before its last unit.
//
// Inputs (rodynrf_tpu_torch/data/jpeg.py `JpegBatch`):
//   data   uint8, every segment's unstuffed bytes back to back;
//   pseg   int32 [Sp, 5]: byte offset, byte length, scan, first unit, units;
//          this launch takes segments [seg0, seg0 + n_seg);
//   pscan  int32 [Np, PSCAN_WORDS]: frame, scan components, units per row,
//          Ss, Se, Ah, Al, then per scan component (plane, h, v);
//   phuff  int32 [Np, 3, HUFF_WORDS]: each scan component's table;
//   plane_block0 int64 [P + 1]; plane int32 [P, 8] (blocks per row first).
// Output: coef int16 [blocks, 64] (refined in place), status int32 [Sp].

#include "jpeg_huff.cuh"

#define PSCAN_WORDS 16

__device__ __forceinline__ int get_bit(Bits& b) {
  fill(b);
  int x = (int)peek(b, 1);
  skip(b, 1);
  return x;
}

// a correction bit for the nonzero coefficient c (jdphuff.c
// decode_mcu_AC_refine): if set and bit Al of |c| is not, |c| grows by 1 << Al
__device__ __forceinline__ void refine(Bits& b, short* c, int p1, int m1) {
  if (get_bit(b) && (*c & p1) == 0) *c = (short)(*c + (*c >= 0 ? p1 : m1));
}

__global__ void progressive_kernel(const uint8_t* __restrict__ data,
                                   const int* __restrict__ pseg, int seg0, int n_seg,
                                   const int* __restrict__ pscan,
                                   const int* __restrict__ phuff,
                                   const long long* __restrict__ plane_block0,
                                   const int* __restrict__ plane, short* __restrict__ coef,
                                   int* __restrict__ status) {
  const int s = seg0 + blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if ((threadIdx.x & 31) != 0 || s >= seg0 + n_seg) return;
  const int* sg = pseg + 5LL * s;
  const int row = sg[2], m0 = sg[3], nu = sg[4];
  const int* sc = pscan + (long long)row * PSCAN_WORDS;
  const int ncomp = sc[1], units_x = sc[2], ss = sc[3], se = sc[4], ah = sc[5], al = sc[6];
  const int* tabs = phuff + (long long)row * 3 * HUFF_WORDS;
  const int p1 = 1 << al, m1 = (int)((-1u) << al);

  Bits b;
  b.p = data + sg[0];
  b.nbytes = sg[1];
  b.next = 0;
  b.used = 0;
  b.acc = 0;
  b.have = 0;
  const long long nbits = 8LL * sg[1];

  int pred[3] = {0, 0, 0};
  int eobrun = 0;
  int st = OK;
  for (int m = m0; m < m0 + nu && st == OK; ++m) {
    const int my = m / units_x, mx = m % units_x;
    for (int c = 0; c < ncomp && st == OK; ++c) {
      const int* cs = sc + 7 + 3 * c;
      const int pl = cs[0], h = cs[1], v = cs[2];
      const int* tab = tabs + c * HUFF_WORDS;
      const long long bw = plane[(long long)pl * PLANE_WORDS];
      const long long b0 = plane_block0[pl];
      for (int yy = 0; yy < v && st == OK; ++yy) {
        for (int xx = 0; xx < h && st == OK; ++xx) {
          short* blk = coef + 64 * (b0 + ((long long)my * v + yy) * bw + (long long)mx * h + xx);
          if (ss == 0 && ah == 0) {  // DC first
            fill(b);
            int t = decode(b, tab);
            if (t < 0) { st = BAD_CODE; break; }
            if (t) {
              fill(b);
              pred[c] += receive_extend(b, t);
            }
            blk[0] = (short)(int)((unsigned)pred[c] << al);
          } else if (ss == 0) {  // DC refinement
            if (get_bit(b)) blk[0] = (short)(blk[0] | p1);
          } else if (ah == 0) {  // AC first
            if (eobrun > 0) {
              --eobrun;
              continue;
            }
            for (int k = ss; k <= se; ++k) {
              fill(b);
              int rs = decode(b, tab);
              if (rs < 0) { st = BAD_CODE; break; }
              int r = rs >> 4, sz = rs & 15;
              if (sz) {
                k += r;
                if (k > se) { st = BAD_BAND; break; }
                fill(b);
                blk[kNatural[k]] = (short)(int)((unsigned)receive_extend(b, sz) << al);
              } else if (r == 15) {
                k += 15;
              } else {
                eobrun = 1 << r;
                if (r) {
                  fill(b);
                  eobrun += (int)peek(b, r);
                  skip(b, r);
                }
                --eobrun;
                break;
              }
            }
          } else {  // AC refinement
            int k = ss;
            if (eobrun == 0) {
              for (; k <= se; ++k) {
                fill(b);
                int rs = decode(b, tab);
                if (rs < 0) { st = BAD_CODE; break; }
                int r = rs >> 4, sz = rs & 15, val = 0;
                if (sz) {
                  val = get_bit(b) ? p1 : m1;
                } else if (r != 15) {
                  eobrun = 1 << r;
                  if (r) {
                    fill(b);
                    eobrun += (int)peek(b, r);
                    skip(b, r);
                  }
                  break;
                }
                for (; k <= se; ++k) {
                  short* z = blk + kNatural[k];
                  if (*z != 0) {
                    refine(b, z, p1, m1);
                  } else if (--r < 0) {
                    break;
                  }
                }
                if (val) {
                  if (k > se) { st = BAD_BAND; break; }
                  blk[kNatural[k]] = (short)val;
                }
              }
            }
            if (st == OK && eobrun > 0) {
              for (; k <= se; ++k) {
                short* z = blk + kNatural[k];
                if (*z != 0) refine(b, z, p1, m1);
              }
              --eobrun;
            }
          }
        }
      }
    }
    if (st == OK && b.used > nbits) st = SHORT_SEGMENT;
  }
  status[s] = st;
}

extern "C" int rodynrf_jpeg_progressive(const void* data, const void* pseg, int seg0, int n_seg,
                                        const void* pscan, const void* phuff,
                                        const void* plane_block0, const void* plane, void* coef,
                                        void* status, void* stream) {
  if (n_seg <= 0) return 0;
  const int threads = 128;  // 4 warps, 4 segments
  const int blocks = (n_seg + threads / 32 - 1) / (threads / 32);
  progressive_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int*)pseg, seg0, n_seg, (const int*)pscan,
      (const int*)phuff, (const long long*)plane_block0, (const int*)plane, (short*)coef,
      (int*)status);
  return (int)cudaGetLastError();
}
