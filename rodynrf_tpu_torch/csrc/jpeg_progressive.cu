// Progressive JPEG entropy decode: every entropy-coded segment of one round
// of scans (data/jpeg.py `pack`: scans of the batch's progressive frames
// that touch disjoint coefficients) into the int16 coefficient blocks that
// csrc/jpeg_idct.cu reads.
//
// Replaces no TPU kernel: the JAX package decodes its frames on the host
// through PIL (libjpeg-turbo, jdphuff.c), and the port reads the same frames
// on the card (rodynrf_tpu_torch/data/jpeg.py, whose
// `progressive_decode_plain` is this kernel's plain version and
// `progressive_decode_model` the model of its algorithm).
//
// A scan refines what the earlier scans of its frame wrote, so the host
// launches one round after another on one stream; a round's scans follow
// every scan they share a coefficient with. Inside a segment the bits
// are serial; what bounds a serial walk on this card is the dependence from
// one symbol to the next, not the bytes. Each round's segments come sorted
// by kind (data/jpeg.py `pack`), and each kind has its own design
// (jdphuff.c):
//   DC and AC first scans: the self-synchronising parallel decode of
//     csrc/jpeg_huff.cuh (sync, scan and write launches), DC differences
//     predicted per component and stored << Al; an AC first scan's state is
//     (bit position, k), and an end-of-band run EOBn = 2^n + n appended bits
//     counts as that many blocks ended;
//   DC refinement: one raw bit per block, bit i of the segment for the i-th
//     block in unit order: no decode, a parallel OR (`dc_refine_kernel`);
//   AC refinement: the bits a block takes depend on its nonzero history,
//     so a decoder that does not know its block never syncs: one warp walks
//     each segment (`ac_refine_kernel`), with the dependent loads taken off
//     its chain. The Huffman table sits in shared memory, and so do the
//     segment's words, staged by the warp a 4 KB chunk at a time two chunks
//     ahead of the cursor: the 32 bits at the cursor are two shared loads
//     and a funnel shift. Each block's history is a 64-bit mask over the
//     band (a ballot of the warp's lanes, two coefficients each, loaded one
//     block ahead), turned at the block's start into a shared table of its
//     still-zero positions in order. A symbol's target is then one lookup,
//     the (z + r)-th still-zero position (z: those before k), and the
//     nonzero coefficients before it number t - k - r: the cursor moves past
//     the code, the sign bit and their correction bits at once, and each
//     owning lane reads its correction bit from shared memory and applies
//     it without a branch. An end-of-band run is handed to the lanes, one
//     block each (eight 16-byte loads, the history mask from registers): a
//     prefix sum of the blocks' popcounts places each block's bits, the
//     lanes apply them in parallel, and the cursor moves by the total.
// A unit is an MCU of an interleaved scan (DC scans of several components)
// or one block of the scan's component otherwise (h = v = 1, the
// component's own blocks per row). Each segment starts with the DC
// predictors and the end-of-band run at 0 and leaves a status word: 0, a
// code in no table, a run or refinement past the band, or a segment that
// ends before its last unit.
//
// Inputs (rodynrf_tpu_torch/data/jpeg.py `JpegBatch`):
//   data   uint8, every segment's unstuffed bytes back to back, zero-padded
//          to whole words;
//   pseg   int32 [Sp, 5]: byte offset, byte length, scan, first unit, units;
//          a launch takes segments [seg_lo, seg_lo + nseg) of one round;
//   pscan  int32 [Np, PSCAN_WORDS]: frame, scan components, units per row,
//          Ss, Se, Ah, Al, then per scan component (plane, h, v);
//   phuff  int32 [Np, 3, HUFF_WORDS]: each scan component's table;
//   plane_block0 int64 [P + 1]; plane int32 [P, 8] (blocks per row first);
//   psub0  int32 [Sp + 1]: each first scan segment's first subsequence;
//          psubseg int32 [subsequences]: each subsequence's segment.
// Output: coef int16 [blocks, 64] (refined in place), status int32 [Sp].

#include "jpeg_huff.cuh"

static Batch batch_of(const void* data, const void* pseg, const void* pscan, const void* phuff,
                      const void* plane_block0, const void* plane) {
  return {(const uint32_t*)data, (const int*)pseg, (const int*)pscan, (const int*)phuff,
          (const long long*)plane_block0, (const int*)plane};
}

// jdphuff.c's correction: if the bit is set and bit Al of |c| is not, |c|
// grows by 1 << Al
__device__ __forceinline__ int refined(int c, int p1, int m1) {
  return (c & p1) ? c : c + (c >= 0 ? p1 : m1);
}

// The AC refinement walker's view of a segment's bits: its words staged in
// a shared ring of RING_WORDS (four chunks of CHUNK_WORDS) by the warp, a
// chunk at a time, two chunks ahead of the cursor, so that a bit read is a
// shared load at its position (no bit buffer on the walk's chain).
#define CHUNK_WORDS 1024
#define RING_WORDS (4 * CHUNK_WORDS)

struct Ring {
  const uint32_t* w;
  long long end;  // global bit position of the segment's end
  long long w0;   // the global word that holds the segment's first bit
  int off;        // that bit's place in the word: segment bit p is ring bit off + p
  int loaded;     // chunks loaded so far
  uint32_t* s;    // the ring
};

// the next chunk, one word in 32 a lane; bits past the segment's end read 0
__device__ __forceinline__ void ring_load(Ring& g, int lane) {
  const long long wb = (g.w0 + (long long)g.loaded * CHUNK_WORDS) * 32;
  for (int i = lane; i < CHUNK_WORDS; i += 32) {
    const long long wbit = wb + 32LL * i, left = g.end - wbit;
    uint32_t x = 0;
    if (left > 0) {
      x = __byte_perm(__ldg(g.w + (wbit >> 5)), 0, 0x0123);
      if (left < 32) x &= 0xFFFFFFFFu << (32 - left);
    }
    g.s[(g.loaded * CHUNK_WORDS + i) & (RING_WORDS - 1)] = x;
  }
  ++g.loaded;
  __syncwarp();
}

// keep the chunks from the cursor's (segment bit p) to two past it loaded
// (called once a block: the chunks past the cursor's hold a block's bits)
__device__ __forceinline__ void ring_ahead(Ring& g, int p, int lane) {
  while (g.loaded < ((g.off + p) >> 5) / CHUNK_WORDS + 3) ring_load(g, lane);
}

// the 32 bits from segment bit p, and the bit at p, read from the kernel's
// own shared array `ring` (through a pointer the compiler would rebuild the
// shared address on every read)
#define RING_BITS32(g, p)                                                          \
  __funnelshift_l(ring[((((g).off + (p)) >> 5) + 1) & (RING_WORDS - 1)],           \
                  ring[(((g).off + (p)) >> 5) & (RING_WORDS - 1)], ((g).off + (p)) & 31)
#define RING_BIT(g, p)                                                             \
  (int)(ring[(((g).off + (p)) >> 5) & (RING_WORDS - 1)] >> (31 - (((g).off + (p)) & 31)) & 1)

// one warp (the whole block) per AC refinement segment
__global__ void __launch_bounds__(32)
ac_refine_kernel(Batch bt, int seg_lo, short* __restrict__ coef, int* __restrict__ status) {
  __shared__ int tab[HUFF_WORDS];
  __shared__ int zpos[64];  // the block's zero-history positions in order
  __shared__ int fresh[64];  // its newly nonzero coefficients' values, by position
  __shared__ int log_hk[72], log_q[72];  // per symbol: history rank, bit position
  __shared__ uint32_t ring[RING_WORDS];
  const unsigned FULL = 0xFFFFFFFFu;
  const int s = seg_lo + blockIdx.x;
  const int lane = threadIdx.x;
  const int* sg = bt.seg + 5LL * s;
  const int row = sg[2], m0 = sg[3], nu = sg[4], nbits = 8 * sg[1];
  const int* sc = bt.scan + (long long)row * PSCAN_WORDS;
  const int units_x = sc[2], ss = sc[3], se = sc[4], al = sc[6];
  const long long b0 = bt.plane_block0[sc[7]];
  const int bw = bt.plane[(long long)sc[7] * PLANE_WORDS];
  const int* gtab = bt.huff + (long long)row * 3 * HUFF_WORDS;
  for (int i = lane; i < HUFF_WORDS; i += 32) tab[i] = gtab[i];
  const int p1 = 1 << al, m1 = (int)((-1u) << al);
  const uint64_t band = (se == 63 ? ~0ull : (1ull << (se + 1)) - 1) & ~((1ull << ss) - 1);
  const unsigned below = (1u << lane) - 1;
  const int z0 = kNatural[lane], z1 = kNatural[lane + 32];
  Ring g;
  g.w = bt.words;
  g.end = 8LL * sg[0] + nbits;
  g.w0 = (8LL * sg[0]) >> 5;
  g.off = (int)((8LL * sg[0]) & 31);
  g.loaded = 0;
  g.s = ring;
  ring_ahead(g, 0, lane);
  int pos = 0, st = OK, u = 0, eobrun = 0, v0 = 0, v1 = 0;
  bool pref = false;
  while (u < nu) {
    if (eobrun == 0) {  // one block's symbols, the warp in step
      int m = m0 + u;
      short* blk = coef + 64 * (b0 + (long long)(m / units_x) * bw + m % units_x);
      int c0 = pref ? v0 : blk[z0], c1 = pref ? v1 : blk[z1];
      pref = u + 1 < nu;
      if (pref) {  // the next block's history, loaded while this one decodes
        m = m0 + u + 1;
        const short* nb = coef + 64 * (b0 + (long long)(m / units_x) * bw + m % units_x);
        v0 = nb[z0];
        v1 = nb[z1];
      }
      // the history as masks over the band, the zero-history positions in
      // order, each lane's ranks among the history bits
      const unsigned hlo = __ballot_sync(FULL, c0 != 0) & (unsigned)band;
      const unsigned hhi = __ballot_sync(FULL, c1 != 0) & (unsigned)(band >> 32);
      const unsigned zlo = ~hlo & (unsigned)band, zhi = ~hhi & (unsigned)(band >> 32);
      if (zlo >> lane & 1) zpos[__popc(zlo & below)] = lane;
      if (zhi >> lane & 1) zpos[__popc(zlo) + __popc(zhi & below)] = lane + 32;
      const int nz = __popc(zlo) + __popc(zhi);
      const int h0 = (hlo >> lane & 1) ? __popc(hlo & below) : -1;
      const int h1 = (hhi >> lane & 1) ? __popc(hlo) + __popc(hhi & below) : -1;
      fresh[lane] = fresh[lane + 32] = 0;
      __syncwarp();
      // the walk only moves the cursor: each symbol logs where its
      // correction bits start (the cursor q for history ranks from hk) and
      // its new value; the lanes apply both when the block ends
      int k = ss, hk = 0, z = 0, nl = 0;
      while (k <= se) {
        const uint32_t x = RING_BITS32(g, pos);
        int e = tab[x >> (32 - LOOKAHEAD)];
        if (__builtin_expect(e == 0, 0)) e = decode_long(x >> 16, tab);
        if (e < 0) {
          st = BAD_CODE;
          break;
        }
        const int len = e >> 8, r = (e >> 4) & 15;
        if (!(e & 15) && r != 15) {  // EOBr
          eobrun = (1 << r) + (r ? (int)((x << len) >> (32 - r)) : 0);
          pos += len + r;
          break;
        }
        // a newly nonzero coefficient's sign bit follows its code; the
        // target is the (r+1)-th zero-history position from k, and before
        // it lie r zero-history positions and nc history ones
        const int val = (e & 15) ? ((x << len) >> 31 ? p1 : m1) : 0;
        const int q = pos + len + ((e & 15) ? 1 : 0);
        int t, nc;
        if (z + r < nz) {
          t = zpos[z + r];
          nc = t - k - r;
        } else {
          t = se + 1;
          nc = (se + 1 - k) - (nz - z);
        }
        log_hk[nl] = hk;
        log_q[nl] = q;
        ++nl;
        hk += nc;
        if (val && t > se) {
          st = BAD_BAND;
          break;
        }
        if (val) fresh[t] = val;
        pos = q + nc;
        z += r + 1;
        k = t + 1;
      }
      if (st == OK && eobrun > 0) {  // the band's rest in an end-of-band block
        log_hk[nl] = hk;
        log_q[nl] = pos;
        ++nl;
        pos += __popc(hlo) + __popc(hhi) - hk;
        hk = __popc(hlo) + __popc(hhi);
        --eobrun;
      }
      __syncwarp();
      // a history coefficient of rank h takes the bit at q + h - hk of the
      // last logged symbol with hk <= h
      int q0 = -1, q1 = -1;
      for (int i = 0; i < nl; ++i) {
        const int lh = log_hk[i], lq = log_q[i];
        q0 = lh <= h0 ? lq + h0 - lh : q0;
        q1 = lh <= h1 ? lq + h1 - lh : q1;
      }
      const bool f0 = h0 >= 0 && h0 < hk && RING_BIT(g, q0);
      const bool f1 = h1 >= 0 && h1 < hk && RING_BIT(g, q1);
      const int n0 = fresh[lane], n1 = fresh[lane + 32];
      if (f0 | (n0 != 0)) blk[z0] = (short)(n0 ? n0 : refined(c0, p1, m1));
      if (f1 | (n1 != 0)) blk[z1] = (short)(n1 ? n1 : refined(c1, p1, m1));
      __syncwarp();  // zpos, fresh and the log are rewritten for the next block
      if (st != OK) break;
      ++u;
      if (pos > nbits) {
        st = SHORT_SEGMENT;
        break;
      }
      ring_ahead(g, pos, lane);  // a block takes under 2,100 bits: a chunk holds 32,768
    } else {  // the run's next blocks, one a lane
      pref = false;
      const int cnt = min(min(eobrun, nu - u), 32);
      const bool act = lane < cnt;
      short* blk = nullptr;
      uint64_t h = 0;
      if (act) {  // the block in eight 16-byte loads, its nonzero mask in zigzag order
        const int m = m0 + u + lane;
        blk = coef + 64 * (b0 + (long long)(m / units_x) * bw + m % units_x);
        uint4 q[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) q[i] = reinterpret_cast<const uint4*>(blk)[i];
        uint64_t nat = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const unsigned w4[4] = {q[i].x, q[i].y, q[i].z, q[i].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            nat |= (uint64_t)((w4[j] & 0xFFFFu) != 0) << (8 * i + 2 * j);
            nat |= (uint64_t)((w4[j] >> 16) != 0) << (8 * i + 2 * j + 1);
          }
        }
#pragma unroll
        for (int kk = 0; kk < 64; ++kk) h |= (nat >> kNatural[kk] & 1) << kk;
        h &= band;
      }
      const int pc = __popcll(h);
      int inc = pc;
      for (int dl = 1; dl < 32; dl <<= 1) {
        const int o = __shfl_up_sync(FULL, inc, dl);
        if (lane >= dl) inc += o;
      }
      const int total = __shfl_sync(FULL, inc, 31);
      // the first block whose bits end past the segment ends it
      const unsigned over = __ballot_sync(FULL, act && pos + inc > nbits);
      const int last = over ? __ffs(over) - 1 : 31;
      if (act && lane <= last) {
        int q = pos + inc - pc;
        for (uint64_t mm = h; mm; mm &= mm - 1, ++q) {
          if (RING_BIT(g, q)) {
            short* zp = blk + kNatural[__ffsll((long long)mm) - 1];
            *zp = (short)refined(*zp, p1, m1);
          }
        }
      }
      if (over) {
        st = SHORT_SEGMENT;
        break;
      }
      pos += total;
      u += cnt;
      eobrun -= cnt;
      ring_ahead(g, pos, lane);
    }
  }
  if (lane == 0) status[s] = st;
}

// one block of threads per DC refinement segment: bit i to the i-th block
__global__ void dc_refine_kernel(Batch bt, int seg_lo, short* __restrict__ coef,
                                 int* __restrict__ status) {
  const int s = seg_lo + blockIdx.x;
  const Desc d = desc_progressive(bt.seg, s, bt.scan, bt.huff, bt.plane_block0, bt.plane);
  const uint8_t* bytes = (const uint8_t*)bt.words + d.byte0;
  const int p1 = 1 << d.al;
  const int n = min(d.T, d.nbits);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (bytes[i >> 3] >> (7 - (i & 7)) & 1) {
      short* z = block_of(d, coef, i);
      z[0] = (short)(z[0] | p1);
    }
  }
  if (threadIdx.x == 0) status[s] = d.T > d.nbits ? SHORT_SEGMENT : OK;
}

extern "C" int rodynrf_jpeg_progressive_sync(const void* data, const void* pseg,
                                             const void* pscan, const void* phuff,
                                             const void* plane_block0, const void* plane,
                                             int seg_lo, const void* psub0, const void* psubseg,
                                             int n_sub, int max_rounds, int subseq_bits,
                                             void* rec, void* ctl, void* stream) {
  if (n_sub <= 0) return 0;
  return launch_sync<true>(batch_of(data, pseg, pscan, phuff, plane_block0, plane), seg_lo,
                           (const int*)psub0 + seg_lo, (const int*)psubseg, n_sub, max_rounds,
                           subseq_bits, (int*)rec, (int*)ctl, (cudaStream_t)stream);
}

extern "C" int rodynrf_jpeg_progressive_scan(const void* data, const void* pseg,
                                             const void* pscan, const void* phuff,
                                             const void* plane_block0, const void* plane,
                                             int seg_lo, const void* psub0, const void* psubseg,
                                             int n_sub, const void* rec, const void* ctl,
                                             void* start, void* first_ev, void* stream) {
  if (n_sub <= 0) return 0;
  return launch_scan<true>(batch_of(data, pseg, pscan, phuff, plane_block0, plane), seg_lo,
                           (const int*)psub0 + seg_lo, (const int*)psubseg, n_sub,
                           (const int*)rec, (const int*)ctl, (int*)start, (int*)first_ev,
                           (cudaStream_t)stream);
}

extern "C" int rodynrf_jpeg_progressive_write(const void* data, const void* pseg,
                                              const void* pscan, const void* phuff,
                                              const void* plane_block0, const void* plane,
                                              int seg_lo, const void* psub0,
                                              const void* psubseg, int n_sub, int subseq_bits,
                                              const void* rec, const void* ctl,
                                              const void* start, const void* first_ev,
                                              void* coef, void* status, void* stream) {
  if (n_sub <= 0) return 0;
  return launch_write<true>(batch_of(data, pseg, pscan, phuff, plane_block0, plane), seg_lo,
                            (const int*)psub0 + seg_lo, (const int*)psubseg, n_sub,
                            subseq_bits, (const int*)rec, (const int*)ctl, (const int*)start,
                            (const int*)first_ev, (short*)coef, (int*)status,
                            (cudaStream_t)stream);
}

extern "C" int rodynrf_jpeg_progressive_dc_refine(const void* data, const void* pseg,
                                                  const void* pscan, const void* phuff,
                                                  const void* plane_block0, const void* plane,
                                                  int seg_lo, int nseg, void* coef, void* status,
                                                  void* stream) {
  if (nseg <= 0) return 0;
  dc_refine_kernel<<<nseg, 256, 0, (cudaStream_t)stream>>>(
      batch_of(data, pseg, pscan, phuff, plane_block0, plane), seg_lo, (short*)coef,
      (int*)status);
  return (int)cudaGetLastError();
}

extern "C" int rodynrf_jpeg_progressive_ac_refine(const void* data, const void* pseg,
                                                  const void* pscan, const void* phuff,
                                                  const void* plane_block0, const void* plane,
                                                  int seg_lo, int nseg, void* coef, void* status,
                                                  void* stream) {
  if (nseg <= 0) return 0;
  ac_refine_kernel<<<nseg, 32, 0, (cudaStream_t)stream>>>(
      batch_of(data, pseg, pscan, phuff, plane_block0, plane), seg_lo, (short*)coef,
      (int*)status);
  return (int)cudaGetLastError();
}
