// The JPEG entropy decoders' shared pieces (csrc/jpeg_entropy.cu,
// csrc/jpeg_progressive.cu): the table layout of
// rodynrf_tpu_torch/data/jpeg.py, a 64-bit bit reader that loads aligned
// 32-bit words of a segment's unstuffed bytes two words ahead of their use
// (zeros past its end), the
// Huffman decode through a 9-bit lookahead table with the canonical maxcode
// walk for longer codes (jdhuff.c), HUFF_EXTEND, and the parallel decode of
// a Huffman-coded scan (a baseline scan, or a progressive DC or AC first
// scan) in three passes:
//
//   sync (one cooperative launch): every segment's bits are cut into
//     subsequences of `subseq_bits` bits, one decoder (thread) each. A
//     decoder runs from its entry state (bit position, block of the unit,
//     next coefficient k) to the first symbol boundary at or past its
//     subsequence's end and records that exit state, the blocks it ended,
//     its DC differences per scan component and its first event (a code in
//     no table, a run past the band, or a unit that ends past the segment's
//     bits). Round 0 starts every decoder at its subsequence's first bit in
//     a guessed state (a unit's first block); each later round restarts a
//     decoder whose predecessor's exit changed from that exit, and the
//     rounds end when no exit changes: then every entry is the exit of the
//     decoder before it, and the first decoder of each segment starts at
//     its true start, so every record is the true path's. Huffman codes
//     resynchronise within a few symbols (Weissenberger & Schmidt, ICPP
//     2018), so a wrong guess usually meets the true path inside its own
//     subsequence, and few rounds are needed; the worst case is one round
//     per subsequence. A decoder meeting an error goes on from the
//     symbol's next bit in the guessed state, so that a speculative decoder
//     that reads garbage can still sync.
//   scan (one block): exclusive scans per segment of the blocks ended (each
//     decoder's first block) and of the DC differences (each decoder's DC
//     predictors), and each segment's first event that lies in its blocks:
//     the decoder it lies in ends the segment there.
//   write (one thread per subsequence): from its entry, the decoder writes
//     its blocks' coefficients, up to its exit, the segment's last block,
//     or the segment's first event (its status word).
//
// Records are int32 [10]: exit bit position, exit block of the unit | k << 8,
// blocks ended, three DC sums, first event's status and its block, and the
// entry the record was decoded from (bit position, block | k << 8).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define LOOKAHEAD 9
#define HUFF_WORDS ((1 << LOOKAHEAD) + 18 + 18 + 256)
#define SCAN_WORDS 17
#define PSCAN_WORDS 16
#define PLANE_WORDS 8
#define REC_WORDS 10
#define START_WORDS 4
#define SYNC_THREADS 256
#define SCAN_THREADS 1024
#define WRITE_THREADS 256
#define COUNT_CAP (1 << 30)

enum { OK = 0, BAD_CODE = 1, BAD_AC = 2, SHORT_SEGMENT = 3, BAD_BAND = 4 };
enum { PAR_BASELINE = 0, PAR_DC_FIRST = 1, PAR_AC_FIRST = 2 };

__constant__ int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ---------------------------------------------------------------------------
// bits
// ---------------------------------------------------------------------------

struct Bits {
  const uint32_t* w;  // the batch's bytes as 32-bit words
  long long base;     // global bit position of the segment's first bit
  long long end;      // global bit position of its end
  long long next;     // global bit position of the word in r0
  uint64_t acc;       // unconsumed bits, most significant first
  int have;           // bits in acc
  int pos;            // segment bit position of the next unconsumed bit
  uint32_t r0, r1;    // the next two words as loaded (in flight until used)
};

// the word at global bit `wbit` (a multiple of 32) as stored; a word wholly
// past the segment's end is never loaded
__device__ __forceinline__ uint32_t raw_word(const Bits& b, long long wbit) {
  return b.end - wbit > 0 ? __ldg(b.w + (wbit >> 5)) : 0u;
}

// a stored word, big-endian, zero past the segment's end
__device__ __forceinline__ uint32_t word_at(const Bits& b, uint32_t raw, long long wbit) {
  const long long left = b.end - wbit;
  const uint32_t x = __byte_perm(raw, 0, 0x0123);
  return left >= 32 ? x : left <= 0 ? 0u : x & (0xFFFFFFFFu << (32 - left));
}

__device__ __forceinline__ void seek(Bits& b, int p) {
  const long long g = b.base + p;
  const long long w0 = g & ~31LL;
  const int sh = (int)(g - w0);
  const uint32_t a = raw_word(b, w0), c = raw_word(b, w0 + 32);
  b.next = w0 + 64;
  b.r0 = raw_word(b, b.next);
  b.r1 = raw_word(b, b.next + 32);
  b.acc = (((uint64_t)word_at(b, a, w0) << 32) | word_at(b, c, w0 + 32)) << sh;
  b.have = 64 - sh;
  b.pos = p;
}

__device__ __forceinline__ void init_bits(Bits& b, const uint32_t* w, long long byte0, int nbits,
                                          int p) {
  b.w = w;
  b.base = 8 * byte0;
  b.end = b.base + nbits;
  seek(b, p);
}

// at least 33 bits in the buffer: a code (16) and its value (16) at most.
// A word is loaded two words before it is used, so that its latency hides
// behind the symbols decoded meanwhile
__device__ __forceinline__ void fill(Bits& b) {
  if (b.have <= 32) {
    b.acc |= (uint64_t)word_at(b, b.r0, b.next) << (32 - b.have);
    b.have += 32;
    b.next += 32;
    b.r0 = b.r1;
    b.r1 = raw_word(b, b.next + 32);
  }
}

// n in 1..32
__device__ __forceinline__ uint32_t peek(const Bits& b, int n) {
  return (uint32_t)(b.acc >> (64 - n));
}

__device__ __forceinline__ void skip(Bits& b, int n) {
  b.acc <<= n;
  b.have -= n;
  b.pos += n;
}

// a code longer than the lookahead, by the canonical maxcode walk:
// length << 8 | symbol, or -1 for a code that is in no table
__device__ __forceinline__ int decode_long(uint32_t look, const int* tab) {
  const int* maxcode = tab + (1 << LOOKAHEAD);
  const int* valoff = maxcode + 18;
  const int* vals = valoff + 18;
  int l = 17;  // the shortest length whose code is canonical, unrolled without branches
#pragma unroll
  for (int ll = 16; ll > LOOKAHEAD; --ll)
    l = (int)(look >> (16 - ll)) <= maxcode[ll] ? ll : l;
  return l > 16 ? -1 : l << 8 | vals[(int)(look >> (16 - l)) + valoff[l]];
}

// one symbol of the table, or -1 for a code that is in no table; the buffer
// is filled on entry
__device__ __forceinline__ int decode(Bits& b, const int* tab) {
  const uint32_t look = peek(b, 16);
  int e = tab[look >> (16 - LOOKAHEAD)];
  if (!e) e = decode_long(look, tab);
  if (e < 0) return -1;
  skip(b, e >> 8);
  return e & 255;
}

// the s-bit value that follows a symbol, sign-extended (jdhuff.h HUFF_EXTEND)
__device__ __forceinline__ int receive_extend(Bits& b, int s) {
  const int x = (int)peek(b, s);
  skip(b, s);
  return x < (1 << (s - 1)) ? x + (int)((-1u) << s) + 1 : x;
}

// ---------------------------------------------------------------------------
// a segment of a Huffman-coded scan, as the parallel decode sees it
// ---------------------------------------------------------------------------

struct Desc {
  long long byte0;  // the segment's first byte in the batch
  int key;          // its tables' set: the frame (baseline) or the scan (progressive)
  int nbits, kind, bpu, T, m0, units_x, se, al, k0, band_err;
  unsigned long long cyc;  // block c of a unit: bits 4c.. = comp | yy << 2 | xx << 3
  const int* dct[3];
  const int* act[3];
  long long b0[3];
  int bw[3], h[3], v[3];
};

// a baseline segment (JpegBatch seg, scan, huff)
__device__ __forceinline__ Desc desc_baseline(const int* seg, int s, const int* scan,
                                              const int* huff, const long long* plane_block0,
                                              const int* plane) {
  Desc d;
  const int* sg = seg + 5LL * s;
  const int f = sg[2];
  d.byte0 = sg[0];
  d.nbits = 8 * sg[1];
  d.m0 = sg[3];
  const int* sc = scan + (long long)f * SCAN_WORDS;
  d.units_x = sc[1];
  d.kind = PAR_BASELINE;
  d.se = 63;
  d.al = 0;
  d.k0 = 0;
  d.band_err = BAD_AC;
  d.key = f;
  d.cyc = 0;
  d.dct[0] = d.dct[1] = d.dct[2] = d.act[0] = d.act[1] = d.act[2] =
      huff + (long long)f * 8 * HUFF_WORDS;
  int c = 0;
#pragma unroll
  for (int j = 0; j < 3; ++j) {  // constant indices: the arrays stay in registers
    if (j >= sc[0]) break;
    const int* cs = sc + 2 + 5 * j;
    d.dct[j] = huff + ((long long)f * 8 + cs[3]) * HUFF_WORDS;
    d.act[j] = huff + ((long long)f * 8 + cs[4]) * HUFF_WORDS;
    d.b0[j] = plane_block0[cs[0]];
    d.bw[j] = plane[(long long)cs[0] * PLANE_WORDS];
    d.h[j] = cs[1];
    d.v[j] = cs[2];
    for (int yy = 0; yy < cs[2]; ++yy)
      for (int xx = 0; xx < cs[1]; ++xx, ++c)
        d.cyc |= (unsigned long long)(j | yy << 2 | xx << 3) << (4 * c);
  }
  d.bpu = c;
  d.T = sg[4] * c;
  return d;
}

// a progressive segment of a DC or AC first scan (JpegBatch pseg, pscan, phuff)
__device__ __forceinline__ Desc desc_progressive(const int* pseg, int s, const int* pscan,
                                                 const int* phuff,
                                                 const long long* plane_block0,
                                                 const int* plane) {
  Desc d;
  const int* sg = pseg + 5LL * s;
  const int row = sg[2];
  d.byte0 = sg[0];
  d.nbits = 8 * sg[1];
  d.m0 = sg[3];
  const int* sc = pscan + (long long)row * PSCAN_WORDS;
  d.units_x = sc[2];
  const int ss = sc[3];
  d.kind = ss == 0 ? PAR_DC_FIRST : PAR_AC_FIRST;
  d.se = sc[4];
  d.al = sc[6];
  d.k0 = ss;
  d.band_err = BAD_BAND;
  d.key = row;
  d.cyc = 0;
  d.dct[0] = d.dct[1] = d.dct[2] = d.act[0] = d.act[1] = d.act[2] =
      phuff + (long long)row * 3 * HUFF_WORDS;
  int c = 0;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (j >= sc[1]) break;
    const int* cs = sc + 7 + 3 * j;
    d.dct[j] = d.act[j] = phuff + ((long long)row * 3 + j) * HUFF_WORDS;
    d.b0[j] = plane_block0[cs[0]];
    d.bw[j] = plane[(long long)cs[0] * PLANE_WORDS];
    d.h[j] = cs[1];
    d.v[j] = cs[2];
    for (int yy = 0; yy < cs[2]; ++yy)
      for (int xx = 0; xx < cs[1]; ++xx, ++c)
        d.cyc |= (unsigned long long)(j | yy << 2 | xx << 3) << (4 * c);
  }
  d.bpu = c;
  d.T = sg[4] * c;
  return d;
}

template <bool PROG>
__device__ __forceinline__ Desc load_desc(const int* seg, int s, const int* scan,
                                          const int* huff, const long long* plane_block0,
                                          const int* plane) {
  return PROG ? desc_progressive(seg, s, scan, huff, plane_block0, plane)
              : desc_baseline(seg, s, scan, huff, plane_block0, plane);
}

// a[j] of a three-entry array by constant indices (a runtime index would
// move the array from registers to local memory)
template <class T>
__device__ __forceinline__ T pick(const T (&a)[3], int j) {
  return j == 0 ? a[0] : (j == 1 ? a[1] : a[2]);
}

template <class T>
__device__ __forceinline__ void add3(T (&a)[3], int j, T x) {
  if (j == 0) a[0] += x;
  else if (j == 1) a[1] += x;
  else a[2] += x;
}

// block n of the segment (counted from its first unit's first block)
__device__ __forceinline__ short* block_of(const Desc& d, short* coef, int n) {
  const int u = n / d.bpu, c = n - u * d.bpu;
  const int e = (int)(d.cyc >> (4 * c)) & 15;
  const int j = e & 3;
  const int m = d.m0 + u;
  const int my = m / d.units_x, mx = m - my * d.units_x;
  return coef + 64 * (pick(d.b0, j) + ((long long)my * pick(d.v, j) + (e >> 2 & 1)) *
                      pick(d.bw, j) + (long long)mx * pick(d.h, j) + (e >> 3));
}

// ---------------------------------------------------------------------------
// one decoder (data/jpeg.py `_par_run` is its model)
// ---------------------------------------------------------------------------

struct Run {
  int c, k;       // state at b.pos: block of the unit, next coefficient
  int n;          // blocks ended
  unsigned dc[3]; // DC differences per scan component (sync pass)
  int ev, ev_n;   // the first event's status and block (0: none)
};

// Decode from b.pos in state (r.c, r.k) to the first symbol boundary at or
// past `stop`. The sync pass (WRITE false) counts and records the first
// event, going on after an error from the symbol's next bit in the guessed
// state; the write pass writes blocks n0 + r.n of the segment, DC from
// `pred`, and stops at the segment's last block or at its first event.
template <bool WRITE>
__device__ void par_run(const Desc& d, Bits& b, Run& r, int stop, short* coef, int n0,
                        unsigned (&pred)[3]) {
  for (;;) {
    if (b.pos >= stop) return;
    if (WRITE && n0 + r.n >= d.T) return;
    fill(b);
    const int p_sym = b.pos;
    const int j = (int)(d.cyc >> (4 * r.c)) & 3;
    int bad = 0, ended = 0;
    if (d.kind != PAR_AC_FIRST && r.k == 0) {  // a DC difference
      const int t = decode(b, pick(d.dct, j));
      if (t < 0) {
        bad = BAD_CODE;
      } else {
        const int x = t ? receive_extend(b, t) : 0;
        if (WRITE) {
          add3(pred, j, (unsigned)x);
          block_of(d, coef, n0 + r.n)[0] = (short)(pick(pred, j) << d.al);
        } else {
          add3(r.dc, j, (unsigned)x);
        }
        if (d.kind == PAR_DC_FIRST) ended = 1;
        else r.k = 1;
      }
    } else {  // an AC run/size symbol
      const int rs = decode(b, pick(d.act, j));
      const int run = rs >> 4, s = rs & 15;
      if (rs < 0) {
        bad = BAD_CODE;
      } else if (s && r.k + run > d.se) {
        bad = d.band_err;
      } else if (s) {
        r.k += run;
        const int x = receive_extend(b, s);
        if (WRITE) block_of(d, coef, n0 + r.n)[kNatural[r.k]] = (short)((unsigned)x << d.al);
        ++r.k;
        ended = r.k > d.se;
      } else if (run == 15) {
        r.k += 16;
        ended = r.k > d.se;
      } else if (d.kind == PAR_AC_FIRST) {  // EOBr: this block and 2^r + bits - 1 more
        ended = 1 << run;
        if (run) {
          ended += (int)peek(b, run);
          skip(b, run);
        }
      } else {
        ended = 1;
      }
    }
    if (bad) {
      if (WRITE) {
        r.ev = bad;
        r.ev_n = r.n;
        return;
      }
      if (!r.ev) {
        r.ev = bad;
        r.ev_n = r.n;
      }
      seek(b, p_sym + 1);
      r.c = 0;
      r.k = d.k0;
      continue;
    }
    if (ended) {
      r.n = min(r.n + ended, COUNT_CAP);
      r.k = d.k0;
      if (++r.c == d.bpu) {  // a unit ends: the segment's bits must not be used up
        r.c = 0;
        if (b.pos > d.nbits) {
          if (WRITE) {
            r.ev = SHORT_SEGMENT;
            r.ev_n = r.n - ended;
            return;
          }
          if (!r.ev) {
            r.ev = SHORT_SEGMENT;
            r.ev_n = r.n - ended;
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the three passes
// ---------------------------------------------------------------------------

// all blocks of the grid at once (a cooperative launch keeps them resident)
__device__ __forceinline__ void grid_barrier(int* ctl) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile int* gen = ctl + 1;
    const int g = *gen;
    __threadfence();
    if (atomicAdd(ctl, 1) == (int)gridDim.x - 1) {
      atomicExch(ctl, 0);
      __threadfence();
      atomicAdd(ctl + 1, 1);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

struct Batch {
  const uint32_t* words;
  const int* seg;   // seg or pseg
  const int* scan;  // scan or pscan
  const int* huff;  // huff or phuff
  const long long* plane_block0;
  const int* plane;
};

// the Huffman tables of a frame (baseline: 8 slots) or a scan (progressive:
// 3), which a block keeps in shared memory
template <bool PROG>
__host__ __device__ constexpr int table_words() {
  return (PROG ? 3 : 8) * HUFF_WORDS;
}

// the block's shared copy of the tables of the segment of its first
// subsequence `i0` (a global index), when any of its threads decodes; a
// thread whose segment has those tables reads them there
template <bool PROG>
__device__ __forceinline__ int block_tables(const Batch& bt, const int* subseg, int i0, bool any,
                                            int* stab) {
  const int key = __ldg(bt.seg + 5LL * __ldg(subseg + i0) + 2);
  if (any) {
    const int* g = bt.huff + (long long)key * table_words<PROG>();
    for (int w = threadIdx.x; w < table_words<PROG>(); w += blockDim.x) stab[w] = __ldg(g + w);
  }
  __syncthreads();
  return key;
}

template <bool PROG>
__device__ __forceinline__ void tables_shared(Desc& d, const Batch& bt, int key,
                                              const int* stab) {
  if (d.key != key) return;
  const int* g = bt.huff + (long long)key * table_words<PROG>();
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    d.dct[j] = stab + (d.dct[j] - g);
    d.act[j] = stab + (d.act[j] - g);
  }
}

// ctl int32 [8], zeros: barrier count and generation, three change
// counters, the last round. sub0 counts from the launch's first segment
// seg_lo; subseg (each subsequence's segment) and the records' subsequences
// from sub0[0]
template <bool PROG>
__global__ void __launch_bounds__(SYNC_THREADS)
sync_kernel(Batch bt, int seg_lo, const int* __restrict__ sub0, const int* __restrict__ subseg,
            int n_sub, int max_rounds, int subseq_bits, int* rec, int* ctl) {
  extern __shared__ int stab[];
  const int base = __ldg(sub0);
  const int stride = gridDim.x * blockDim.x;
  for (int r = 0;; ++r) {
    int* out = rec + (long long)(r % 3) * n_sub * REC_WORDS;
    const int* prev = rec + (long long)((r + 2) % 3) * n_sub * REC_WORDS;
    for (int i0 = blockIdx.x * blockDim.x; i0 < n_sub; i0 += stride) {  // block-uniform
      const int i = i0 + threadIdx.x;
      int s = 0, j = 0, p = 0, ck = 0;
      bool work = false;
      if (i < n_sub) {
        s = __ldg(subseg + base + i) - seg_lo;
        j = base + i - __ldg(sub0 + s);
        if (r == 0) {  // the true start, or the guess
          work = true;
        } else if (j > 0) {  // the predecessor's exit, if it moved
          p = __ldcg(prev + (long long)(i - 1) * REC_WORDS);
          ck = __ldcg(prev + (long long)(i - 1) * REC_WORDS + 1);
          work = p != __ldcg(prev + (long long)i * REC_WORDS + 8) ||
                 ck != __ldcg(prev + (long long)i * REC_WORDS + 9);
        }
        if (!work) {  // the same entry: the same record
          for (int w = 0; w < REC_WORDS; ++w)
            out[(long long)i * REC_WORDS + w] = __ldcg(prev + (long long)i * REC_WORDS + w);
        }
      }
      const int key = block_tables<PROG>(bt, subseg, base + i0, __syncthreads_or(work), stab);
      if (work) {
        Desc d = load_desc<PROG>(bt.seg, seg_lo + s, bt.scan, bt.huff, bt.plane_block0,
                                 bt.plane);
        tables_shared<PROG>(d, bt, key, stab);
        if (r == 0) {
          p = j * subseq_bits;
          ck = d.k0 << 8;
        }
        Bits b;
        init_bits(b, bt.words, d.byte0, d.nbits, p);
        Run run = {ck & 255, ck >> 8, 0, {0u, 0u, 0u}, 0, 0};
        const long long stop = min((long long)(j + 1) * subseq_bits, (long long)d.nbits);
        par_run<false>(d, b, run, (int)stop, nullptr, 0, run.dc);
        int* o = out + (long long)i * REC_WORDS;
        const int ock = run.c | run.k << 8;
        if (r > 0 && (__ldcg(prev + (long long)i * REC_WORDS) != b.pos ||
                      __ldcg(prev + (long long)i * REC_WORDS + 1) != ock))
          atomicAdd(ctl + 2 + r % 3, 1);
        o[0] = b.pos;
        o[1] = ock;
        o[2] = run.n;
        o[3] = (int)run.dc[0];
        o[4] = (int)run.dc[1];
        o[5] = (int)run.dc[2];
        o[6] = run.ev;
        o[7] = run.ev_n;
        o[8] = p;
        o[9] = ck;
      }
      __syncthreads();  // the shared tables are reloaded for the next subsequences
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) ctl[2 + (r + 1) % 3] = 0;
    grid_barrier(ctl);
    if (r > 0 && (__ldcg(ctl + 2 + r % 3) == 0 || r >= max_rounds)) {
      if (blockIdx.x == 0 && threadIdx.x == 0) ctl[5] = r;
      return;
    }
  }
}

struct Agg {
  int f, n;
  unsigned d0, d1, d2;
};

__device__ __forceinline__ Agg combine(const Agg& a, const Agg& b) {  // a before b
  if (b.f) return b;
  return {a.f, min(a.n + b.n, COUNT_CAP), a.d0 + b.d0, a.d1 + b.d1, a.d2 + b.d2};
}

__device__ __forceinline__ Agg shfl_up(const Agg& a, int delta) {
  return {__shfl_up_sync(0xFFFFFFFFu, a.f, delta), __shfl_up_sync(0xFFFFFFFFu, a.n, delta),
          __shfl_up_sync(0xFFFFFFFFu, a.d0, delta), __shfl_up_sync(0xFFFFFFFFu, a.d1, delta),
          __shfl_up_sync(0xFFFFFFFFu, a.d2, delta)};
}

// one block of SCAN_THREADS: each decoder's first block and DC predictors
// (start int32 [n_sub, START_WORDS]), and the first subsequence of each
// segment whose event lies in the segment's blocks (first_ev int32, one per
// segment of the launch, INT_MAX on entry)
template <bool PROG>
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(Batch bt, int seg_lo, const int* __restrict__ sub0, const int* __restrict__ subseg,
            int n_sub, const int* rec_all, const int* ctl, int* start, int* first_ev) {
  __shared__ Agg warp_tot[SCAN_THREADS / 32];
  const int* rec = rec_all + (long long)(ctl[5] % 3) * n_sub * REC_WORDS;
  const int base = __ldg(sub0);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int chunk = (n_sub + SCAN_THREADS - 1) / SCAN_THREADS;
  const int i0 = min(t * chunk, n_sub), i1 = min(i0 + chunk, n_sub);
  // this thread's items, reduced
  // (a subsequence starts its segment where its segment differs from the
  // one before it: two independent loads, not a dependent pair)
  Agg a = {0, 0, 0u, 0u, 0u};
#pragma unroll 4
  for (int i = i0; i < i1; ++i) {
    const int* o = rec + (long long)i * REC_WORDS;
    const bool first = i == 0 || __ldg(subseg + base + i) != __ldg(subseg + base + i - 1);
    const Agg it = {first, min(max(o[2], 0), COUNT_CAP), (unsigned)o[3], (unsigned)o[4],
                    (unsigned)o[5]};
    a = combine(a, it);
  }
  // exclusive scan over the threads
  Agg inc = a;
  for (int dl = 1; dl < 32; dl <<= 1) {
    const Agg o = shfl_up(inc, dl);
    if (lane >= dl) inc = combine(o, inc);
  }
  if (lane == 31) warp_tot[warp] = inc;
  Agg exc = shfl_up(inc, 1);
  if (lane == 0) exc = {0, 0, 0u, 0u, 0u};
  __syncthreads();
  if (warp == 0) {
    Agg w = warp_tot[lane];
    for (int dl = 1; dl < 32; dl <<= 1) {
      const Agg o = shfl_up(w, dl);
      if (lane >= dl) w = combine(o, w);
    }
    Agg we = shfl_up(w, 1);
    if (lane == 0) we = {0, 0, 0u, 0u, 0u};
    warp_tot[lane] = we;
  }
  __syncthreads();
  Agg run = combine(warp_tot[warp], exc);
#pragma unroll 4
  for (int i = i0; i < i1; ++i) {
    const int* o = rec + (long long)i * REC_WORDS;
    const int s = __ldg(subseg + base + i) - seg_lo;
    if (i == 0 || s != __ldg(subseg + base + i - 1) - seg_lo) run = {1, 0, 0u, 0u, 0u};
    int* st = start + (long long)i * START_WORDS;
    st[0] = run.n;
    st[1] = (int)run.d0;
    st[2] = (int)run.d1;
    st[3] = (int)run.d2;
    if (o[6]) {
      const Desc d = load_desc<PROG>(bt.seg, seg_lo + s, bt.scan, bt.huff, bt.plane_block0,
                                     bt.plane);
      if ((long long)run.n + max(o[7], 0) < d.T) atomicMin(first_ev + s, base + i);
    }
    run = combine(run, {0, min(max(o[2], 0), COUNT_CAP), (unsigned)o[3], (unsigned)o[4],
                        (unsigned)o[5]});
  }
}

// one thread per subsequence: its blocks' coefficients (coef zero in the
// segment's blocks on entry), and its segment's status word where the
// segment's first event lies in it
template <bool PROG>
__global__ void __launch_bounds__(WRITE_THREADS)
write_kernel(Batch bt, int seg_lo, const int* __restrict__ sub0,
             const int* __restrict__ subseg, int n_sub, int subseq_bits, const int* rec_all,
             const int* ctl, const int* start, const int* first_ev, short* coef, int* status) {
  extern __shared__ int stab[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int base = __ldg(sub0);
  const int* rec = rec_all + (long long)(ctl[5] % 3) * n_sub * REC_WORDS;
  int s = 0, j = 0;
  bool work = false;
  const int* st = start + (long long)i * START_WORDS;
  if (i < n_sub) {
    s = __ldg(subseg + base + i) - seg_lo;
    j = base + i - __ldg(sub0 + s);
    work = base + i <= first_ev[s];  // not after the event that ends the segment
  }
  const int key = block_tables<PROG>(bt, subseg, base + blockIdx.x * blockDim.x,
                                     __syncthreads_or(work), stab);
  if (!work) return;
  Desc d = load_desc<PROG>(bt.seg, seg_lo + s, bt.scan, bt.huff, bt.plane_block0, bt.plane);
  if (st[0] >= d.T) return;  // fill bits past the segment's last block
  tables_shared<PROG>(d, bt, key, stab);
  const int p = rec[(long long)i * REC_WORDS + 8], ck = rec[(long long)i * REC_WORDS + 9];
  unsigned pred[3] = {(unsigned)st[1], (unsigned)st[2], (unsigned)st[3]};
  Bits b;
  init_bits(b, bt.words, d.byte0, d.nbits, p);
  Run run = {ck & 255, ck >> 8, 0, {0u, 0u, 0u}, 0, 0};
  const bool last = base + i == __ldg(sub0 + s + 1) - 1;
  const int stop = last ? 0x7FFFFFFF : (int)min((long long)(j + 1) * subseq_bits,
                                                (long long)d.nbits);
  par_run<true>(d, b, run, stop, coef, st[0], pred);
  if (run.ev) status[seg_lo + s] = run.ev;
}

// the launches, for a .cu that instantiates them with PROG
template <bool PROG>
int launch_sync(Batch bt, int seg_lo, const int* sub0, const int* subseg, int n_sub,
                int max_rounds, int subseq_bits, int* rec, int* ctl, cudaStream_t stream) {
  const size_t smem = table_words<PROG>() * sizeof(int);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sync_kernel<PROG>, SYNC_THREADS, smem);
  int grid = (n_sub + SYNC_THREADS - 1) / SYNC_THREADS;
  if (grid > per_sm * sms) grid = per_sm * sms;
  if (grid < 1) grid = 1;
  void* args[] = {&bt, &seg_lo, &sub0, &subseg, &n_sub, &max_rounds, &subseq_bits, &rec, &ctl};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)sync_kernel<PROG>, grid,
                                                    SYNC_THREADS, args, smem, stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <bool PROG>
int launch_scan(Batch bt, int seg_lo, const int* sub0, const int* subseg, int n_sub,
                const int* rec, const int* ctl, int* start, int* first_ev, cudaStream_t stream) {
  scan_kernel<PROG><<<1, SCAN_THREADS, 0, stream>>>(bt, seg_lo, sub0, subseg, n_sub, rec, ctl,
                                                    start, first_ev);
  return (int)cudaGetLastError();
}

template <bool PROG>
int launch_write(Batch bt, int seg_lo, const int* sub0, const int* subseg, int n_sub,
                 int subseq_bits, const int* rec, const int* ctl, const int* start,
                 const int* first_ev, short* coef, int* status, cudaStream_t stream) {
  write_kernel<PROG><<<(n_sub + WRITE_THREADS - 1) / WRITE_THREADS, WRITE_THREADS,
                       table_words<PROG>() * sizeof(int), stream>>>(
      bt, seg_lo, sub0, subseg, n_sub, subseq_bits, rec, ctl, start, first_ev, coef, status);
  return (int)cudaGetLastError();
}
