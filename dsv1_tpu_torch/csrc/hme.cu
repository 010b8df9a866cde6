// Hierarchical motion estimation search on pixels packed four to a word.
//
// Replaces the Pallas TPU kernels of dsv1_tpu/ops/pallas_hme.py:
//   `_refine_kernel` (pallas_hme.py:130): one coarse pyramid level, per
//     motion block the masked SAD of up to NC candidate MVs (>> level)
//     with border-validity bounds and a strict first-minimum pick, the
//     full-pel clamp, then the 9-point XF/YF refine (hme.c:452-541).
//     -> hme_level_kernel. `dsv1_hme_coarse` launches it once per level,
//     levels..1, back to back on one stream (a GOP's whole coarse pyramid
//     in one C call): each block builds its own NC = 6 candidates from
//     the level above's field in device memory and writes its field
//     entry (dx, dy << level, 0 outside the frame); `hme_cands_kernel`
//     then writes the level-0 candidates. `dsv1_hme_refine` runs one
//     level on given candidates.
//   `_base_kernel` (pallas_hme.py:339) and its banded form (:662): level 0
//     at effort 0, the same search, the 8-point half-pel refine on 14x14
//     windows with the 4-tap luma filters, the block texture/variance
//     statistics with the reference's u32 wrap, the zero-MV intra test,
//     the luma GO_INTRA cascade and the quadrant good/evil metric
//     (hme.c:543-716). -> hme_base_kernel. The band exists on the TPU
//     only to fit VMEM; with E = 64 its clamp never binds, so one kernel
//     serves both.
//
// Bound on an H100: integer work and latency, not bytes. A 1080p GOP's
// level 0 (11 pairs, 690 blocks of 64x48) reads 54 MB of planes at most
// once (16 us at 3.35 TB/s) but compares each block pixel with 6
// candidates and 9 refine points and reduces about 40 sums per block;
// counted four pixels to an instruction, as below, that is 0.027 ms of
// INT32 work (0.108 ms as scalar pixel operations).
// The coarse levels have few blocks (44 at level 4), so their time is one
// block's latency, paid once per level.
//
// Design:
// - One motion block per thread block. Each thread owns one 4-pixel
//   word column (wc = tid % (BW/4)) and the rows tid / (BW/4) + i * step:
//   the mapping is computed once, not per pixel. Source and zero-MV
//   windows start on a word (the wrapper checks that E, S, BW and the
//   planes are word-aligned) and load as words; a candidate or refine
//   window at any column loads the aligned words around it and realigns
//   them with __funnelshift_r (the shift is the same for the whole block,
//   so the extra word is loaded only where needed). Byte masks cut the
//   partial right column; rows past the frame are skipped.
// - SADs and sums are packed: __vabsdiffu4 + __dp4a(., 0x01010101) for
//   SADs (on sm_90a the native VABSDIFF4.U8 and IDP.4A.U8.U8, read with
//   cuobjdump -sass; __vminu4 and __vcmpgtu4 are emulated in 8 and 4
//   instructions), __dp4a(x, x) for sums of squares; the quadrant table
//   (192/128/96/0) is one __byte_perm on the packed differences.
// - One pass computes the candidate SADs together with every sum that
//   does not depend on the search (block and zero-MV sums, gradients,
//   quadrant good/evil, the 14x14 source statistics): 24 values, one
//   reduction. The 9-point refine and the intra test (which needs the
//   zero-MV mean) share the second. Reductions use __reduce_add_sync and
//   one barrier each.
// - The half-pel stage filters the 18x18 corner of the 24x24
//   neighbourhood that its windows read once into shared memory (h, v
//   and diagonal planes, as the plain version's hu/h8/v8/d8); each warp
//   sums two of the 8 points' SADs, and warp 0 alone takes the chosen
//   window's statistics and writes the outputs.
// - Window origins are clamped into the unpadded extended (EH, S) plane
//   exactly as the Pallas bodies clamp (the C reference reads out of
//   bounds there); picks are strict first minima in candidate order;
//   unsigned arithmetic is plain uint32_t.
// - Launch shape: kNT = 128 threads and __launch_bounds__(128, 8)
//   (kMinBlocks), for both search kernels. Of seven (threads, blocks per
//   SM) shapes it was the fastest at 64x48 (1080p) and 64x64 (4K) blocks
//   and within 2 % of the fastest at 16x16 (CIF) on an H100 (PERF.md;
//   tools/torch_hme_probe.py builds and times the others from patched
//   copies of this file): the level-0 kernel is latency-bound, and at
//   its natural 144 registers only 3 blocks fit an SM; capped at 64 it
//   runs 8 and spills 68 bytes.
//   ptxas -v (sm_90a): hme_base_kernel 64 registers, 68 B spill stores
//   and loads, 10,680 B shared; hme_level_kernel 56 registers, no
//   spills, 288 B shared; hme_cands_kernel 26 registers.

#include "common.cuh"

using namespace dsv1;

namespace {

constexpr int kNT = 128, kMinBlocks = 8;  // launch shape (see above)
constexpr int kWarpsNT = kNT / 32;
constexpr int kMaxBlk = 64;          // MAX_BLOCK_SIZE
constexpr int kMaxWpr = kMaxBlk / 4; // words per block row
// rows a thread owns in a block row of <= 16 words
constexpr int kRows = kMaxBlk / (kNT / kMaxWpr);
constexpr int kMaxNC = 6;            // zero MV + 5 parent candidates
constexpr int kHP = 14;              // HP_SAD_SZ
constexpr int kNB = 24;              // half-pel neighbourhood (its clamp)
constexpr int kNU = 18;              // the part of it the filters read
constexpr int kPS = 16;              // row stride of the filtered planes
constexpr unsigned kOnes = 0x01010101u;

__constant__ int XF[9] = {0, 1, -1, 0, 0, -1, 1, -1, 1};
__constant__ int YF[9] = {0, 0, 0, 1, -1, -1, -1, 1, 1};
__constant__ int XH[8] = {1, -1, 0, 0, -1, 1, -1, 1};
__constant__ int YH[8] = {0, 0, 1, -1, -1, -1, 1, 1};
__constant__ int PTX[5] = {0, -2, 2, 0, 0};  // parent offsets (hme.c:454)
__constant__ int PTY[5] = {0, 0, 0, -2, 2};

// Index k of the 9-point refine for the offset (dx, dy) (XF/YF order).
__host__ __device__ constexpr int idx9(int dx, int dy) {
  return dy == 0    ? (dx == 0 ? 0 : dx == 1 ? 1 : 2)
         : dx == 0  ? (dy == 1 ? 3 : 4)
         : dy == -1 ? (dx == -1 ? 5 : 6)
                    : (dx == -1 ? 7 : 8);
}

__device__ __forceinline__ unsigned bytes_below(int n) {
  return n <= 0 ? 0u : n >= 4 ? ~0u : (1u << (8 * n)) - 1u;
}

// The bytes of word column wc (columns 4 wc .. 4 wc + 3) in [lo, hi).
__device__ __forceinline__ unsigned col_mask(int wc, int lo, int hi) {
  return bytes_below(hi - 4 * wc) & ~bytes_below(lo - 4 * wc);
}

__device__ __forceinline__ unsigned absdiff4(unsigned a, unsigned b) {
  return __vabsdiffu4(a, b);
}

__device__ __forceinline__ unsigned sum4(unsigned x, unsigned acc) {
  return __dp4a(x, kOnes, acc);
}

__device__ __forceinline__ const unsigned* word_row(const uint8_t* plane,
                                                    int S, int r, int c) {
  return reinterpret_cast<const unsigned*>(plane + (int64_t)r * S + c);
}

// The quadrant metric's per-pixel terms of four packed |src - zero|
// bytes d: the `good` table (0 -> 192, 1 -> 128, 2 -> 96, else 0) and
// the `evil` value (d where d > 2).
__device__ __forceinline__ void quad_bytes(unsigned d, unsigned& good,
                                           unsigned& evil) {
  const unsigned m = __vminu4(d, 0x03030303u);
  const unsigned sel = (m & 0x3u) | ((m >> 4) & 0x30u) |
                       ((m >> 8) & 0x300u) | ((m >> 12) & 0x3000u);
  good = __byte_perm(0x006080C0u, 0u, sel);
  evil = d & __vcmpgtu4(d, 0x02020202u);
}

// Sums v[0..N) over the thread block; every thread receives the totals.
// red: __shared__ N * kWarpsNT words used by this call only (one barrier).
template <int N>
__device__ __forceinline__ void block_sum_u(unsigned (&v)[N],
                                            unsigned* red) {
  constexpr int kW = kWarpsNT;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = __reduce_add_sync(0xffffffffu, v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) red[k * kW + wid] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    unsigned s = 0;
#pragma unroll
    for (int i = 0; i < kW; ++i) s += red[k * kW + i];
    v[k] = s;
  }
}

struct Block {
  int bx, by, bw_c, bh_c;
  bool inframe;
};

__device__ __forceinline__ Block block_of(int t, int nbh_l, int BW, int BH,
                                          int w, int h) {
  Block b;
  b.bx = (t % nbh_l) * BW;
  b.by = (t / nbh_l) * BH;
  b.inframe = b.bx < w && b.by < h;
  b.bw_c = clampi(w - b.bx, 0, BW);
  b.bh_c = clampi(h - b.by, 0, BH);
  return b;
}

// This thread's word column of a BW-wide window and its rows
// r0 + i * step (i < kRows), of which those below `nrows` (the block's
// rows inside the frame) are live. `cm` masks the columns inside it.
struct Lanes {
  int wc, r0, step, nrows;
  unsigned cm;
};

__device__ __forceinline__ Lanes lanes_of(int BW, const Block& b) {
  const int wpr = BW >> 2;
  Lanes m;
  m.wc = threadIdx.x % wpr;
  m.r0 = threadIdx.x / wpr;
  m.step = kNT / wpr;
  m.nrows = m.r0 < m.step ? b.bh_c : 0;  // threads past the last pass idle
  m.cm = col_mask(m.wc, 0, b.bw_c);
  return m;
}

// This thread's words of the word-aligned BH x BW window at (r, c).
template <int R>
__device__ __forceinline__ void load_words(unsigned (&s)[R],
                                           const uint8_t* plane, int S,
                                           int r, int c, const Lanes& m) {
  const unsigned* q = word_row(plane, S, r, c) + m.wc;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int rr = m.r0 + i * m.step;
    s[i] = rr < m.nrows ? __ldg(q + (int64_t)rr * (S >> 2)) : 0u;
  }
}

// This thread's part of the SAD between its source words and the
// BH x BW window at (rr, cc), cc at any column.
template <int R>
__device__ __forceinline__ unsigned window_sad(const uint8_t* plane, int S,
                                               int rr, int cc,
                                               const unsigned (&s)[R],
                                               const Lanes& m) {
  const int sh = 8 * (cc & 3);
  const unsigned* q = word_row(plane, S, rr, cc & ~3) + m.wc;
  unsigned acc = 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = m.r0 + i * m.step;
    if (r < m.nrows) {
      const unsigned* p = q + (int64_t)r * (S >> 2);
      const unsigned lo = __ldg(p), hi = sh ? __ldg(p + 1) : 0u;
      acc = sum4(absdiff4(s[i], __funnelshift_r(lo, hi, sh)) & m.cm, acc);
    }
  }
  return acc;
}

// This thread's part of the 9 refine SADs (a9 in XF/YF order) against the
// (BH + 2) x (BW + 2) window at (rr, cc): three rows of three shifts.
template <int R, int N>
__device__ __forceinline__ void refine9(const uint8_t* plane, int S, int rr,
                                        int cc, const unsigned (&s)[R],
                                        const Lanes& m, unsigned (&a9)[N]) {
  const int sh = 8 * (cc & 3);
  const unsigned* q = word_row(plane, S, rr, cc & ~3) + m.wc;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = m.r0 + i * m.step;
    if (r >= m.nrows) continue;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const unsigned* p = q + (int64_t)(r + dy) * (S >> 2);
      const unsigned w0 = __ldg(p), w1 = __ldg(p + 1);
      const unsigned w2 = sh == 24 ? __ldg(p + 2) : 0u;
      const unsigned lo = __funnelshift_r(w0, w1, sh);
      const unsigned hi = __funnelshift_r(w1, w2, sh);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int k = idx9(dx - 1, dy - 1);
        a9[k] = sum4(absdiff4(s[i], __funnelshift_r(lo, hi, 8 * dx)) & m.cm,
                     a9[k]);
      }
    }
  }
}

// Candidate k of a block at level `level`, grid index t: slot 0 the zero
// MV, slots 1-5 the parent-grid neighbours PT[k - 1] in the level above's
// field (B, nb_p, 2), zero when off the grid (an all-zero parent stays
// zero) (hme.c:452-510).
__device__ __forceinline__ int2 parent_cand(const int* prev, int bb, int t,
                                            int k, int level, int nbh_l,
                                            int nbh_p, int nb_p, int nbh,
                                            int nbv) {
  if (k == 0) return make_int2(0, 0);
  const int step = 1 << level, pm = ~((step << 1) - 1);
  const int x = (((t % nbh_l) * step) & pm) + PTX[k - 1] * step;
  const int y = (((t / nbh_l) * step) & pm) + PTY[k - 1] * step;
  if (x < 0 || x >= nbh || y < 0 || y >= nbv) return make_int2(0, 0);
  const int* mv = prev + ((int64_t)bb * nb_p + (y >> (level + 1)) * nbh_p +
                          (x >> (level + 1))) * 2;
  return make_int2(mv[0], mv[1]);
}

// Where a level's candidates come from, and where its results go.
struct LevelArgs {
  const uint8_t* src;
  const uint8_t* ref;
  int64_t pstride;           // bytes between the B pairs' planes
  int EH, S, E, w, h;        // the level's extended plane and frame
  int nbh_l, nb, BW, BH, level, NC;
  const int* cm;             // (B, nb, 2 NC) given candidates, or null:
  const int* prev;           //   build them from the level above's field
  int nbh_p, nb_p, nbh, nbv; //   (B, nb_p, 2) on the full nbh x nbv grid
  int *odx, *ody, *obest;    // (B, nb) results, or null
  int* field;                // (B, nb, 2) dx, dy << level, or null
};

// Strict first-minimum candidate pick over the reduced SADs, then the
// full-pel clamp: the (dx, dy) the refine starts from, in level units.
template <int N>
__device__ __forceinline__ void pick_cand(const unsigned (&sad)[N],
                                          const int* cand, int NC,
                                          int level, const Block& b, int w,
                                          int h, int& bdx, int& bdy) {
  const int bnd = 64;  // FRAME_BORDER
  int bsad = kIntMax, bk = 0;
#pragma unroll
  for (int k = 0; k < kMaxNC; ++k) {
    if (k >= NC) break;
    const int rx = b.bx + (cand[k] >> level);
    const int ry = b.by + (cand[NC + k] >> level);
    const bool ok = rx >= -bnd && ry >= -bnd && rx + b.bw_c <= w + bnd &&
                    ry + b.bh_c <= h + bnd && b.inframe;
    const int s = ok ? (int)sad[k] : kIntMax;
    if (s < bsad) {
      bsad = s;
      bk = k;
    }
  }
  bdx = cand[bk] >> level;
  bdy = cand[NC + bk] >> level;
  bdx = min(max(bdx, -b.bw_c - b.bx), w - b.bx);
  bdy = min(max(bdy, -b.bh_c - b.by), h - b.by);
}

template <int N>
__device__ __forceinline__ void pick9(const unsigned (&a9)[N], int& best,
                                      int& m9) {
  best = kIntMax;
  m9 = 0;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if ((int)a9[k] < best) {
      best = (int)a9[k];
      m9 = k;
    }
  }
}

// Fills s_cand (x then y) for block t of pair bb; the caller synchronises.
__device__ __forceinline__ void stage_cands(const LevelArgs& a, int bb,
                                            int t, int* s_cand) {
  const int k = threadIdx.x;
  if (k >= a.NC) return;
  if (a.cm) {
    const int* c = a.cm + ((int64_t)bb * a.nb + t) * 2 * a.NC;
    s_cand[k] = c[k];
    s_cand[a.NC + k] = c[a.NC + k];
  } else {
    const int2 v = parent_cand(a.prev, bb, t, k, a.level, a.nbh_l, a.nbh_p,
                               a.nb_p, a.nbh, a.nbv);
    s_cand[k] = v.x;
    s_cand[a.NC + k] = v.y;
  }
}

__global__ void __launch_bounds__(kNT, kMinBlocks)
    hme_level_kernel(LevelArgs a) {
  constexpr int R = kRows;
  __shared__ unsigned red_c[kMaxNC * kWarpsNT], red_9[9 * kWarpsNT];
  __shared__ int s_cand[2 * kMaxNC];
  const int t = blockIdx.x, bb = blockIdx.y;
  const uint8_t* sp = a.src + bb * a.pstride;
  const uint8_t* rp = a.ref + bb * a.pstride;
  const Block b = block_of(t, a.nbh_l, a.BW, a.BH, a.w, a.h);
  const Lanes m = lanes_of(a.BW, b);
  unsigned s[R];
  load_words(s, sp, a.S, clampi(a.E + b.by, 0, (a.EH - a.BH) & ~7),
             clampi(a.E + b.bx, 0, a.S - a.BW), m);
  stage_cands(a, bb, t, s_cand);
  __syncthreads();

  unsigned sad[kMaxNC] = {0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < kMaxNC; ++k) {
    if (k >= a.NC) break;
    sad[k] = window_sad(
        rp, a.S, clampi(a.E + b.by + (s_cand[a.NC + k] >> a.level), 0,
                        a.EH - a.BH),
        clampi(a.E + b.bx + (s_cand[k] >> a.level), 0, a.S - a.BW), s, m);
  }
  block_sum_u(sad, red_c);
  int bdx, bdy;
  pick_cand(sad, s_cand, a.NC, a.level, b, a.w, a.h, bdx, bdy);

  unsigned a9[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  refine9(rp, a.S, clampi(a.E + b.by + bdy - 1, 0, a.EH - (a.BH + 2)),
          clampi(a.E + b.bx + bdx - 1, 0, a.S - (a.BW + 2)), s, m, a9);
  block_sum_u(a9, red_9);
  if (threadIdx.x != 0) return;
  int best, m9;
  pick9(a9, best, m9);
  const int dx = bdx + XF[m9], dy = bdy + YF[m9];
  const int64_t o = (int64_t)bb * a.nb + t;
  if (a.odx) {
    a.odx[o] = dx;
    a.ody[o] = dy;
    a.obest[o] = best;
  }
  if (a.field) {
    a.field[2 * o] = b.inframe ? dx * (1 << a.level) : 0;
    a.field[2 * o + 1] = b.inframe ? dy * (1 << a.level) : 0;
  }
}

// The level-0 candidates (B, nb, 2 kMaxNC) from level 1's field.
__global__ void hme_cands_kernel(const int* prev, int nbh, int nbv,
                                 int nbh_p, int nb_p, int B, int* cm) {
  const int nb = nbh * nbv;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= B * nb) return;
  const int bb = g / nb, t = g - bb * nb;
  int* o = cm + (int64_t)g * 2 * kMaxNC;
#pragma unroll
  for (int k = 0; k < kMaxNC; ++k) {
    const int2 v = parent_cand(prev, bb, t, k, 0, nbh, nbh_p, nb_p, nbh, nbv);
    o[k] = v.x;
    o[kMaxNC + k] = v.y;
  }
}

struct BaseArgs {
  const uint8_t* src;
  const uint8_t* ref;
  const int* cm;             // (B, nb, 2 NC)
  int64_t pstride;
  int EH, S, E, w, h, nbh_l, nb, BW, BH, NC;
  int *mvx, *mvy, *flags, *qbits, *ltex, *svar;
};

// Half-pel point k's 14x14 window in the filtered planes (row stride kPS):
// h8 at (2, 1 + (xh >> 1)), v8 at (1 + (yh >> 1), 2), d8 at
// (1 + (yh >> 1), 1 + (xh >> 1)), as the plain version slices them.
__device__ __forceinline__ const uint8_t* hp_window(int k, const uint8_t* h8,
                                                    const uint8_t* v8,
                                                    const uint8_t* d8) {
  const int xh = XH[k], yh = YH[k];
  if ((xh & 1) && (yh & 1)) return d8 + (1 + (yh >> 1)) * kPS + 1 + (xh >> 1);
  if (xh & 1) return h8 + 2 * kPS + 1 + (xh >> 1);
  return v8 + (1 + (yh >> 1)) * kPS + 2;
}

__global__ void __launch_bounds__(kNT, kMinBlocks)
    hme_base_kernel(BaseArgs a) {
  constexpr int R = kRows, kW = kWarpsNT;
  __shared__ unsigned s_src[kMaxBlk * kMaxWpr], s_zero[kMaxBlk * kMaxWpr];
  __shared__ uint8_t s_c14[kHP * kHP];
  __shared__ uint8_t s_nb[kNU * kNU];
  __shared__ short s_hu[kNU * kPS];
  __shared__ uint8_t s_h8[kNU * kPS], s_v8[15 * kPS], s_d8[15 * kPS];
  enum { LS = kMaxNC, LSS, LSH, LSV, ZS, ZSS, G0, G1, G2, G3, E0, E1, E2, E3,
         SS, SSS, SSH, SSV, N1 };
  __shared__ unsigned red1[N1 * kW], red2[10 * kW];
  __shared__ int s_cand[2 * kMaxNC], s_a8[8];
  const int t = blockIdx.x, bb = blockIdx.y, tid = threadIdx.x;
  const int S = a.S, E = a.E, EH = a.EH, BW = a.BW, BH = a.BH, NC = a.NC;
  const uint8_t* sp = a.src + bb * a.pstride;
  const uint8_t* rp = a.ref + bb * a.pstride;
  const Block b = block_of(t, a.nbh_l, BW, BH, a.w, a.h);
  const Lanes m = lanes_of(BW, b);
  const int wpr = BW >> 2;

  // --- stage: source and zero-MV windows (words), 14x14 centre, cands
  const int zr = clampi(E + b.by, 0, (EH - BH) & ~7);
  const int zc = clampi(E + b.bx, 0, S - BW);
  unsigned s[R], z[R];
  load_words(s, sp, S, zr, zc, m);
  load_words(z, rp, S, zr, zc, m);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = m.r0 + i * m.step;
    if (r < m.nrows) {
      s_src[r * wpr + m.wc] = s[i];
      s_zero[r * wpr + m.wc] = z[i];
    }
  }
  const int cx = b.bx + (b.bw_c >> 1) - kHP / 2;
  const int cy = b.by + (b.bh_c >> 1) - kHP / 2;
  {
    const uint8_t* c14 = sp + (int64_t)clampi(E + cy, 0, EH - kHP) * S +
                         clampi(E + cx, 0, S - kHP);
    for (int p = tid; p < kHP * kHP; p += kNT) {
      const int i = p / kHP;
      s_c14[p] = __ldg(c14 + (int64_t)i * S + p - i * kHP);
    }
  }
  if (tid < NC) {
    const int* c = a.cm + ((int64_t)bb * a.nb + t) * 2 * NC;
    s_cand[tid] = c[tid];
    s_cand[NC + tid] = c[NC + tid];
  }
  __syncthreads();

  // --- pass 1: candidate SADs and every search-independent sum
  unsigned v[N1];
#pragma unroll
  for (int k = 0; k < N1; ++k) v[k] = 0;
#pragma unroll
  for (int k = 0; k < kMaxNC; ++k) {
    if (k >= NC) break;
    v[k] = window_sad(rp, S, clampi(E + b.by + s_cand[NC + k], 0, EH - BH),
                      clampi(E + b.bx + s_cand[k], 0, S - BW), s, m);
  }
  const int sbw = b.bw_c / 2, sbh = b.bh_c / 2;
  const unsigned cml = col_mask(m.wc, 1, b.bw_c);
  const unsigned q0 = col_mask(m.wc, 0, sbw);
  const unsigned q1 = col_mask(m.wc, sbw, 2 * sbw);
  const unsigned q0l = col_mask(m.wc, 1, sbw);
  const unsigned q1l = col_mask(m.wc, sbw + 1, 2 * sbw);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = m.r0 + i * m.step;
    if (r >= m.nrows) continue;
    const unsigned sw = s[i], zw = z[i];
    const unsigned sm = sw & m.cm, zm = zw & m.cm;
    v[LS] = sum4(sm, v[LS]);
    v[LSS] = __dp4a(sm, sm, v[LSS]);
    v[ZS] = sum4(zm, v[ZS]);
    v[ZSS] = __dp4a(zm, zm, v[ZSS]);
    // left neighbours: the previous word's last byte, then this word's
    const unsigned sl = m.wc ? s_src[r * wpr + m.wc - 1] : 0u;
    const unsigned zl = m.wc ? s_zero[r * wpr + m.wc - 1] : 0u;
    const unsigned dhs = absdiff4(sw, __byte_perm(sl, sw, 0x6543));
    const unsigned dhz = absdiff4(zw, __byte_perm(zl, zw, 0x6543));
    v[LSH] = sum4(dhs & cml, v[LSH]);
    unsigned dvs = 0, dvz = 0;
    if (r >= 1) {
      dvs = absdiff4(sw, s_src[(r - 1) * wpr + m.wc]);
      dvz = absdiff4(zw, s_zero[(r - 1) * wpr + m.wc]);
      v[LSV] = sum4(dvs & m.cm, v[LSV]);
    }
    if (r < 2 * sbh) {  // inside a quadrant row
      const bool qy = r >= sbh;
      const bool vert = r - (qy ? sbh : 0) >= 1;
      unsigned good, evil;
      quad_bytes(absdiff4(sw, zw), good, evil);
      unsigned g0 = sum4(good & q0, sum4(dhs & q0l, sum4(dhz & q0l, 0u)));
      unsigned g1 = sum4(good & q1, sum4(dhs & q1l, sum4(dhz & q1l, 0u)));
      if (vert) {
        g0 = sum4(dvs & q0, sum4(dvz & q0, g0));
        g1 = sum4(dvs & q1, sum4(dvz & q1, g1));
      }
      const unsigned e0 = sum4(evil & q0, 0u), e1 = sum4(evil & q1, 0u);
      if (qy) {
        v[G2] += g0;
        v[G3] += g1;
        v[E2] += e0;
        v[E3] += e1;
      } else {
        v[G0] += g0;
        v[G1] += g1;
        v[E0] += e0;
        v[E1] += e1;
      }
    }
  }
  for (int p = tid; p < kHP * kHP; p += kNT) {
    const int i = p / kHP, j = p - i * kHP;
    const int sv = s_c14[p];
    v[SS] += sv;
    v[SSS] += sv * sv;
    if (j >= 1) v[SSH] += absi(sv - s_c14[p - 1]);
    if (i >= 1) v[SSV] += absi(sv - s_c14[p - kHP]);
  }
  block_sum_u(v, red1);
  int bdx, bdy;
  pick_cand(v, s_cand, NC, 0, b, a.w, a.h, bdx, bdy);

  // --- pass 2: 9-point refine and block_intra_test (hme.c:143-178): a
  // pixel survives a DC-only block iff s - ravg0 lies in [-128, 127]
  const int yarea = b.bw_c * b.bh_c;
  const int area = max(yarea, 1);
  const int ravg0 = (int)v[ZS] / area;
  unsigned v2[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  refine9(rp, S, clampi(E + b.by + bdy - 1, 0, EH - (BH + 2)),
          clampi(E + b.bx + bdx - 1, 0, S - (BW + 2)), s, m, v2);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = m.r0 + i * m.step;
    if (r >= m.nrows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = (int)((s[i] >> (8 * j)) & 255u) - ravg0;
      v2[9] += ((m.cm >> (8 * j)) & 1u) && (d < -128 || d > 127);
    }
  }
  block_sum_u(v2, red2);
  int best, m9;
  pick9(v2, best, m9);
  const int dx = bdx + XF[m9], dy = bdy + YF[m9];

  // --- half-pel refine (hme.c:543-597): filter the neighbourhood once
  {
    const uint8_t* nbp = rp +
                         (int64_t)clampi(E + cy + dy - 2, 0, EH - kNB) * S +
                         clampi(E + cx + dx - 2, 0, S - kNB);
    for (int p = tid; p < kNU * kNU; p += kNT) {
      const int i = p / kNU;
      s_nb[p] = __ldg(nbp + (int64_t)i * S + p - i * kNU);
    }
  }
  __syncthreads();
  // hu (rows 0..17, cols 0..14) with h8 = its clamp, v8 (rows 0..14)
  for (int p = tid; p < kNU * 15 + 15 * kPS; p += kNT) {
    if (p < kNU * 15) {
      const int i = p / 15, j = p - i * 15;
      const uint8_t* n = s_nb + i * kNU + j;
      const int hu = 9 * (n[1] + n[2]) - (n[0] + n[3]);
      s_hu[i * kPS + j] = (short)hu;
      s_h8[i * kPS + j] = (uint8_t)clampi((hu + 8) >> 4, 0, 255);
    } else {
      const int q = p - kNU * 15, i = q / kPS, j = q - i * kPS;
      const uint8_t* n = s_nb + i * kNU + j;
      const int vv = 9 * (n[kNU] + n[2 * kNU]) - (n[0] + n[3 * kNU]);
      s_v8[q] = (uint8_t)clampi((vv + 8) >> 4, 0, 255);
    }
  }
  __syncthreads();
  for (int p = tid; p < 15 * 15; p += kNT) {  // d8 (rows, cols 0..14)
    const int i = p / 15, j = p - i * 15;
    const short* u = s_hu + i * kPS + j;
    const int d = 9 * (u[kPS] + u[2 * kPS]) - (u[0] + u[3 * kPS]);
    s_d8[i * kPS + j] = (uint8_t)clampi((d + 128) >> 8, 0, 255);
  }
  __syncthreads();
  const int lane = tid & 31, wid = tid >> 5;
  for (int k = wid; k < 8; k += kW) {
    const uint8_t* win = hp_window(k, s_h8, s_v8, s_d8);
    unsigned acc = 0;
    for (int p = lane; p < kHP * kHP; p += 32) {
      const int i = p / kHP, j = p - i * kHP;
      acc += absi((int)s_c14[p] - (int)win[i * kPS + j]);
    }
    acc = __reduce_add_sync(0xffffffffu, acc);
    if (lane == 0) s_a8[k] = (int)acc;
  }
  __syncthreads();
  if (wid != 0) return;  // warp 0 finishes the block

  const int yareasq = yarea * yarea;
  const bool do_hp = best > BW * BH && b.inframe;
  int run_best = best * (kHP * kHP) / area, run_m = -1;
  for (int k = 0; k < 8; ++k) {
    if (s_a8[k] < run_best) {
      run_best = s_a8[k];
      run_m = k;
    }
  }
  const bool hp_hit = do_hp && run_m >= 0;
  const int mvx = 2 * dx + (hp_hit ? XH[run_m] : 0);
  const int mvy = 2 * dy + (hp_hit ? YH[run_m] : 0);
  if (hp_hit) best = run_best * yarea / (kHP * kHP);

  // --- the chosen window's statistics (warp 0)
  const uint8_t* sel = s_nb + 2 * kNU + 2;
  int ss = kNU;
  if (hp_hit) {
    sel = hp_window(run_m, s_h8, s_v8, s_d8);
    ss = kPS;
  }
  unsigned rs = 0, rss = 0, rsh = 0, rsv = 0;
  for (int p = lane; p < kHP * kHP; p += 32) {
    const int i = p / kHP, j = p - i * kHP;
    const int rv = sel[i * ss + j];
    rs += rv;
    rss += rv * rv;
    if (j >= 1) rsh += absi(rv - sel[i * ss + j - 1]);
    if (i >= 1) rsv += absi(rv - sel[(i - 1) * ss + j]);
  }
  rs = __reduce_add_sync(0xffffffffu, rs);
  rss = __reduce_add_sync(0xffffffffu, rss);
  rsh = __reduce_add_sync(0xffffffffu, rsh);
  rsv = __reduce_add_sync(0xffffffffu, rsv);
  if (lane != 0) return;

  const unsigned n14 = kHP * kHP;
  const int rtex = (int)(rsh + rsv) / 2 / (int)n14;
  const int ravg = (int)rs / (int)n14;
  const int rvar = (int)(rss - rs * rs / n14);
  const int stex = (int)(v[SSH] + v[SSV]) / 2 / (int)n14;
  const int savg = (int)v[SS] / (int)n14;
  const int svar = (int)(v[SSS] - v[SS] * v[SS] / n14);
  const int luma_tex = (int)(v[LSH] + v[LSV]) / 2 / area;
  const unsigned luma_var = v[LSS] - v[LS] * v[LS] / (unsigned)area;
  const unsigned zvar = v[ZSS] - v[ZS] * v[ZS] / (unsigned)area;
  const bool lo_tex = luma_tex <= 2 && b.inframe;
  const bool lo_var = (unsigned)yareasq > luma_var && b.inframe;
  const bool go_intra =
      (stex < 2 && zvar > luma_var * 2u) ||
      rvar > (int)((unsigned)svar * 2u) || (stex == 0 && rtex != 0) ||
      absi(savg - ravg) > 8 || (luma_tex <= 10 && best > yareasq / 16);
  const int ethr = (sbw + sbh) >> 1;
  int qb = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (stex > 1 && (int)v[G0 + q] >= ethr * (int)v[E0 + q]) qb |= 1 << q;

  const int64_t o = (int64_t)bb * a.nb + t;
  a.mvx[o] = mvx;
  a.mvy[o] = mvy;
  a.flags[o] = (go_intra ? 1 : 0) | (v2[9] > 0 ? 2 : 0) | (lo_tex ? 4 : 0) |
               (lo_var ? 8 : 0) | (hp_hit ? 16 : 0);
  a.qbits[o] = qb;
  a.ltex[o] = luma_tex;
  a.svar[o] = svar;
}

bool bad_block(int BW, int BH) {
  return BW > kMaxBlk || BH > kMaxBlk || BW < 4 || (BW & 3) || BH < 1;
}

cudaError_t launch_level(const LevelArgs& a, int B, cudaStream_t stream) {
  hme_level_kernel<<<dim3(a.nb, B), kNT, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One level on given candidates cm (B, nb, 2 NC): dx, dy, best (B, nb).
extern "C" int dsv1_hme_refine(const uint8_t* src, const uint8_t* ref,
                               const int* cm, int64_t pstride, int EH, int S,
                               int E, int w, int h, int nbh_l, int nb, int BW,
                               int BH, int NC, int level, int B, int* dx,
                               int* dy, int* best, cudaStream_t stream) {
  if (bad_block(BW, BH) || NC < 1 || NC > kMaxNC)
    return (int)cudaErrorInvalidValue;
  LevelArgs a{};
  a.src = src;
  a.ref = ref;
  a.pstride = pstride;
  a.EH = EH;
  a.S = S;
  a.E = E;
  a.w = w;
  a.h = h;
  a.nbh_l = nbh_l;
  a.nb = nb;
  a.BW = BW;
  a.BH = BH;
  a.level = level;
  a.NC = NC;
  a.cm = cm;
  a.odx = dx;
  a.ody = dy;
  a.obest = best;
  return (int)launch_level(a, B, stream);
}

// Levels `levels`..1 of a pyramid, one launch each, then the level-0
// candidates cm (B, nbh * nbv, 2 * 6). lv: per level 1..levels, eight
// int64s: src, ref (planes of pair 0), pstride, EH, S, E, w, h. fields:
// scratch of 2 B nb_l ints per level.
extern "C" int dsv1_hme_coarse(const int64_t* lv, int levels, int nbh,
                               int nbv, int BW, int BH, int B, int* fields,
                               int* cm, cudaStream_t stream) {
  if (bad_block(BW, BH) || levels < 1) return (int)cudaErrorInvalidValue;
  const int* prev = nullptr;
  int nbh_p = 0, nb_p = 0;
  int64_t off = 0;
  for (int level = levels; level >= 1; --level) {
    const int64_t* p = lv + (level - 1) * 8;
    const int step = 1 << level;
    LevelArgs a{};
    a.src = reinterpret_cast<const uint8_t*>(p[0]);
    a.ref = reinterpret_cast<const uint8_t*>(p[1]);
    a.pstride = p[2];
    a.EH = (int)p[3];
    a.S = (int)p[4];
    a.E = (int)p[5];
    a.w = (int)p[6];
    a.h = (int)p[7];
    a.nbh_l = (nbh + step - 1) / step;
    a.nb = a.nbh_l * ((nbv + step - 1) / step);
    a.BW = BW;
    a.BH = BH;
    a.level = level;
    a.NC = prev ? kMaxNC : 1;
    a.prev = prev;
    a.nbh_p = nbh_p;
    a.nb_p = nb_p;
    a.nbh = nbh;
    a.nbv = nbv;
    a.field = fields + off;
    const cudaError_t err = launch_level(a, B, stream);
    if (err != cudaSuccess) return (int)err;
    prev = a.field;
    nbh_p = a.nbh_l;
    nb_p = a.nb;
    off += (int64_t)2 * B * a.nb;
  }
  const int n = B * nbh * nbv;
  hme_cands_kernel<<<(n + 255) / 256, 256, 0, stream>>>(prev, nbh, nbv, nbh_p,
                                                        nb_p, B, cm);
  return (int)cudaGetLastError();
}

extern "C" int dsv1_hme_base(const uint8_t* src, const uint8_t* ref,
                             const int* cm, int64_t pstride, int EH, int S,
                             int E, int w, int h, int nbh_l, int nb, int BW,
                             int BH, int NC, int B, int* mvx, int* mvy,
                             int* flags, int* qbits, int* ltex, int* svar,
                             cudaStream_t stream) {
  if (bad_block(BW, BH) || NC < 1 || NC > kMaxNC)
    return (int)cudaErrorInvalidValue;
  BaseArgs a{src, ref, cm, pstride, EH, S, E, w, h, nbh_l, nb, BW, BH, NC,
             mvx, mvy, flags, qbits, ltex, svar};
  hme_base_kernel<<<dim3(nb, B), kNT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
