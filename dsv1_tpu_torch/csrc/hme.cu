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
//     only to fit VMEM, so one kernel serves both.
// and, with no Pallas kernel behind it, the XLA level 0 of effort 1..3
// (the JAX package's refine_base with `pre`, dsv1_tpu/ops/hme.py:324-420,
// after `_refine_kernel` at level 0 gives dx, dy, best): an exhaustive
// +-2 effort full-pel window around (dx, dy) scanned raster with strict
// improvement, a +-(1 + effort) half-pel grid in place of the 8
// neighbours, then the same luma cascade. -> hme_wide_kernel
// (`dsv1_hme_wide`).
//
// Bound on an H100: integer work and latency. A 1080p GOP's level 0 (11
// pairs, 690 blocks of 64x48) reads 54 MB of planes at most once (16 us
// at 3.35 TB/s) and compares each block pixel with 6 candidates and 9
// refine points and reduces about 40 sums per block; counted as
// chip_smoke.py hme_bounds counts it (a 4-pixel SAD one
// VABSDIFF4.U8.ACC, other u8 ops four pixels to an instruction), that
// is 0.016 ms of INT32 work too (0.085 ms as scalar pixel operations).
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
// - Every window is read at its own origin from the flat image the
//   (EH, S) plane lies in, as the JAX package's XLA search reads it (and
//   as the C reference reads out of bounds, with no validity checks): a
//   row past the right edge runs on into the next row, rows below the
//   plane are the next plane's bytes. No origin is clamped (the Pallas
//   bodies clamp into the extended plane, and so differ at the +-64
//   limit). The wrappers check that no window can leave the image; a
//   candidate outside the border-validity bounds is not read. Picks are
//   strict first minima in candidate order; unsigned arithmetic is plain
//   uint32_t.
// - Launch shape: kNT = 128 threads and __launch_bounds__(128, 8)
//   (kMinBlocks), for hme_level_kernel and hme_base_kernel. Of seven
//   (threads, blocks per SM) shapes it was the fastest at 64x48 (1080p)
//   and 64x64 (4K) blocks and within 2 % of the fastest at 16x16 (CIF) on
//   an H100 (PERF.md; tools/torch_hme_probe.py builds and times the
//   others from patched copies of this file): the level-0 kernel is
//   latency-bound, and at its natural 144 registers only 3 blocks fit an
//   SM; capped at 64 it runs 8.
// - hme_wide_kernel (effort 1..3, window +-R, R = 2 effort): one block
//   per motion block, 128 threads, in phases (HME_STAMP marks them for
//   tools/torch_hme_probe.py):
//   stage: every load issued before the first store: the window rows the
//     search reads (bh_c + 2R rows of the block's words + effort), one
//     aligned word per lane and row, realigned with the next lane's word
//     (a shuffle, a funnel shift), where every such word lies in the
//     image's whole chunks (there the clip reads each byte where it
//     lies), else byte by byte through the JAX gather's chunk clip (a
//     window near the image's first or last chunk); the aligned words around
//     the union of the half-pel neighbourhoods any pick can use ((21 +
//     2R)^2, from the plane as hme_base_kernel reads its one: their
//     readers take any byte offset, so no realigning); the block as
//     hme_base_kernel stages it.
//   sums: hme_base_kernel's search-independent sums in one reduction of
//     19 values, and the intra test; warp 0 reads the totals again from
//     the reduction's shared partials at the finish, so no thread holds
//     them through the search.
//   full-pel: a lane group takes two offset rows oy, oy + 1 and, down its
//     word column, meets each window row with the two block rows it
//     pairs with, at the 2R + 1 column shifts of R / 2 + 1 words: a
//     window row is loaded and shifted once for both, and a 4-pixel SAD
//     is one VABSDIFF4.U8.ACC (sad_acc; a column with bytes outside the
//     frame weighs its bytes through IDP.4A). The vertical sums stay in
//     registers, and one butterfly over the group's lanes per pair of
//     rows replaces a warp sum per offset (169 a block at effort 3). The
//     last pair (2R + 1 rows are odd) has no row oy + 1 and sums oy alone
//     where it is its warp's only pair (2 lane groups a warp, blocks
//     wider than 32); where it shares a warp its lanes run the two-row
//     body and skip b's last row, which lies past the window. At 16x16
//     blocks a warp's 8 lane groups hold every pair, so warp 0 alone
//     runs this phase: spreading the pairs over the warps would not
//     shorten a lane's row loop, and the idle warps' slots go to the
//     SM's other blocks. The raster scan's strict first improvement is
//     the least (SAD, offset) key.
//   half-pel: the picked neighbourhood filtered once in shared memory (h,
//     v and diagonal planes in 24-byte rows); a thread per grid point
//     (24, 48, 80) sums its 14 rows, 4 words each realigned from 5, with
//     sad_acc; warp 0 takes the least (SAD, point) key and finishes
//     with hme_base_kernel's code.
//   Bound: chip_smoke.py work_hme_wide and hme_bounds, the PERF.md rows'
//   count: per block pixel a SAD for each of the (4 effort + 1)^2 - 1
//   offsets and 28 ops for the statistics; per in-frame block a 14x14
//   SAD for each half-pel point, the three filtered planes once ((15 +
//   effort)^2 samples each, 9 ops a sample) and 20 ops a window pixel
//   for its statistics. A 4-pixel SAD is one VABSDIFF4.U8.ACC, which
//   issues at 62 a clock per SM, as IMAD at 64 (tools/torch_hme_probe.py
//   --kernels isa, PERF.md); every other op counts four pixels to an
//   instruction; over 132 SMs x 64 INT32 lanes x 1.98 GHz: at effort 3
//   0.0700 ms for a 1080p GOP (11 pairs, 690 blocks of 64x48), 0.277 ms
//   for a 4K GOP (2,040 blocks of 64x64, 15.7 G SAD pixels). The kernel
//   takes about 3.4 and 2.9 times that (PERF.md).
//   Launch: __launch_bounds__(128, kWideMinBlocks[effort - 1]), 8, 8 and
//   7 blocks per SM at efforts 1, 2, 3: of 4 to 8, the fastest for each
//   effort at 1080p and 4K on an H100, and within 2.6 % of the fastest
//   at CIF's 16x16 blocks (PERF.md; tools/torch_hme_probe.py
//   --wide-shapes). Staging waits a global round trip a block, so more
//   resident blocks beat the registers the caps take (they spill 28-76
//   B, below). The row loop unrolled once, not twice, ran 10 % faster at
//   these caps.
//   ptxas -v (sm_90a): hme_base_kernel 64 registers, 24 B spill stores
//   and loads, 10,680 B shared; hme_level_kernel 56 registers, no
//   spills, 288 B shared; hme_cands_kernel 26 registers; hme_wide_kernel
//   at effort 1 / 2 / 3 64 / 64 / 72 registers, 60 / 76 / 28 B spill
//   stores and loads, 18,832 / 19,776 / 20,912 B shared.

#include "common.cuh"

// Phase stamps of hme_base_kernel and hme_wide_kernel: empty here;
// tools/torch_hme_probe.py defines them in the patched copies it builds,
// to read each phase's clock64() cycles.
#ifndef HME_STAMP
#define HME_STAMP_START
#define HME_STAMP(k)
#endif

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
constexpr int kNU = 18;              // the part of it the filters read
constexpr int kPS = 16;              // row stride of the filtered planes
// the wide search's half-pel neighbourhood: its +-2-pixel grid and the
// 4-tap filters read 21 x 21 pixels 3 before the centre window; the
// filtered planes are kept in rows of 24 bytes, read as words
constexpr int kNUW = 21, kPSW = 24;
constexpr int kWinP = 24;            // hme_wide_kernel's window row, words
// hme_wide_kernel's least blocks per SM at efforts 1, 2, 3 (see above)
constexpr int kWideMinBlocks[3] = {8, 8, 7};
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

// The totals of v[K0..N) from block_sum_u's per-warp partials red.
template <int N, int K0 = 0>
__device__ __forceinline__ void block_totals(unsigned (&v)[N],
                                             const unsigned* red) {
  constexpr int kW = kWarpsNT;
#pragma unroll
  for (int k = K0; k < N; ++k) {
    unsigned s = 0;
#pragma unroll
    for (int i = 0; i < kW; ++i) s += red[(k - K0) * kW + i];
    v[k] = s;
  }
}

// Sums v[K0..N) over the thread block; every thread receives the totals.
// red: __shared__ (N - K0) * kWarpsNT words used by this call only (one
// barrier), which keep the per-warp partials (block_totals).
template <int N, int K0 = 0>
__device__ __forceinline__ void block_sum_u(unsigned (&v)[N],
                                            unsigned* red) {
  constexpr int kW = kWarpsNT;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int k = K0; k < N; ++k) v[k] = __reduce_add_sync(0xffffffffu, v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = K0; k < N; ++k) red[(k - K0) * kW + wid] = v[k];
  }
  __syncthreads();
  block_totals<N, K0>(v, red);
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

// Whether the candidate window at (rx, ry) (level pixels) lies inside the
// border-validity bounds (hme.c:512-517); only such windows are read.
__device__ __forceinline__ bool cand_ok(int rx, int ry, const Block& b, int w,
                                        int h) {
  const int bnd = 64;  // FRAME_BORDER
  return rx >= -bnd && ry >= -bnd && rx + b.bw_c <= w + bnd &&
         ry + b.bh_c <= h + bnd && b.inframe;
}

// Strict first-minimum candidate pick over the reduced SADs, then the
// full-pel clamp: the (dx, dy) the refine starts from, in level units.
template <int N>
__device__ __forceinline__ void pick_cand(const unsigned (&sad)[N],
                                          const int* cand, int NC,
                                          int level, const Block& b, int w,
                                          int h, int& bdx, int& bdy) {
  int bsad = kIntMax, bk = 0;
#pragma unroll
  for (int k = 0; k < kMaxNC; ++k) {
    if (k >= NC) break;
    const bool ok = cand_ok(b.bx + (cand[k] >> level),
                            b.by + (cand[NC + k] >> level), b, w, h);
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
  load_words(s, sp, a.S, a.E + b.by, a.E + b.bx, m);
  stage_cands(a, bb, t, s_cand);
  __syncthreads();

  unsigned sad[kMaxNC] = {0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < kMaxNC; ++k) {
    if (k >= a.NC) break;
    const int rx = b.bx + (s_cand[k] >> a.level);
    const int ry = b.by + (s_cand[a.NC + k] >> a.level);
    if (cand_ok(rx, ry, b, a.w, a.h))
      sad[k] = window_sad(rp, a.S, a.E + ry, a.E + rx, s, m);
  }
  block_sum_u(sad, red_c);
  int bdx, bdy;
  pick_cand(sad, s_cand, a.NC, a.level, b, a.w, a.h, bdx, bdy);

  unsigned a9[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  refine9(rp, a.S, a.E + b.by + bdy - 1, a.E + b.bx + bdx - 1, s, m, a9);
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

// The six per-block outputs of level 0, each (B, nb).
struct Outs {
  int *mvx, *mvy, *flags, *qbits, *ltex, *svar;
};

struct BaseArgs {
  const uint8_t* src;
  const uint8_t* ref;
  const int* cm;             // (B, nb, 2 NC)
  int64_t pstride;
  int EH, S, E, w, h, nbh_l, nb, BW, BH, NC;
  Outs out;
};

// The block sums of pass 1 that do not depend on the search, after the
// kMaxNC candidate SADs in one array: block and zero-MV sums, squares and
// gradients, the quadrant good/evil metric, the 14x14 source statistics.
enum Sum { LS = kMaxNC, LSS, LSH, LSV, ZS, ZSS, G0, G1, G2, G3, E0, E1, E2,
           E3, SS, SSS, SSH, SSV, N1 };

// Stages a block: its source and zero-MV words (s, z, and in shared
// memory s_src, s_zero) and its 14x14 source centre s_c14, from the
// (EH, S) planes sp and rp. The caller synchronises.
template <int R>
__device__ __forceinline__ void stage_block(
    const uint8_t* sp, const uint8_t* rp, int S, int E, int BW,
    int BH, const Block& b, const Lanes& m, unsigned (&s)[R],
    unsigned (&z)[R], unsigned* s_src, unsigned* s_zero, uint8_t* s_c14) {
  const int wpr = BW >> 2;
  load_words(s, sp, S, E + b.by, E + b.bx, m);
  load_words(z, rp, S, E + b.by, E + b.bx, m);
  const int cx = b.bx + (b.bw_c >> 1) - kHP / 2;
  const int cy = b.by + (b.bh_c >> 1) - kHP / 2;
  const uint8_t* c14 = sp + (int64_t)(E + cy) * S + E + cx;
  constexpr int kC = (kHP * kHP + kNT - 1) / kNT;
  uint8_t c[kC];  // every load issued before the first store
#pragma unroll
  for (int k = 0; k < kC; ++k) {
    const int p = threadIdx.x + k * kNT, i = p / kHP;
    c[k] = p < kHP * kHP ? __ldg(c14 + (int64_t)i * S + p - i * kHP) : 0;
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = m.r0 + i * m.step;
    if (r < m.nrows) {
      s_src[r * wpr + m.wc] = s[i];
      s_zero[r * wpr + m.wc] = z[i];
    }
  }
#pragma unroll
  for (int k = 0; k < kC; ++k) {
    const int p = threadIdx.x + k * kNT;
    if (p < kHP * kHP) s_c14[p] = c[k];
  }
}

// This thread's part of the search-independent sums (v[LS..SSV]) over its
// staged words; needs the staged block in shared memory.
template <int R, int N>
__device__ __forceinline__ void block_sums(unsigned (&v)[N],
                                           const unsigned (&s)[R],
                                           const unsigned (&z)[R],
                                           const Lanes& m, const Block& b,
                                           int BW, const unsigned* s_src,
                                           const unsigned* s_zero,
                                           const uint8_t* s_c14) {
  const int wpr = BW >> 2;
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
  for (int p = threadIdx.x; p < kHP * kHP; p += kNT) {
    const int i = p / kHP, j = p - i * kHP;
    const int sv = s_c14[p];
    v[SS] += sv;
    v[SSS] += sv * sv;
    if (j >= 1) v[SSH] += absi(sv - s_c14[p - 1]);
    if (i >= 1) v[SSV] += absi(sv - s_c14[p - kHP]);
  }
}

// This thread's count of block_intra_test failures (hme.c:143-178): a
// pixel survives a DC-only block iff s - ravg0 lies in [-128, 127].
template <int R>
__device__ __forceinline__ unsigned intra_fails(const unsigned (&s)[R],
                                                const Lanes& m, int ravg0) {
  unsigned n = 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = m.r0 + i * m.step;
    if (r >= m.nrows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = (int)((s[i] >> (8 * j)) & 255u) - ravg0;
      n += ((m.cm >> (8 * j)) & 1u) && (d < -128 || d > 127);
    }
  }
  return n;
}

// Filters the NU x NU half-pel neighbourhood s_nb (shared memory, row
// stride NP) into hu (NU rows, NU - 3 columns) with h8 = its clamp, v8
// (NU - 3 rows, min(PS, NU) columns) and d8 (NU - 3 square), each with
// row stride PS, as the plain version's hu/h8/v8/d8. Synchronises.
template <int NU, int PS, int NP>
__device__ __forceinline__ void filter_planes(const uint8_t* s_nb,
                                              short* s_hu, uint8_t* s_h8,
                                              uint8_t* s_v8, uint8_t* s_d8) {
  constexpr int NF = NU - 3, NV = PS < NU ? PS : NU;
  const int tid = threadIdx.x;
  for (int p = tid; p < NU * NF + NF * NV; p += kNT) {
    if (p < NU * NF) {
      const int i = p / NF, j = p - i * NF;
      const uint8_t* n = s_nb + i * NP + j;
      const int hu = 9 * (n[1] + n[2]) - (n[0] + n[3]);
      s_hu[i * PS + j] = (short)hu;
      s_h8[i * PS + j] = (uint8_t)clampi((hu + 8) >> 4, 0, 255);
    } else {
      const int q = p - NU * NF, i = q / NV, j = q - i * NV;
      const uint8_t* n = s_nb + i * NP + j;
      const int vv = 9 * (n[NP] + n[2 * NP]) - (n[0] + n[3 * NP]);
      s_v8[i * PS + j] = (uint8_t)clampi((vv + 8) >> 4, 0, 255);
    }
  }
  __syncthreads();
  for (int p = tid; p < NF * NF; p += kNT) {
    const int i = p / NF, j = p - i * NF;
    const short* u = s_hu + i * PS + j;
    const int d = 9 * (u[PS] + u[2 * PS]) - (u[0] + u[3 * PS]);
    s_d8[i * PS + j] = (uint8_t)clampi((d + 128) >> 8, 0, 255);
  }
  __syncthreads();
}

// Loads the NU x NU half-pel neighbourhood at (r0, c0) of the (EH, S)
// plane rp into s_nb (row stride NU) and filters it (filter_planes).
template <int NU, int PS>
__device__ __forceinline__ void filter_nb(const uint8_t* rp, int S, int r0,
                                          int c0, uint8_t* s_nb,
                                          short* s_hu, uint8_t* s_h8,
                                          uint8_t* s_v8, uint8_t* s_d8) {
  const uint8_t* nbp = rp + (int64_t)r0 * S + c0;
  for (int p = threadIdx.x; p < NU * NU; p += kNT) {
    const int i = p / NU;
    s_nb[p] = __ldg(nbp + (int64_t)i * S + p - i * NU);
  }
  __syncthreads();
  filter_planes<NU, PS, NU>(s_nb, s_hu, s_h8, s_v8, s_d8);
}

// The 14x14 window of half-pel point (xh, yh) (half-pels from the
// full-pel centre window, which starts 2 + pad pixels into the
// neighbourhood): a filtered plane picked by the point's phase, at its
// pixel offset (xh >> 1, yh >> 1), as the plain version slices them.
// stride: its row stride (NP for s_nb, PS for the filtered planes).
template <int NU, int PS, int NP = NU>
__device__ __forceinline__ const uint8_t* hp_win(
    int xh, int yh, int pad, const uint8_t* s_nb, const uint8_t* s_h8,
    const uint8_t* s_v8, const uint8_t* s_d8, int& stride) {
  const int r = 2 + pad + (yh >> 1), c = 2 + pad + (xh >> 1);
  stride = PS;
  if ((xh & 1) && (yh & 1)) return s_d8 + (r - 1) * PS + c - 1;
  if (xh & 1) return s_h8 + r * PS + c - 1;
  if (yh & 1) return s_v8 + (r - 1) * PS + c;
  stride = NP;
  return s_nb + r * NP + c;
}

// Warp 0 of a block, after the search: the chosen 14x14 window's
// statistics (sel, rows ss apart), then the block metrics, the luma
// GO_INTRA cascade and the quadrant metric from the pass-1 sums v and the
// intra-test failures; lane 0 writes the outputs.
template <int N>
__device__ __forceinline__ void finish_block(const Outs& out, int64_t o,
                                             const Block& b,
                                             const unsigned (&v)[N],
                                             unsigned fails, int best,
                                             int mvx, int mvy, bool hp_hit,
                                             const uint8_t* sel, int ss) {
  const int lane = threadIdx.x & 31;
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

  const int yarea = b.bw_c * b.bh_c;
  const int area = max(yarea, 1);
  const int yareasq = yarea * yarea;
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
  const int sbw = b.bw_c / 2, sbh = b.bh_c / 2;
  const int ethr = (sbw + sbh) >> 1;
  int qb = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (stex > 1 && (int)v[G0 + q] >= ethr * (int)v[E0 + q]) qb |= 1 << q;

  out.mvx[o] = mvx;
  out.mvy[o] = mvy;
  out.flags[o] = (go_intra ? 1 : 0) | (fails > 0 ? 2 : 0) | (lo_tex ? 4 : 0) |
                 (lo_var ? 8 : 0) | (hp_hit ? 16 : 0);
  out.qbits[o] = qb;
  out.ltex[o] = luma_tex;
  out.svar[o] = svar;
}

__global__ void __launch_bounds__(kNT, kMinBlocks)
    hme_base_kernel(BaseArgs a) {
  constexpr int R = kRows, kW = kWarpsNT;
  __shared__ unsigned s_src[kMaxBlk * kMaxWpr], s_zero[kMaxBlk * kMaxWpr];
  __shared__ uint8_t s_c14[kHP * kHP];
  __shared__ uint8_t s_nb[kNU * kNU];
  __shared__ short s_hu[kNU * kPS];
  __shared__ uint8_t s_h8[kNU * kPS], s_v8[(kNU - 3) * kPS],
      s_d8[(kNU - 3) * kPS];
  __shared__ unsigned red1[N1 * kW], red2[10 * kW];
  __shared__ int s_cand[2 * kMaxNC], s_a8[8];
  const int t = blockIdx.x, bb = blockIdx.y, tid = threadIdx.x;
  const int S = a.S, E = a.E, BW = a.BW, BH = a.BH, NC = a.NC;
  const uint8_t* sp = a.src + bb * a.pstride;
  const uint8_t* rp = a.ref + bb * a.pstride;
  const Block b = block_of(t, a.nbh_l, BW, BH, a.w, a.h);
  const Lanes m = lanes_of(BW, b);
  HME_STAMP_START

  // --- stage: source and zero-MV windows (words), 14x14 centre, cands
  unsigned s[R], z[R];
  stage_block(sp, rp, S, E, BW, BH, b, m, s, z, s_src, s_zero, s_c14);
  if (tid < NC) {
    const int* c = a.cm + ((int64_t)bb * a.nb + t) * 2 * NC;
    s_cand[tid] = c[tid];
    s_cand[NC + tid] = c[NC + tid];
  }
  __syncthreads();
  HME_STAMP(0);

  // --- pass 1: candidate SADs and every search-independent sum
  unsigned v[N1];
#pragma unroll
  for (int k = 0; k < N1; ++k) v[k] = 0;
#pragma unroll
  for (int k = 0; k < kMaxNC; ++k) {
    if (k >= NC) break;
    const int rx = b.bx + s_cand[k], ry = b.by + s_cand[NC + k];
    if (cand_ok(rx, ry, b, a.w, a.h))
      v[k] = window_sad(rp, S, E + ry, E + rx, s, m);
  }
  block_sums(v, s, z, m, b, BW, s_src, s_zero, s_c14);
  block_sum_u(v, red1);
  HME_STAMP(1);
  int bdx, bdy;
  pick_cand(v, s_cand, NC, 0, b, a.w, a.h, bdx, bdy);

  // --- pass 2: 9-point refine and block_intra_test
  const int yarea = b.bw_c * b.bh_c;
  const int area = max(yarea, 1);
  const int ravg0 = (int)v[ZS] / area;
  unsigned v2[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  refine9(rp, S, E + b.by + bdy - 1, E + b.bx + bdx - 1, s, m, v2);
  v2[9] = intra_fails(s, m, ravg0);
  block_sum_u(v2, red2);
  HME_STAMP(2);
  int best, m9;
  pick9(v2, best, m9);
  const int dx = bdx + XF[m9], dy = bdy + YF[m9];

  // --- half-pel refine (hme.c:543-597): filter the neighbourhood once
  const int cx = b.bx + (b.bw_c >> 1) - kHP / 2;
  const int cy = b.by + (b.bh_c >> 1) - kHP / 2;
  filter_nb<kNU, kPS>(rp, S, E + cy + dy - 2, E + cx + dx - 2, s_nb, s_hu,
                      s_h8, s_v8, s_d8);
  HME_STAMP(3);
  const int lane = tid & 31, wid = tid >> 5;
  for (int k = wid; k < 8; k += kW) {
    int ws;
    const uint8_t* win =
        hp_win<kNU, kPS>(XH[k], YH[k], 0, s_nb, s_h8, s_v8, s_d8, ws);
    unsigned acc = 0;
    for (int p = lane; p < kHP * kHP; p += 32) {
      const int i = p / kHP, j = p - i * kHP;
      acc += absi((int)s_c14[p] - (int)win[i * ws + j]);
    }
    acc = __reduce_add_sync(0xffffffffu, acc);
    if (lane == 0) s_a8[k] = (int)acc;
  }
  __syncthreads();
  HME_STAMP(4);
  if (wid != 0) return;  // warp 0 finishes the block

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
  const uint8_t* sel = s_nb + 2 * kNU + 2;
  int ss = kNU;
  if (hp_hit)
    sel = hp_win<kNU, kPS>(XH[run_m], YH[run_m], 0, s_nb, s_h8, s_v8, s_d8,
                           ss);
  finish_block(a.out, (int64_t)bb * a.nb + t, b, v, v2[9], best, mvx, mvy,
               hp_hit, sel, ss);
  HME_STAMP(5);
}

// Byte f (any sign) of a flat image of nch chunks of 2^lcw bytes, read as
// the JAX package's span_gather reads it: byte f mod 2^lcw of chunk
// floor(f / 2^lcw) clipped to [0, nch).
__device__ __forceinline__ uint8_t flat_byte(const uint8_t* img, int64_t f,
                                             int lcw, int64_t nch) {
  int64_t c = f >> lcw;  // arithmetic: floor for negative f
  c = c < 0 ? 0 : (c >= nch ? nch - 1 : c);
  return img[(c << lcw) + (f & ((1 << lcw) - 1))];
}

struct WideArgs {
  const uint8_t* src;        // flat level-0 images of pair 0
  const uint8_t* ref;
  int64_t pstride, n, org;   // bytes between pairs; image bytes; the flat
                             //   offset of frame pixel (0, 0)
  int EH, S, E, w, h, lcw;   // extended plane, frame, log2 chunk width
  int nbh_l, nb, BW, BH;
  const int *dx, *dy, *best; // (B, nb): the candidate search's result
  Outs out;
};

// acc plus the SAD of the four u8 pairs of s and w, in one
// VABSDIFF4.U8.ACC: the PTX op adds into acc itself, where
// __vsadu4(s, w) + acc left ptxas some of the adds apart (52 more
// IMAD.IADD in hme_wide_kernel<6>, 3-7 % of its time at efforts 2, 3).
__device__ __forceinline__ unsigned sad_acc(unsigned s, unsigned w,
                                            unsigned acc) {
  unsigned d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d) : "r"(s), "r"(w), "r"(acc));
  return d;
}

// Four u8 SADs added to acc: sad_acc where all four bytes count, else
// only the bytes that weight wt (0x01 per byte) keeps.
template <bool kMask>
__device__ __forceinline__ unsigned sad4(unsigned s, unsigned w,
                                         unsigned acc, unsigned wt) {
  return kMask ? __dp4a(absdiff4(s, w), wt, acc) : sad_acc(s, w, acc);
}

// One window row's words (q: kWords words from the lane's column) against
// the source words sa (offset row oy0: into a) and sb (oy0 + 1: into b)
// at the kSide column shifts; kA / kB: whether each counts.
template <int kSide, int kWords, bool kMask, bool kA, bool kB>
__device__ __forceinline__ void sad_row2(unsigned sa, unsigned sb,
                                         const unsigned* q, unsigned wt,
                                         unsigned (&a)[kSide],
                                         unsigned (&b)[kSide]) {
  unsigned wv[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) wv[j] = q[j];
#pragma unroll
  for (int ox = 0; ox < kSide; ++ox) {
    const unsigned w = (ox & 3) ? __funnelshift_r(wv[ox >> 2],
                                                  wv[(ox >> 2) + 1],
                                                  8 * (ox & 3))
                                : wv[ox >> 2];
    if (kA) a[ox] = sad4<kMask>(sa, w, a[ox], wt);
    if (kB) b[ox] = sad4<kMask>(sb, w, b[ox], wt);
  }
}

// A lane's column sums of offset rows oy0 (a) and oy0 + 1 (b): window
// row oy0 + k holds block row k of oy0 and block row k - 1 of oy0 + 1,
// so each window row is loaded and shifted once for both. sq: the
// column's block rows (stride wpr); q: window row oy0 at the column.
// kB: whether b is summed at all; b_last: whether its last block row
// is (not for the last pair, whose row oy0 + 1 is past the window: its
// last window row would be one past the staged ones).
template <int kSide, int kWords, bool kMask, bool kB>
__device__ __forceinline__ void column_sads(const unsigned* sq, int wpr,
                                            const unsigned* q, int rows,
                                            unsigned wt, bool b_last,
                                            unsigned (&a)[kSide],
                                            unsigned (&b)[kSide]) {
  unsigned prev = sq[0];
  sad_row2<kSide, kWords, kMask, true, false>(prev, 0u, q, wt, a, b);
#pragma unroll 1
  for (int k = 1; k < rows; ++k) {
    const unsigned cur = sq[k * wpr];
    sad_row2<kSide, kWords, kMask, true, kB>(cur, prev, q + k * kWinP, wt,
                                             a, b);
    prev = cur;
  }
  if (kB && b_last)
    sad_row2<kSide, kWords, kMask, false, true>(0u, prev, q + rows * kWinP,
                                                wt, a, b);
}

// column_sads with kB chosen per warp: a warp whose only pair is the
// last (pw == kPairs - 1, as at 2 lane groups a warp) sums a alone; in a
// warp that also holds other pairs the last pair's lanes run the
// two-row body and skip only b's last row, so the warp does not diverge.
template <int kSide, int kWords, bool kMask>
__device__ __forceinline__ void pair_sads(bool alone, const unsigned* sq,
                                          int wpr, const unsigned* q,
                                          int rows, unsigned wt, bool b_last,
                                          unsigned (&a)[kSide],
                                          unsigned (&b)[kSide]) {
  if (alone)
    column_sads<kSide, kWords, kMask, false>(sq, wpr, q, rows, wt, false,
                                             a, b);
  else
    column_sads<kSide, kWords, kMask, true>(sq, wpr, q, rows, wt, b_last,
                                            a, b);
}

// One block's level 0 at effort kR / 2: the +-kR full-pel window around
// the candidate search's (dx, dy), the +-(1 + effort) half-pel grid and
// the luma cascade.
template <int kR>
__global__ void __launch_bounds__(kNT, kWideMinBlocks[kR / 2 - 1])
    hme_wide_kernel(WideArgs a) {
  HME_STAMP_START
  constexpr int R = kRows, kW = kWarpsNT;
  constexpr int kEff = kR / 2, kSide = 2 * kR + 1, kOff = kSide * kSide;
  constexpr int kPairs = (kSide + 1) / 2;      // offset-row pairs
  constexpr int kWinH = kMaxBlk + 2 * kR;
  constexpr int kWords = kEff + 1;             // words a lane's row reads
  constexpr int kRH = 1 + kEff, kHSide = 2 * kRH + 1;
  constexpr int kPts = kHSide * kHSide - 1;    // 24, 48, 80
  // every half-pel neighbourhood the search can pick: 21 + 2 kR square,
  // kept as the aligned words around each row (kNXW a row, the last
  // only read by the word reads of the grid's last column)
  constexpr int kNX = kNUW + 2 * kR, kNXW = (kNX + 6) / 4 + 1;
  constexpr int kNXP = 4 * kNXW;
  static_assert(kMaxWpr + kEff <= kWinP && kPts <= kNT && kOff < 256,
                "layout");
  __shared__ unsigned s_src[kMaxBlk * kMaxWpr], s_zero[kMaxBlk * kMaxWpr];
  __shared__ __align__(4) uint8_t s_c14[kHP * kHP];
  __shared__ unsigned s_cw[kHP * 4];           // s_c14 as words
  __shared__ unsigned s_win[kWinH * kWinP];
  __shared__ unsigned s_sad[kOff];
  __shared__ unsigned s_nbx[kNX * kNXW];
  __shared__ short s_hu[kNUW * kPSW];
  __shared__ __align__(16) uint8_t s_h8[kNUW * kPSW];
  __shared__ __align__(16) uint8_t s_v8[(kNUW - 3) * kPSW];
  __shared__ __align__(16) uint8_t s_d8[(kNUW - 3) * kPSW];
  __shared__ unsigned red1[(N1 - LS) * kW], s_fails[kW];
  __shared__ int s_a[kPts];
  const int t = blockIdx.x, bb = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  const int S = a.S, E = a.E, BW = a.BW, BH = a.BH;
  const uint8_t* sf = a.src + bb * a.pstride;
  const uint8_t* rf = a.ref + bb * a.pstride;
  const int64_t start = a.org - (int64_t)E * S - E;  // the (EH, S) plane
  const uint8_t* sp = sf + start;
  const uint8_t* rp = rf + start;
  const Block b = block_of(t, a.nbh_l, BW, BH, a.w, a.h);
  const Lanes m = lanes_of(BW, b);
  const int64_t o = (int64_t)bb * a.nb + t;
  const int dx0 = a.dx[o], dy0 = a.dy[o], best0 = a.best[o];
  const int cx = b.bx + (b.bw_c >> 1) - kHP / 2;
  const int cy = b.by + (b.bh_c >> 1) - kHP / 2;

  // --- stage, every load issued before the first wait: the words of the
  // (bh_c + 2 kR)-row window around (dx0, dy0) that the search reads,
  // from the flat image as the JAX gather reads it: a lane loads one
  // aligned word of every row it stages and realigns it with its
  // neighbour's (a shuffle) where every word lies in the image's whole
  // chunks (`words`: the rows' aligned words, one more than the window
  // needs a row), else the window is read byte by byte with the chunk
  // clip; the aligned words around the union of the half-pel
  // neighbourhoods the search can pick, from the plane as hme_base_kernel
  // reads its one (its readers take any byte offset, so they stay as
  // loaded); then the block as hme_base_kernel stages it
  const int rows = b.bh_c + 2 * kR;
  const int nww = ((b.bw_c + 3) >> 2) + kEff;
  const int64_t f0 = a.org + (int64_t)(b.by + dy0 - kR) * S +
                     (b.bx + dx0 - kR);
  const int64_t a0 = f0 & ~(int64_t)3;
  const int64_t nch = a.n >> a.lcw;
  const bool words =
      a0 >= 0 && a0 + (int64_t)(rows - 1) * S + 4 * (nww + 1) <= nch << a.lcw;
  constexpr int kIw = (kWinH + kW - 1) / kW;
  unsigned wv[kIw];
  if (words) {
    const unsigned* g = reinterpret_cast<const unsigned*>(rf + a0) + lane;
#pragma unroll
    for (int i = 0; i < kIw; ++i) {
      const int r = wid + i * kW;
      wv[i] = r < rows && lane <= nww ? __ldg(g + (int64_t)r * (S >> 2))
                                      : 0u;
    }
  }
  const uint8_t* nx = rp + (int64_t)(E + cy + dy0 - kR - 3) * S +
                      (E + cx + dx0 - kR - 3);
  const int nxo = (int)(reinterpret_cast<uintptr_t>(nx) & 3);
  const unsigned* nxw = reinterpret_cast<const unsigned*>(nx - nxo);
  const int nwx = (nxo + kNX + 3) >> 2;  // words of a row, <= kNXW
  constexpr int kIx = (kNX * kNXW + kNT - 1) / kNT;
  unsigned xv[kIx];
#pragma unroll
  for (int i = 0; i < kIx; ++i) {
    const int p = tid + i * kNT, r = p / kNXW, j = p - r * kNXW;
    xv[i] = r < kNX && j < nwx ? __ldg(nxw + (int64_t)r * (S >> 2) + j) : 0u;
  }
  unsigned s[R], z[R];
  stage_block(sp, rp, S, E, BW, BH, b, m, s, z, s_src, s_zero, s_c14);
  if (words) {
    const int sh = 8 * (int)(f0 - a0);
#pragma unroll
    for (int i = 0; i < kIw; ++i) {
      const int r = wid + i * kW;
      const unsigned hi = __shfl_down_sync(0xffffffffu, wv[i], 1);
      if (r < rows && lane < nww)
        s_win[r * kWinP + lane] = __funnelshift_r(wv[i], hi, sh);
    }
  } else {
    uint8_t* wb = reinterpret_cast<uint8_t*>(s_win);
    const int rb = 4 * nww;
    for (int p = tid; p < rows * rb; p += kNT) {
      const int r = p / rb, c = p - r * rb;
      wb[r * 4 * kWinP + c] =
          flat_byte(rf, f0 + (int64_t)r * S + c, a.lcw, nch);
    }
  }
#pragma unroll
  for (int i = 0; i < kIx; ++i) {
    const int p = tid + i * kNT;
    if (p < kNX * kNXW) s_nbx[p] = xv[i];
  }
  __syncthreads();
  HME_STAMP(0);

  // --- the search-independent sums, then this warp's block_intra_test
  // failures (summed after the next barrier); the 14x14 source centre
  // as words for the half-pel grid
  unsigned v[N1];
#pragma unroll
  for (int k = 0; k < N1; ++k) v[k] = 0;
  block_sums(v, s, z, m, b, BW, s_src, s_zero, s_c14);
  block_sum_u<N1, LS>(v, red1);
  const int yarea = b.bw_c * b.bh_c;
  const int area = max(yarea, 1);
  {
    const unsigned f = __reduce_add_sync(0xffffffffu,
                                         intra_fails(s, m, (int)v[ZS] / area));
    if (lane == 0) s_fails[wid] = f;
    if (tid < kHP * 4) {  // row tid / 4, bytes 4 (tid % 4) on, 14 a row
      const int i = tid >> 2, j = tid & 3;
      const unsigned short* c =
          reinterpret_cast<const unsigned short*>(s_c14 + i * kHP + 4 * j);
      s_cw[tid] = c[0] | (j < 3 ? (unsigned)c[1] << 16 : 0u);
    }
  }
  HME_STAMP(1);

  // --- the window's SADs. A lane group of a warp takes the offset rows
  // oy0 = 2 p and 2 p + 1 (p its pair) and sums, down its word column wc,
  // each window row against the two block rows it meets at the kSide
  // column shifts (kWords words, funnel shifts): the vertical sums stay
  // in registers, and one butterfly over the group's lanes gives the
  // pair's 2 kSide SADs. Lane = g + G wc, G = 32 / (words per block row
  // rounded up to a power of 2); the G groups of a warp take pairs next
  // to each other, whose rows lie 2 apart: 16 banks (row pitch kWinP =
  // 24 words). A column with bytes outside the frame weighs its bytes.
  {
    const int wpr = BW >> 2;
    const int lw = 32 - __clz(wpr - 1);  // log2 of wpr, rounded up
    const int G = 32 >> lw, g = lane & (G - 1), wc = lane >> (5 - lw);
    const unsigned wt = wc < wpr ? col_mask(wc, 0, b.bw_c) & kOnes : 0u;
    for (int pw = wid * G; pw < kPairs; pw += kW * G) {
      const int p = pw + g, oy0 = 2 * p;
      unsigned sa[kSide], sb[kSide];
#pragma unroll
      for (int ox = 0; ox < kSide; ++ox) sa[ox] = sb[ox] = 0;
      if (p < kPairs && wt && b.bh_c) {
        const unsigned* q = s_win + oy0 * kWinP + wc;
        const bool alone = pw == kPairs - 1, b_last = oy0 + 1 < kSide;
        if (wt == kOnes)
          pair_sads<kSide, kWords, false>(alone, s_src + wc, wpr, q, b.bh_c,
                                          wt, b_last, sa, sb);
        else
          pair_sads<kSide, kWords, true>(alone, s_src + wc, wpr, q, b.bh_c,
                                         wt, b_last, sa, sb);
      }
#pragma unroll
      for (int ox = 0; ox < kSide; ++ox)
        for (int off = G; off < 32; off <<= 1) {
          sa[ox] += __shfl_xor_sync(0xffffffffu, sa[ox], off);
          sb[ox] += __shfl_xor_sync(0xffffffffu, sb[ox], off);
        }
      if (p < kPairs && wc == 0) {
#pragma unroll
        for (int ox = 0; ox < kSide; ++ox) {
          s_sad[oy0 * kSide + ox] = sa[ox];
          if (oy0 + 1 < kSide) s_sad[(oy0 + 1) * kSide + ox] = sb[ox];
        }
      }
    }
  }
  __syncthreads();
  HME_STAMP(2);

  // --- the raster scan with strict improvement is the first offset of
  // least SAD, taken if below best0: each warp takes the least
  // (SAD, offset) key (SAD < 2^21)
  unsigned key = ~0u;
  for (int k = lane; k < kOff; k += 32)
    if (k != kOff / 2)  // the centre: its SAD is best0
      key = min(key, (s_sad[k] << 8) | (unsigned)k);
  key = __reduce_min_sync(0xffffffffu, key);
  int best = best0, dx = dx0, dy = dy0;
  if ((int)(key >> 8) < best0) {
    const int k = (int)(key & 255u);
    best = (int)(key >> 8);
    dx = dx0 + k % kSide - kR;
    dy = dy0 + k / kSide - kR;
  }
  unsigned fails = 0;
#pragma unroll
  for (int i = 0; i < kW; ++i) fails += s_fails[i];
  HME_STAMP(3);

  // --- the half-pel grid: points k in row-major order over (yh, xh) in
  // [-kRH, kRH]^2 without the centre, on the neighbourhood 3 pixels
  // before the centre window (in s_nbx since staging), filtered once
  const uint8_t* s_nb = reinterpret_cast<const uint8_t*>(s_nbx) + nxo +
                       (dy - dy0 + kR) * kNXP + (dx - dx0 + kR);
  filter_planes<kNUW, kPSW, kNXP>(s_nb, s_hu, s_h8, s_v8, s_d8);
  HME_STAMP(4);
  // a thread per point: each row of its 14x14 window, 14 bytes read as 4
  // words realigned from 5, against the centre's words
  if (tid < kPts) {
    const int gi = tid < kPts / 2 ? tid : tid + 1;
    int ws;
    const uint8_t* win = hp_win<kNUW, kPSW, kNXP>(
        gi % kHSide - kRH, gi / kHSide - kRH, 1, s_nb, s_h8, s_v8, s_d8, ws);
    const uintptr_t pw = reinterpret_cast<uintptr_t>(win);
    const unsigned* q = reinterpret_cast<const unsigned*>(pw & ~(uintptr_t)3);
    const int sh = 8 * (int)(pw & 3), wsw = ws >> 2;
    unsigned acc = 0;
#pragma unroll 2
    for (int i = 0; i < kHP; ++i) {
      const unsigned* qi = q + i * wsw;
      unsigned wv[5];
#pragma unroll
      for (int j = 0; j < 5; ++j) wv[j] = qi[j];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned w = __funnelshift_r(wv[j], wv[j + 1], sh);
        acc = sad_acc(s_cw[4 * i + j], j < 3 ? w : w & 0xffffu, acc);
      }
    }
    s_a[tid] = (int)acc;
  }
  __syncthreads();
  HME_STAMP(5);
  if (wid != 0) return;  // warp 0 finishes the block

  unsigned hkey = ~0u;  // (SAD < 2^16, point)
  for (int k = lane; k < kPts; k += 32)
    hkey = min(hkey, ((unsigned)s_a[k] << 8) | (unsigned)k);
  hkey = __reduce_min_sync(0xffffffffu, hkey);
  const int run_best = (int)(hkey >> 8);
  const bool do_hp = best > BW * BH && b.inframe;
  const bool hp_hit = do_hp && run_best < best * (kHP * kHP) / area;
  int xh = 0, yh = 0;
  const uint8_t* sel = s_nb + 3 * kNXP + 3;
  int ss = kNXP;
  if (hp_hit) {
    const int k = (int)(hkey & 255u), g = k < kPts / 2 ? k : k + 1;
    xh = g % kHSide - kRH;
    yh = g / kHSide - kRH;
    best = run_best * yarea / (kHP * kHP);
    sel = hp_win<kNUW, kPSW, kNXP>(xh, yh, 1, s_nb, s_h8, s_v8, s_d8, ss);
  }
  block_totals<N1, LS>(v, red1);  // not kept in registers till here
  finish_block(a.out, o, b, v, fails, best, 2 * dx + xh, 2 * dy + yh,
               hp_hit, sel, ss);
  HME_STAMP(6);
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
  BaseArgs a{src,  ref, cm, pstride, EH, S,  E,
             w,    h,   nbh_l, nb, BW, BH, NC,
             {mvx, mvy, flags, qbits, ltex, svar}};
  hme_base_kernel<<<dim3(nb, B), kNT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// Level 0 at effort 1..3 from the candidate search's dx, dy, best (B, nb)
// on the flat level-0 images (pair stride pstride, n bytes each; frame
// pixel (0, 0) at byte org; chunks of 2^lcw bytes for the wide window).
extern "C" int dsv1_hme_wide(const uint8_t* src, const uint8_t* ref,
                             int64_t pstride, int64_t n, int64_t org, int EH,
                             int S, int E, int w, int h, int lcw, int nbh_l,
                             int nb, int BW, int BH, int effort, int B,
                             const int* dx, const int* dy, const int* best,
                             int* mvx, int* mvy, int* flags, int* qbits,
                             int* ltex, int* svar, cudaStream_t stream) {
  if (bad_block(BW, BH) || effort < 1 || effort > 3 || lcw < 2 || lcw > 20 ||
      (n >> lcw) < 1)
    return (int)cudaErrorInvalidValue;
  WideArgs a{src,   ref, pstride, n,  org, EH, S,  E,
             w,     h,   lcw,     nbh_l, nb, BW, BH, dx,
             dy,    best, {mvx, mvy, flags, qbits, ltex, svar}};
  const dim3 grid(nb, B);
  if (effort == 1)
    hme_wide_kernel<2><<<grid, kNT, 0, stream>>>(a);
  else if (effort == 2)
    hme_wide_kernel<4><<<grid, kNT, 0, stream>>>(a);
  else
    hme_wide_kernel<6><<<grid, kNT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
