// HZCC quantization with in-loop write-back (encoder) and dequantization
// (decoder) of a batch of planes, one launch each.
//
// Replaces the XLA code of the JAX package's `encode_plane_core` and
// `dequant_plane_grid` (dsv1_tpu/ops/hzcc.py:191, :236; no Pallas kernel
// there): per band segment of the traversal (the LL region, then the LH,
// HL and HH bands of the three finest levels, reference hzcc.c:29-48) a
// slice of the coefficient grid is quantized with the block-adaptive TMQ
// (hzcc.c:59-135), written in traversal order, and written back
// dequantized (hzcc.c:174,227,262).
//
// The traversal is a concatenation of at most kMaxSegs rectangles. Each
// grid position walks the ones that contain it in traversal order and,
// for each, computes the TMQ from the stability flag of its block (the
// 14-bit fixed-point block map of build_tables), quantizes the value it
// currently holds, writes that quantized value at the segment's offset
// plus its raster index, and carries the write-back on. Quantization is
// elementwise, so that chain is the sequential band order even where odd
// ceil dims make bands alias: the encoder quantizes what an earlier band
// wrote back. The decoder dequantizes the grid value itself for every
// segment, so the last segment wins (the parser's visit order). Positions
// no segment covers keep their value (encoder) or become 0 (decoder). The
// DC is zeroed before the chain and restored after it.
//
// The quant is a scalar or a device int32 per plane of the batch (an ABR
// decode carries one per picture): the kernels derive the plane's
// quantizer parameters from it (frame_quants) and never hand it back to
// the host.
//
// Bound by memory: the encoder reads each int32 coefficient and writes it
// back and writes about one quantized value per position (12 bytes a
// position, about 25 MB for a 1080p luma plane: 7.4 us at 3.35 TB/s);
// the decoder reads and writes 8 bytes a position.
//
// hzcc_quant_kernel keeps per-plane work out of the per-position path
// (done for every position, frame_quants, all ten segments' bound tests
// and a division by a step known only at run time cost about 250
// integer instructions a position). A
// block takes a tile of 4 rows by 256 columns of one plane, and a thread
// 4 positions of a row (64 columns and 1 position for a batch of small
// planes, which would otherwise leave SMs idle):
// - per block, once: frame_quants, the plane's at most seven distinct
//   steps (qp_ll, and tmq4pos of qp0 and of qp1 in its three cases of
//   the stability flag) with a multiply-high reciprocal each (`Div`: exact floor
//   division of every dividend below 2^31, far above the 2 |v| + 1 the
//   quantizer divides), the two shifts of the finest level, and the list
//   of segments that touch the tile, in traversal order, in shared
//   memory;
// - per thread: the row test of each listed segment once, then per
//   position the column test, the stability class (one L1-cached read of
//   the block map, whose row is resolved once per segment), a table read
//   and a multiply-high;
// - a thread's positions 32 columns apart, so that every warp load and
//   store, the traversal values' included, is one coalesced 128-byte row
//   segment (with four neighbouring positions a thread, each warp's
//   traversal-value store spans 512 bytes: 16.1 us for a 1080p luma
//   plane with 16-byte loads and stores of the coefficients and the
//   grid, against 10.7, probe variants adj16 and base); the
//   coefficients' loads are issued before the block's setup barrier.
// hzcc_dequant_kernel takes one thread a grid position, which walks all
// the segments.
//
// dsv1_hzcc_compact lists every symbol of a chunk whose capped
// compaction overflowed: per row (a frame's plane in traversal order) the
// zero run before each nonzero and the nonzero, as ops/hzcc.py
// runs_from_qvals gives them, all rows' lists end to end in one buffer,
// so that the host reads them in one copy. It replaces no TPU kernel: the
// JAX package, and the port before it, read the chunk's dense int32
// planes to the host and scanned every position there. Bound by memory:
// 4 bytes read a position and 8 written a symbol (a 12-frame 4K chunk,
// 149 M positions: 0.18 ms at 3.35 TB/s). A tiled stream compaction in
// three launches over tiles of kCTile positions of one row: each tile's
// nonzero count and last nonzero (as a position over all rows, which
// only grows along the lists); one block's exclusive scan of the counts
// (each tile's first output slot) and prefix max of the last nonzeros
// (the nonzero before each tile, so that a run crosses tiles); then each
// tile ranks its nonzeros in position order (a warp ballot a step, a
// scan of the warps' counts), stages them in shared memory and writes
// them out coalesced. The input is read twice, 2x the bound, a few
// hundred microseconds a 4K chunk against the tens of milliseconds a
// frame that the host's scan took.
#include "common.cuh"

using namespace dsv1;

namespace {

constexpr int kMaxSegs = 10;  // 1 + 3 * MAXLVL
constexpr int kBlockP = 14;   // BLOCK_P
constexpr int kMinQuant = 16;  // MINQUANT
constexpr int kChromaLimit = 512;
constexpr int kQpI = 3, kQpP = 1;

struct Segs {
  int n;
  int lvl[kMaxSegs];  // -1 the LL region, 0..2 the finest levels
  int oy[kMaxSegs], ox[kMaxSegs], sh[kMaxSegs], sw[kMaxSegs];
  int off[kMaxSegs];  // traversal offset of the segment
  int dbx[kMaxSegs], dby[kMaxSegs];  // (nbh << 14) / sw, (nbv << 14) / sh
};

// Per plane of the batch: the quant (pointer or scalar), stable blocks
// (int32 or u8, with a batch stride), the DC (decoder).
struct Args {
  const int* q;
  int64_t qstride;
  int qscalar;
  const void* stable;
  int64_t sstride;
  int stable_u8;
  int nbh;
  int is_p;
  int chroma;
};

__device__ __forceinline__ int get_quant(int q, int is_p, int level) {
  if (is_p) q = q * 3 / 2;
  if (level == 1) q = q * 2 / 3;
  else if (level == 2) q = q * 3 / 2;
  return max(q, kMinQuant);
}

__device__ __forceinline__ int lb2(int n) {
  int k = 0;
  for (int j = 0; j < 31; ++j) k += n > (1 << j);
  return k;
}

struct Quants {
  int ll, q1, q2, q2h;  // qp_ll (= qp0), qp1, qp2_shift, qp2h_shift
};

// frame_quants (hzcc.c:50-57,199-208)
__device__ __forceinline__ Quants frame_quants(int q, int is_p, int chroma) {
  if (chroma) q = min(q, kChromaLimit);
  Quants r;
  r.ll = get_quant(q, is_p, 0);
  r.q1 = get_quant(q, is_p, 1);
  r.q2 = lb2(get_quant(q, is_p, 2));
  r.q2h = clampi(r.q2 - (is_p ? kQpP : kQpI), 1, 24);
  return r;
}

__device__ __forceinline__ int tmq4pos(int qp, int st) {
  const int t = (st & 2) ? qp >> 2 : (st ? qp >> 1 : qp);
  return max(t, kMinQuant);
}

__device__ __forceinline__ int dequant_lo(int v, int q) {
  const int m = (absi(v) * (q << 1) + q) >> 1;
  return v < 0 ? -m : m;
}

__device__ __forceinline__ int quant_hi(int v, int s) {
  const int a = absi(v) >> s;
  return v < 0 ? -a : a;
}

__device__ __forceinline__ int dequant_hi(int v, int s) {
  return (int)((unsigned)v << s);
}

// The quantizer of segment k at local (ly, lx): a lower-frequency step
// (returns it, *hi = 0) or a highest-frequency shift (*hi = 1).
__device__ __forceinline__ int seg_param(const Segs& S, int k, int ly, int lx,
                                         const Quants& Q, const Args& A,
                                         int b, int* hi) {
  *hi = 0;
  const int lvl = S.lvl[k];
  if (lvl < 0) return Q.ll;
  const int bi = (lx * S.dbx[k]) >> kBlockP;
  const int bj = (ly * S.dby[k]) >> kBlockP;
  const int64_t idx = b * A.sstride + (int64_t)bj * A.nbh + bi;
  const int st = A.stable_u8 ? (int)static_cast<const uint8_t*>(A.stable)[idx]
                             : static_cast<const int*>(A.stable)[idx];
  if (lvl == 0) return tmq4pos(Q.ll, st);
  if (lvl == 1) return tmq4pos(Q.q1, st);
  *hi = 1;
  return st ? Q.q2h : Q.q2;
}

__device__ __forceinline__ int plane_quant(const Args& A, int b) {
  return A.q ? A.q[b * A.qstride] : A.qscalar;
}

// Exact floor(n / d) of 0 <= n < 2^31 for a divisor d >= 2 known only at
// run time: umulhi(n, m) >> s with m = floor(2^(31 + l) / d) + 1, l =
// ceil(log2 d), s = l - 1 (Granlund and Montgomery, "Division by
// invariant integers using multiplication", Theorem 4.2 with N = 31:
// 2^(31 + l) < m d <= 2^(31 + l) + d <= 2^(31 + l) + 2^l, and m < 2^32).
struct Div {
  unsigned m;
  int s;
};

__device__ __forceinline__ Div make_div(unsigned d) {
  int l = 0;
  while ((1u << l) < d) ++l;
  Div r;
  r.m = (unsigned)(((unsigned long long)1 << (31 + l)) / d + 1);
  r.s = l - 1;
  return r;
}

__device__ __forceinline__ int div_by(int n, const Div& D) {
  return (int)(__umulhi((unsigned)n, D.m) >> D.s);
}

// quant_lo with the step's reciprocal D (of 2 q)
__device__ __forceinline__ int quant_lo_div(int v, int q, const Div& D) {
  const int a = absi(v) << 1;
  if (a <= q) return 0;  // v == 0 included
  const int mag = div_by(a + 1, D);
  return v < 0 ? -mag : mag;
}

// A tile: kTileH rows of 64 kQx columns, a thread kQx positions of a row,
// lane l of a warp columns l + 32 j of the warp's 32 kQx
constexpr int kTileX = 64, kTileH = kThreads / kTileX;
// kQx = 4 where a plane batch has at least this many such tiles (4 blocks
// an SM), else 1, so that small planes keep enough blocks in flight. On
// the H100 each wins on its side (tools/torch_recon_probe.py q4/q1 in
// turns, PERF.md section 6): kQx = 1 takes 3.2 us against 4.2 for a CIF
// luma plane (144 tiles of 4) and 3.5 against 4.6 for a batch of 4 CIF
// chroma planes (144); kQx = 4 takes 5.7 us against 6.2 for a batch of 4
// CIF luma planes (576), 4.9 against 6.3 for a 1080p chroma plane (540),
// 10.7 against 19.7 for a 1080p luma plane
constexpr int kMinTiles4 = 4 * 132;
constexpr int kSteps = 7;  // qp_ll, tmq4pos(qp0, class), tmq4pos(qp1, class)

// the stability class of a flag: tmq4pos's (st & 2) ? >> 2 : st ? >> 1
__device__ __forceinline__ int stable_class(int st) {
  return (st & 2) ? 2 : (st ? 1 : 0);
}

// A segment of the traversal as a tile holds it
struct TileSeg {
  int lvl, oy, ox, sh, sw, off, dbx, dby;
};

template <int kQx>
__global__ void __launch_bounds__(kThreads)
hzcc_quant_kernel(const int* __restrict__ coefs, int64_t cbatch, int H,
                  int W, Segs S, Args A, int* __restrict__ qvals, int64_t N,
                  int* __restrict__ work, int64_t wbatch) {
  __shared__ int s_step[kSteps];
  __shared__ Div s_div[kSteps];
  __shared__ int s_shift[2];
  __shared__ TileSeg s_seg[kMaxSegs];
  __shared__ int s_nseg;
  const int b = blockIdx.z;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  constexpr int kTileW = kTileX * kQx;
  const int tx0 = blockIdx.x * kTileW, ty0 = blockIdx.y * kTileH;
  const int y = ty0 + threadIdx.y;
  // this thread's columns: x0 + 32 j, so that each warp access is one
  // coalesced row segment
  const int x0 = tx0 + (threadIdx.x >> 5) * 32 * kQx + (threadIdx.x & 31);
  const bool live = y < H;
  const int* crow = coefs + b * cbatch + (int64_t)y * W;
  // the coefficients load while the block sets up
  int v[kQx];
#pragma unroll
  for (int j = 0; j < kQx; ++j)
    v[j] = live && x0 + 32 * j < W ? __ldg(crow + x0 + 32 * j) : 0;
  if (tid < kSteps + 1) {
    const Quants Q = frame_quants(plane_quant(A, b), A.is_p, A.chroma);
    if (tid == kSteps) {
      s_shift[0] = Q.q2;
      s_shift[1] = Q.q2h;
    } else {
      const int cls = (tid - 1) % 3;
      const int q = tid == 0 ? Q.ll : tmq4pos(tid < 4 ? Q.ll : Q.q1,
                                              cls == 2 ? 2 : cls);
      s_step[tid] = q;
      s_div[tid] = make_div(2u * (unsigned)q);
    }
  } else if (tid == 32) {
    // the segments that touch this tile, in traversal order
    int n = 0;
    for (int k = 0; k < S.n; ++k) {
      if (S.oy[k] >= ty0 + kTileH || S.oy[k] + S.sh[k] <= ty0 ||
          S.ox[k] >= tx0 + kTileW || S.ox[k] + S.sw[k] <= tx0)
        continue;
      s_seg[n] = TileSeg{S.lvl[k], S.oy[k], S.ox[k], S.sh[k],
                         S.sw[k], S.off[k], S.dbx[k], S.dby[k]};
      ++n;
    }
    s_nseg = n;
  }
  __syncthreads();
  if (!live) return;
  const int raw0 = v[0];
  const bool dc = x0 == 0 && y == 0;
  if (dc) v[0] = 0;  // hzcc.c:171 src[0] = 0
  int* qo = qvals + b * N;
  const int nseg = s_nseg;
  for (int t = 0; t < nseg; ++t) {
    const TileSeg g = s_seg[t];
    const int ly = y - g.oy;
    if (ly < 0 || ly >= g.sh) continue;
    const int lx0 = x0 - g.ox;
    int* qrow = qo + g.off + ly * g.sw;
    if (g.lvl < 0) {
      const int q = s_step[0];
      const Div D = s_div[0];
#pragma unroll
      for (int j = 0; j < kQx; ++j) {
        const int lx = lx0 + 32 * j;
        if (lx < 0 || lx >= g.sw) continue;
        const int qv = quant_lo_div(v[j], q, D);
        qrow[lx] = qv;
        v[j] = qv == 0 ? 0 : dequant_lo(qv, q);
      }
      continue;
    }
    const int bj = (ly * g.dby) >> kBlockP;
    const int64_t srow = b * A.sstride + (int64_t)bj * A.nbh;
    const int base = g.lvl == 0 ? 1 : 4;
#pragma unroll
    for (int j = 0; j < kQx; ++j) {
      const int lx = lx0 + 32 * j;
      if (lx < 0 || lx >= g.sw) continue;
      const int64_t idx = srow + ((lx * g.dbx) >> kBlockP);
      const int st =
          A.stable_u8 ? (int)__ldg(static_cast<const uint8_t*>(A.stable) + idx)
                      : __ldg(static_cast<const int*>(A.stable) + idx);
      int qv;
      if (g.lvl == 2) {
        const int sft = s_shift[st != 0];
        qv = quant_hi(v[j], sft);
        v[j] = qv == 0 ? 0 : dequant_hi(qv, sft);
      } else {
        const int k = base + stable_class(st);
        const int q = s_step[k];
        qv = quant_lo_div(v[j], q, s_div[k]);
        v[j] = qv == 0 ? 0 : dequant_lo(qv, q);
      }
      qrow[lx] = qv;
    }
  }
  if (dc) v[0] = raw0;  // dsv_encode_plane restores the raw DC
  int* wrow = work + b * wbatch + (int64_t)y * W;
#pragma unroll
  for (int j = 0; j < kQx; ++j)
    if (x0 + 32 * j < W) wrow[x0 + 32 * j] = v[j];
}

__global__ void __launch_bounds__(kThreads)
hzcc_dequant_kernel(const int* __restrict__ qgrid, int64_t gbatch, int H,
                    int W, Segs S, Args A, const int* __restrict__ dc,
                    int64_t dcstride, int dcscalar, int* __restrict__ out,
                    int64_t obatch) {
  const int x = blockIdx.x * 32 + threadIdx.x;
  const int y = blockIdx.y * 8 + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= W || y >= H) return;
  int r;
  if (x == 0 && y == 0) {
    r = dc ? dc[b * dcstride] : dcscalar;
  } else {
    const Quants Q = frame_quants(plane_quant(A, b), A.is_p, A.chroma);
    const int g = qgrid[b * gbatch + (int64_t)y * W + x];
    r = 0;
    for (int k = 0; k < S.n; ++k) {
      const int ly = y - S.oy[k], lx = x - S.ox[k];
      if (ly < 0 || lx < 0 || ly >= S.sh[k] || lx >= S.sw[k]) continue;
      int hi;
      const int p = seg_param(S, k, ly, lx, Q, A, b, &hi);
      r = g == 0 ? 0 : (hi ? dequant_hi(g, p) : dequant_lo(g, p));
    }
  }
  out[b * obatch + (int64_t)y * W + x] = r;
}

// segs: n rows of (lvl, oy, ox, sh, sw) on the host; the offsets and
// block-map steps are derived here. Returns false on a bad table.
bool make_segs(const int* segs, int n, int H, int W, int nbh, int nbv,
               Segs* S) {
  if (n < 1 || n > kMaxSegs) return false;
  S->n = n;
  int off = 0;
  for (int k = 0; k < n; ++k) {
    const int* r = segs + 5 * k;
    S->lvl[k] = r[0];
    S->oy[k] = r[1];
    S->ox[k] = r[2];
    S->sh[k] = r[3];
    S->sw[k] = r[4];
    if (r[3] < 1 || r[4] < 1 || r[1] + r[3] > H || r[2] + r[4] > W)
      return false;
    S->off[k] = off;
    off += r[3] * r[4];
    S->dbx[k] = (nbh << kBlockP) / r[4];
    S->dby[k] = (nbv << kBlockP) / r[3];
  }
  return true;
}

dim3 grid_of(int H, int W, int C) {
  return dim3((W + 31) / 32, (H + 7) / 8, C);
}

constexpr int kCPer = 16;                 // positions a thread
constexpr int kCTile = kThreads * kCPer;  // ops/hzcc.py COMPACT_TILE
constexpr int kScanThreads = 1024;
// the scatter's warp counts go kCPer * kWarps / 32 to a lane; the scan's
// warp totals, one a warp, fill one warp
static_assert(kCPer * kWarps % 32 == 0, "warp counts a lane");
static_assert(kScanThreads == 32 * 32, "one warp scans the warp totals");

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// A chunk's three planes of the same rows, contiguous rows of n positions
struct CPlanes {
  const int* q[3];
  int n[3];
  int64_t tpr[3];    // tiles a row
  int64_t tbase[3];  // the plane's first tile
  int64_t kbase[3];  // the plane's first position over all rows
};

struct CTile {
  const int* row;
  int n, x0;
  int64_t rowkey;  // the row's first position over all rows
};

// the plane's fields picked by selects, not by a run-time index, so that
// the kernel parameters are not copied to local memory
template <class V>
__device__ __forceinline__ V pick(const V (&a)[3], int c) {
  return c == 0 ? a[0] : (c == 1 ? a[1] : a[2]);
}

__device__ __forceinline__ CTile locate_tile(const CPlanes& P, int64_t t) {
  const int c = t >= P.tbase[2] ? 2 : (t >= P.tbase[1] ? 1 : 0);
  const int n = pick(P.n, c);
  const int64_t tpr = pick(P.tpr, c);
  const int64_t local = t - pick(P.tbase, c);
  const int64_t r = local / tpr;
  CTile T;
  T.row = pick(P.q, c) + r * n;
  T.n = n;
  T.x0 = (int)(local - r * tpr) * kCTile;
  T.rowkey = pick(P.kbase, c) + r * n;
  return T;
}

// a tile's kCPer positions a thread, kThreads apart (coalesced)
__device__ __forceinline__ void load_tile(const CTile& T, int (&v)[kCPer]) {
#pragma unroll
  for (int j = 0; j < kCPer; ++j) {
    const int p = T.x0 + j * kThreads + (int)threadIdx.x;
    v[j] = p < T.n ? __ldg(T.row + p) : 0;
  }
}

// per tile: cnt its nonzeros, key its last nonzero over all rows (-1: none)
__global__ void __launch_bounds__(kThreads)
compact_count_kernel(CPlanes P, int64_t* __restrict__ cnt,
                     int64_t* __restrict__ key) {
  __shared__ int red[kWarps];
  __shared__ int redm[kWarps];
  const CTile T = locate_tile(P, blockIdx.x);
  int v[kCPer];
  load_tile(T, v);
  int nz[1] = {0};
  int last = -1;
#pragma unroll
  for (int j = 0; j < kCPer; ++j) {
    if (v[j] != 0) {
      ++nz[0];
      last = T.x0 + j * kThreads + (int)threadIdx.x;
    }
  }
  block_sum(nz, red);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    last = max(last, __shfl_down_sync(0xffffffffu, last, o));
  if ((threadIdx.x & 31) == 0) redm[threadIdx.x >> 5] = last;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = -1;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) m = max(m, redm[i]);
    cnt[blockIdx.x] = nz[0];
    key[blockIdx.x] = m < 0 ? -1 : T.rowkey + m;
  }
}

// One block, in place: cnt -> its exclusive sum (each tile's first slot),
// key -> its exclusive max (the last nonzero before each tile); *found the
// sum of all counts, held at kIntMax where it is larger
__global__ void __launch_bounds__(kScanThreads)
compact_scan_kernel(int64_t* __restrict__ cnt, int64_t* __restrict__ key,
                    int64_t tiles, int* __restrict__ found) {
  __shared__ int64_t ws[kScanThreads / 32];
  __shared__ int64_t wm[kScanThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int64_t per = (tiles + kScanThreads - 1) / kScanThreads;
  const int64_t a = min64(tiles, tid * per), b = min64(tiles, a + per);
  int64_t s = 0, m = -1;
  for (int64_t i = a; i < b; ++i) {
    s += cnt[i];
    m = max64(m, key[i]);
  }
  int64_t is = s, im = m;  // inclusive over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t ys = __shfl_up_sync(0xffffffffu, is, o);
    const int64_t ym = __shfl_up_sync(0xffffffffu, im, o);
    if (lane >= o) {
      is += ys;
      im = max64(im, ym);
    }
  }
  int64_t em = __shfl_up_sync(0xffffffffu, im, 1);
  if (lane == 0) em = -1;
  if (lane == 31) {
    ws[wid] = is;
    wm[wid] = im;
  }
  __syncthreads();
  if (wid == 0) {
    int64_t xs = ws[lane], xm = wm[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t ys = __shfl_up_sync(0xffffffffu, xs, o);
      const int64_t ym = __shfl_up_sync(0xffffffffu, xm, o);
      if (lane >= o) {
        xs += ys;
        xm = max64(xm, ym);
      }
    }
    ws[lane] = xs;
    wm[lane] = xm;
  }
  __syncthreads();
  int64_t es = is - s + (wid ? ws[wid - 1] : 0);
  if (wid) em = max64(em, wm[wid - 1]);
  for (int64_t i = a; i < b; ++i) {
    const int64_t c = cnt[i], k = key[i];
    cnt[i] = es;
    key[i] = em;
    es += c;
    em = max64(em, k);
  }
  if (tid == 0) *found = (int)min64(ws[kScanThreads / 32 - 1], kIntMax);
}

// per tile: its nonzeros in position order at off[t] on, each with the
// zero run before it (from carry[t] for the first)
__global__ void __launch_bounds__(kThreads)
compact_scatter_kernel(CPlanes P, const int64_t* __restrict__ off,
                       const int64_t* __restrict__ carry,
                       int* __restrict__ runs, int* __restrict__ vals,
                       int64_t cap) {
  __shared__ int s_pos[kCTile];
  __shared__ int s_val[kCTile];
  __shared__ int s_wc[kCPer * kWarps];  // warp counts, (step, warp) order
  __shared__ int s_total;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const CTile T = locate_tile(P, blockIdx.x);
  int v[kCPer];
  unsigned m[kCPer];
  load_tile(T, v);
#pragma unroll
  for (int j = 0; j < kCPer; ++j) {
    m[j] = __ballot_sync(0xffffffffu, v[j] != 0);
    if (lane == 0) s_wc[j * kWarps + wid] = __popc(m[j]);
  }
  __syncthreads();
  if (wid == 0) {
    // exclusive scan of the warp counts, kE consecutive ones a lane
    constexpr int kE = kCPer * kWarps / 32;
    int e[kE];
    int s = 0;
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      e[i] = s;
      s += s_wc[lane * kE + i];
    }
    int inc = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += y;
    }
#pragma unroll
    for (int i = 0; i < kE; ++i) s_wc[lane * kE + i] = inc - s + e[i];
    if (lane == 31) s_total = inc;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kCPer; ++j) {
    if (v[j] != 0) {
      const int k = s_wc[j * kWarps + wid] + __popc(m[j] & below);
      s_pos[k] = T.x0 + j * kThreads + tid;
      s_val[k] = v[j];
    }
  }
  __syncthreads();
  const int total = s_total;
  const int64_t o0 = off[blockIdx.x];
  const int64_t ck = carry[blockIdx.x];
  const int prev0 = ck >= T.rowkey ? (int)(ck - T.rowkey) : -1;
  for (int k = tid; k < total && o0 + k < cap; k += kThreads) {
    runs[o0 + k] = s_pos[k] - (k ? s_pos[k - 1] : prev0) - 1;
    vals[o0 + k] = s_val[k];
  }
}

}  // namespace

// Quantize C planes (H, W) at coefs (plane z at + z * cbatch) with
// write-back: qvals (C, N) in traversal order, work (+ z * wbatch) the
// written-back grid with the raw DC. q: int32 per plane (+ z * qstride)
// or null for qscalar; stable: nbv * nbh flags per plane (+ z * sstride),
// u8 when stable_u8 else int32.
extern "C" int dsv1_hzcc_quant(const int* coefs, int64_t cbatch, int H, int W,
                               int C, const int* segs, int nseg, int nbh,
                               int nbv, const int* q, int64_t qstride,
                               int qscalar, const void* stable,
                               int64_t sstride, int stable_u8, int is_p,
                               int plane, int* qvals, int64_t N, int* work,
                               int64_t wbatch, cudaStream_t stream) {
  Segs S;
  if (C < 1 || C > 65535 || H < 1 || W < 1 ||
      !make_segs(segs, nseg, H, W, nbh, nbv, &S))
    return (int)cudaErrorInvalidValue;
  const Args A{q, qstride, qscalar, stable, sstride, stable_u8, nbh, is_p,
               plane > 0};
  const int64_t tiles4 = (int64_t)((W + 4 * kTileX - 1) / (4 * kTileX)) *
                        ((H + kTileH - 1) / kTileH) * C;
  if (tiles4 >= kMinTiles4)
    hzcc_quant_kernel<4><<<dim3((W + 4 * kTileX - 1) / (4 * kTileX),
                                (H + kTileH - 1) / kTileH, C),
                           dim3(kTileX, kTileH), 0, stream>>>(
        coefs, cbatch, H, W, S, A, qvals, N, work, wbatch);
  else
    hzcc_quant_kernel<1><<<dim3((W + kTileX - 1) / kTileX,
                                (H + kTileH - 1) / kTileH, C),
                           dim3(kTileX, kTileH), 0, stream>>>(
        coefs, cbatch, H, W, S, A, qvals, N, work, wbatch);
  return (int)cudaGetLastError();
}

// Dequantize C grids (H, W) of quantized values at qgrid (+ z * gbatch)
// into out (+ z * obatch), the raw DC of plane z at dc + z * dcstride (or
// dcscalar where dc is null); q and stable as in dsv1_hzcc_quant.
extern "C" int dsv1_hzcc_dequant(const int* qgrid, int64_t gbatch, int H,
                                 int W, int C, const int* segs, int nseg,
                                 int nbh, int nbv, const int* q,
                                 int64_t qstride, int qscalar,
                                 const void* stable, int64_t sstride,
                                 int stable_u8, int is_p, int plane,
                                 const int* dc, int64_t dcstride,
                                 int dcscalar, int* out, int64_t obatch,
                                 cudaStream_t stream) {
  Segs S;
  if (C < 1 || C > 65535 || H < 1 || W < 1 ||
      !make_segs(segs, nseg, H, W, nbh, nbv, &S))
    return (int)cudaErrorInvalidValue;
  const Args A{q, qstride, qscalar, stable, sstride, stable_u8, nbh, is_p,
               plane > 0};
  hzcc_dequant_kernel<<<grid_of(H, W, C), dim3(32, 8), 0, stream>>>(
      qgrid, gbatch, H, W, S, A, dc, dcstride, dcscalar, out, obatch);
  return (int)cudaGetLastError();
}

// Every symbol of a chunk's three planes of the same rows, plane c at qc
// (rows of nc positions, packed; positions over all rows may pass 2^31):
// out[0, total) the runs (u32 bits), out[total, 2 total) the values,
// plane 0's rows first, each row in traversal order; out[2 total] the
// count found (the lists are whole where it is total, which is under
// kIntMax). scratch: 2 * tiles int64, tiles = rows * sum over planes of
// ceil(nc / kCTile).
extern "C" int dsv1_hzcc_compact(const int* q0, int n0, const int* q1,
                                 int n1, const int* q2, int n2,
                                 int64_t rows, int64_t* scratch,
                                 int64_t tiles, int* out, int64_t total,
                                 cudaStream_t stream) {
  if (rows < 1 || total < 0 || total >= kIntMax)
    return (int)cudaErrorInvalidValue;
  const int* qs[3] = {q0, q1, q2};
  const int ns[3] = {n0, n1, n2};
  CPlanes P;
  int64_t tb = 0, kb = 0;
  for (int c = 0; c < 3; ++c) {
    if (ns[c] < 1 || ns[c] > kIntMax - kCTile)
      return (int)cudaErrorInvalidValue;
    P.q[c] = qs[c];
    P.n[c] = ns[c];
    P.tpr[c] = (ns[c] + kCTile - 1) / kCTile;
    P.tbase[c] = tb;
    P.kbase[c] = kb;
    tb += rows * P.tpr[c];
    kb += rows * ns[c];
  }
  if (tb != tiles || tiles > kIntMax) return (int)cudaErrorInvalidValue;
  int64_t* cnt = scratch;
  int64_t* key = scratch + tiles;
  const unsigned grid = (unsigned)tiles;
  compact_count_kernel<<<grid, kThreads, 0, stream>>>(P, cnt, key);
  compact_scan_kernel<<<1, kScanThreads, 0, stream>>>(cnt, key, tiles,
                                                      out + 2 * total);
  compact_scatter_kernel<<<grid, kThreads, 0, stream>>>(P, cnt, key, out,
                                                        out + total, total);
  return (int)cudaGetLastError();
}
