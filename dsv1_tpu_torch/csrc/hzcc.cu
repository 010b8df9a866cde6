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
// One thread per grid position. The traversal is a concatenation of at
// most kMaxSegs rectangles; a thread walks them in traversal order and,
// for each one that contains its position, computes the TMQ from the
// stability flag of its block (the 14-bit fixed-point block map of
// build_tables), quantizes the value it currently holds, writes that
// quantized value at the segment's offset plus its raster index, and
// carries the write-back on. Quantization is elementwise, so that chain
// is the sequential band order even where odd ceil dims make bands alias:
// the encoder quantizes what an earlier band wrote back. The decoder
// dequantizes the grid value itself for every segment, so the last
// segment wins (the parser's visit order). Positions no segment covers
// keep their value (encoder) or become 0 (decoder). The DC is zeroed
// before the chain and restored after it.
//
// The quant is a scalar or a device int32 per plane of the batch (an ABR
// decode carries one per picture): the kernel derives the plane's
// quantizer parameters from it (frame_quants) and never hands it back to
// the host.
//
// Bound by memory: the encoder reads each int32 coefficient and writes it
// back and writes about one quantized value per position (12 bytes a
// position, about 25 MB for a 1080p luma plane: 7.4 us at 3.35 TB/s);
// the decoder reads and writes 8 bytes a position. The stability map is a
// few KB and stays in L1. Neighbouring threads take neighbouring columns,
// so every read and write is a coalesced row segment.

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

__device__ __forceinline__ int quant_lo(int v, int q) {
  if (v == 0) return 0;
  const int a = absi(v) << 1;
  if (a <= q) return 0;
  const int mag = (a + 1) / (q << 1);
  return v < 0 ? -mag : mag;
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

__global__ void __launch_bounds__(kThreads)
hzcc_quant_kernel(const int* __restrict__ coefs, int64_t cbatch, int H,
                  int W, Segs S, Args A, int* __restrict__ qvals, int64_t N,
                  int* __restrict__ work, int64_t wbatch) {
  const int x = blockIdx.x * 32 + threadIdx.x;
  const int y = blockIdx.y * 8 + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= W || y >= H) return;
  const Quants Q = frame_quants(plane_quant(A, b), A.is_p, A.chroma);
  const int raw = coefs[b * cbatch + (int64_t)y * W + x];
  int v = (x == 0 && y == 0) ? 0 : raw;  // hzcc.c:171 src[0] = 0
  int* qo = qvals + b * N;
  for (int k = 0; k < S.n; ++k) {
    const int ly = y - S.oy[k], lx = x - S.ox[k];
    if (ly < 0 || lx < 0 || ly >= S.sh[k] || lx >= S.sw[k]) continue;
    int hi;
    const int p = seg_param(S, k, ly, lx, Q, A, b, &hi);
    const int qv = hi ? quant_hi(v, p) : quant_lo(v, p);
    qo[S.off[k] + ly * S.sw[k] + lx] = qv;
    v = qv == 0 ? 0 : (hi ? dequant_hi(qv, p) : dequant_lo(qv, p));
  }
  // dsv_encode_plane restores the raw DC
  work[b * wbatch + (int64_t)y * W + x] = (x == 0 && y == 0) ? raw : v;
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
  hzcc_quant_kernel<<<grid_of(H, W, C), dim3(32, 8), 0, stream>>>(
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
