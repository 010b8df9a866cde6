// The recon chain's per-frame tensor work around the forward Haar pyramid
// (csrc/sbt.cu) and the HZCC kernels (csrc/hzcc.cu), for a batch of planes:
//
// - residual_in: the encode core's prologue. From the u8 frame image (and
//   for P frames the MC prediction) the centred int32 coefficient planes
//   of all three planes in one launch: clamp(src - pred + 128) - 128 for
//   P, src - 128 for I, the border column of a chroma plane whose
//   coefficient width is rounded up to even read from the frame's
//   replicated edge (src - 128, I and P alike), rows below the plane 0.
//   Replaces the XLA code of dsv1_tpu/models/encoder.py:219-258 and
//   bmc.sub_residual.
// - b4t_fwd: the intra level 1, the 4-tap biorthogonal transform (B4T)
//   of a whole plane, rows then columns, with edge replication and
//   round2 (reference sbt.c:90-251), plus the contiguous copy of its LL
//   quadrant that the Haar levels read. Replaces the XLA code of
//   `_b4t_fwd_2d` (dsv1_tpu/ops/sbt.py:288).
// - inv_sbt: the whole inverse pyramid (reference sbt.c:351-714): levels
//   top..2 with the x5/4 inverse scale, the luma LH/HL nudge filter
//   (sbt.c:437-574) on every level, level 1 Haar for P planes or the B4T
//   inverse of the raw bands for I planes (columns then rows, round8),
//   and the recon epilogue: +128 clamped to u8 (sbc2int, sbt.c:594-614)
//   and, for P planes, clamp(pred + rp - 128) (addf, bmc.c:29-41), two
//   clamps, written with the 64-pixel replicated border into the plane's
//   rows of the frame image. Replaces the XLA code of `inv_sbt` +
//   `coefs_to_plane` + `add_residual` (dsv1_tpu/ops/sbt.py:434, :499,
//   dsv1_tpu/ops/bmc.py).
//
// Exactness: C's truncating division (the inverse's / 4 and the scales),
// the sign-symmetric round2/round4/round8 of negative values, and the
// u8 clamps are those of ops/cint.py and the plain versions; all
// arithmetic is int32, as there.
//
// inv_sbt's split: each level needs the whole LL region of the level
// above, so levels are sequential. As in the forward pyramid, the small
// levels (the top levels, whose output has at most ops/sbt.py's
// INV_SMALL_MAX values) run in one thread block per plane in shared
// memory, the last of them writing to device memory; every larger level is one
// launch over the batch, one thread per output pixel, the LL region read
// from the previous level's buffer and the bands from the coefficient
// array; the last level (level 1) carries the epilogue, or writes int32
// where the caller asks for the coefficient plane. The wrapper
// (ops/sbt.py `inv_plan`) chooses the split; its launches are 1 (the
// small stage, when the top level is above 1) plus one per remaining
// level.
//
// Bound by memory, all three: residual_in reads 1 or 2 bytes and writes
// 4 a position, b4t_fwd reads 4 and writes 4 plus 1 for the LL copy,
// inv_sbt reads each band value once and the last level's 4 bytes, its
// coarser levels a third more, and writes one u8 (the border too). Each
// thread reads its taps (up to 16 values for a B4T output) from the L1
// cache, which its neighbours share; a thread takes one output and
// neighbouring threads neighbouring columns, so writes coalesce.

#include "common.cuh"

using namespace dsv1;

namespace {

constexpr int kMinQuant = 16;  // MINQUANT
constexpr int kMaxLvl = 3;     // MAXLVL
constexpr int kQpI = 3, kQpP = 1;
constexpr int kSmallThreads = 512;

__device__ __forceinline__ int round_sym(int v, int add, int shift) {
  const int r = (absi(v) + add) >> shift;
  return v < 0 ? -r : r;
}
__device__ __forceinline__ int round2(int v) { return round_sym(v, 1, 1); }
__device__ __forceinline__ int round4(int v) { return round_sym(v, 2, 2); }
__device__ __forceinline__ int round8(int v) { return round_sym(v, 4, 3); }

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

// get_HQP (sbt.c:667-696)
__device__ __forceinline__ int hqp_for_level(int q, int is_p, int i) {
  const int llq = get_quant(q, is_p, 0) / 2;
  if (i > 3) return llq;
  int hqp = get_quant(q, is_p, kMaxLvl - i);
  if (i == 1) {
    hqp = lb2(hqp) - (is_p ? kQpP : kQpI);
    hqp = (1 << clampi(hqp, 1, 24)) >> 1;
  }
  return hqp / 2;
}

__device__ __forceinline__ int round_shift(int x, int s) {
  return (x + (1 << s) - 1) >> s;
}

// A level's geometry (_quad_dims, sbt.c:630-651)
struct Quad {
  int ws, hs, cw, ch, fw, fh;
};

__device__ __forceinline__ Quad quad_dims(int W, int H, int lvl) {
  Quad d;
  d.ws = round_shift(W, lvl - 1);
  d.hs = round_shift(H, lvl - 1);
  d.cw = (d.ws + 1) / 2;
  d.ch = (d.hs + 1) / 2;
  d.fw = d.ws / 2;
  d.fh = d.hs / 2;
  return d;
}

__device__ __forceinline__ int nudge(int LL, int lo, int hi, int band,
                                     int hqp) {
  const int mx = LL - hi, mn = lo - LL;
  const int mx3 = min(max(mn, mx), 0), mn3 = max(min(mn, mx), 0);
  if (mx3 == mn3) return band;
  const int t = round4(lo - hi);
  const int nd = round2(min(max(t, mx3), mn3) - band * 2);
  return band + clampi(nd, -hqp, hqp);
}

// One output pixel (y, x) of a Haar inverse level (sbt.c:351-574). ll:
// the LL region entering the level (row stride lls, before the scale);
// a: the coefficient array (row stride as) holding the level's bands.
// hqp < 0: no filter (chroma).
__device__ __forceinline__ int haar_inv_px(const int* ll, int64_t lls,
                                           const int* a, int64_t as,
                                           const Quad& d, bool scale,
                                           int hqp, int y, int x) {
  const int qy = y >> 1, qx = x >> 1;
  auto sc = [scale](int v) { return scale ? v * 5 / 4 : v; };
  const int LL = sc(ll[qy * lls + qx]);
  int LH = qx < d.fw ? a[qy * as + d.cw + qx] : 0;
  int HL = qy < d.fh ? a[(d.ch + qy) * as + qx] : 0;
  const int HH = (qy < d.fh && qx < d.fw) ? a[(d.ch + qy) * as + d.cw + qx]
                                          : 0;
  if (hqp >= 0) {
    if (qx >= 1 && qx <= d.fw - 1 && qy <= d.fh - 1) {
      const int lp = sc(ll[qy * lls + qx - 1]);
      const int ln = sc(qx + 1 < d.cw ? ll[qy * lls + qx + 1]
                                      : a[qy * as + d.cw]);
      LH = nudge(LL, lp, ln, LH, hqp);
    }
    if (qy >= 1 && qy <= d.fh - 1 && qx <= d.fw - 1) {
      const int up = sc(ll[(qy - 1) * lls + qx]);
      const int dn = sc(qy + 1 < d.ch ? ll[(qy + 1) * lls + qx]
                                      : a[d.ch * as + qx]);
      HL = nudge(LL, up, dn, HL, hqp);
    }
  }
  const int sy = (y & 1) ? -1 : 1, sx = (x & 1) ? -1 : 1;
  return (LL + sx * LH + sy * HL + sx * sy * HH) / 4;
}

// The value at (r, c) of level 1's in-place state of an intra plane: the
// reconstructed LL corner from ll, the raw bands from a.
__device__ __forceinline__ int b4t_full(const int* ll, int64_t lls,
                                        const int* a, int64_t as, int ch,
                                        int cw, int r, int c) {
  return (r < ch && c < cw) ? ll[r * lls + c] : a[r * as + c];
}

// inverse B4T of one column c at output row y (n rows, m = n / 2): L rows
// at 0..m-1, H rows at m..n-1 (sbt.c:195-238)
__device__ __forceinline__ int b4t_inv_col(const int* ll, int64_t lls,
                                           const int* a, int64_t as, int ch,
                                           int cw, int m, int y, int c) {
  const int k = y >> 1;
  auto F = [&](int r) { return b4t_full(ll, lls, a, as, ch, cw, r, c); };
  if ((y & 1) == 0) {
    const int kp = max(k - 1, 0);
    return round8(F(kp) + 3 * F(k) + F(m + kp) - 3 * F(m + k));
  }
  const int kn = min(k + 1, m - 1);
  return round8(3 * F(k) + F(kn) + 3 * F(m + k) - F(m + kn));
}

// One output pixel (y, x) of the intra level 1: the B4T inverse of the
// (H, W) in-place state, columns then rows (inv_b4t_2d, sbt.c:253-265).
__device__ __forceinline__ int b4t_inv_px(const int* ll, int64_t lls,
                                          const int* a, int64_t as, int H,
                                          int W, int y, int x) {
  const int ch = H / 2, cw = W / 2, mw = W / 2, j = x >> 1;
  auto V = [&](int c) { return b4t_inv_col(ll, lls, a, as, ch, cw, H / 2, y,
                                           c); };
  if ((x & 1) == 0) {
    const int jp = max(j - 1, 0);
    return round8(V(jp) + 3 * V(j) + V(mw + jp) - 3 * V(mw + j));
  }
  const int jn = min(j + 1, mw - 1);
  return round8(3 * V(j) + V(jn) + 3 * V(mw + j) - V(mw + jn));
}

// One output value of the forward B4T along a line of n values at
// f(0..n-1): index X < n / 2 is L at X, else H at X - n / 2 (sbt.c:90-147)
template <class Fn>
__device__ __forceinline__ int b4t_fwd_1d(Fn f, int n, int X) {
  const int m = n / 2;
  const bool hi = X >= m;
  const int j = hi ? X - m : X;
  const int e = f(2 * j), o = f(2 * j + 1);
  const int x0 = f(j > 0 ? 2 * j - 1 : 1);
  const int x3 = f(j < m - 1 ? 2 * j + 2 : 2 * j + 1);
  return hi ? round2(x0 - 3 * e + 3 * o - x3) : round2(3 * (e + o) - x0 - x3);
}

// Per-plane arguments of inv_sbt
struct Inv {
  const int* a;     // coefficient array (H, W), row stride as
  int64_t as, abatch;
  int H, W;
  const int* q;     // quant per plane (+ z * qstride), or null: qscalar
  int64_t qstride;
  int qscalar;
  int is_p, luma;
};

__device__ __forceinline__ int level_hqp(const Inv& P, int b, int i) {
  if (!P.luma) return -1;
  const int q = P.q ? P.q[b * P.qstride] : P.qscalar;
  return hqp_for_level(q, P.is_p, i);
}

// Small stage: one block per plane runs levels top..lo (lo >= 2) in
// shared memory; level lo's output goes to dst (+ z * dbatch, row stride
// its width).
__global__ void __launch_bounds__(kSmallThreads)
inv_small_kernel(Inv P, int top, int lo, int* __restrict__ dst,
                 int64_t dbatch, int bufn) {
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  const int* a = P.a + b * P.abatch;
  int* bufs[2] = {smem, smem + bufn};
  const int* cur = a;  // level top reads the LL corner of a
  int64_t curs = P.as;
  for (int i = top, k = 0; i >= lo; --i, k ^= 1) {
    const Quad d = quad_dims(P.W, P.H, i);
    const int hqp = level_hqp(P, b, i);
    int* out = i == lo ? dst + b * dbatch : bufs[k];
    for (int p = threadIdx.x; p < d.hs * d.ws; p += kSmallThreads) {
      const int y = p / d.ws, x = p - y * d.ws;
      out[p] = haar_inv_px(cur, curs, a, P.as, d, true, hqp, y, x);
    }
    __syncthreads();
    cur = out;
    curs = d.ws;
  }
}

// One level i >= 2 over the batch: the LL region at ll (row stride lls,
// + z * lbatch) into dst (+ z * dbatch, row stride the level's width).
__global__ void __launch_bounds__(kThreads)
inv_level_kernel(Inv P, int i, const int* __restrict__ ll, int64_t lls,
                 int64_t lbatch, int* __restrict__ dst, int64_t dbatch) {
  const Quad d = quad_dims(P.W, P.H, i);
  const int x = blockIdx.x * 32 + threadIdx.x;
  const int y = blockIdx.y * 8 + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= d.ws || y >= d.hs) return;
  dst[b * dbatch + (int64_t)y * d.ws + x] =
      haar_inv_px(ll + b * lbatch, lls, P.a + b * P.abatch, P.as, d, true,
                  level_hqp(P, b, i), y, x);
}

// Where level 1 writes: mode 0 int32 (H, W) at out (row stride ostride,
// + z * obatch); mode 1 the u8 plane (h, w) with its `ext` border into
// the image at out (pixel (0, 0), row stride ostride, + z * obatch),
// +128 clamped; mode 2 the same after the residual add of pred (h, w) at
// pred (row stride pstride, + z * pbatch).
struct Epi {
  void* out;
  int64_t ostride, obatch;
  int mode, h, w, ext;
  const uint8_t* pred;
  int64_t pstride, pbatch;
};

__global__ void __launch_bounds__(kThreads)
inv_last_kernel(Inv P, const int* __restrict__ ll, int64_t lls,
                int64_t lbatch, Epi E) {
  const int X = blockIdx.x * 32 + threadIdx.x;
  const int Y = blockIdx.y * 8 + threadIdx.y;
  const int b = blockIdx.z;
  const int rows = E.mode ? E.h + 2 * E.ext : P.H;
  const int cols = E.mode ? E.w + 2 * E.ext : P.W;
  if (X >= cols || Y >= rows) return;
  // an image pixel replicates the plane's nearest edge pixel
  const int y = E.mode ? clampi(Y - E.ext, 0, E.h - 1) : Y;
  const int x = E.mode ? clampi(X - E.ext, 0, E.w - 1) : X;
  const int* a = P.a + b * P.abatch;
  const int* l = ll + b * lbatch;
  int v;
  if (P.is_p) {
    const Quad d = quad_dims(P.W, P.H, 1);
    v = haar_inv_px(l, lls, a, P.as, d, false, level_hqp(P, b, 1), y, x);
  } else {
    v = b4t_inv_px(l, lls, a, P.as, P.H, P.W, y, x);
  }
  if (E.mode == 0) {
    static_cast<int*>(E.out)[b * E.obatch + (int64_t)y * E.ostride + x] = v;
    return;
  }
  int r = clampi(v + 128, 0, 255);  // sbc2int
  if (E.mode == 2)                  // addf
    r = clampi((int)E.pred[b * E.pbatch + (int64_t)y * E.pstride + x] + r -
                   128, 0, 255);
  static_cast<uint8_t*>(E.out)[b * E.obatch +
                               (int64_t)(Y - E.ext) * E.ostride +
                               (X - E.ext)] = (uint8_t)r;
}

__global__ void __launch_bounds__(kThreads)
b4t_fwd_kernel(const int* __restrict__ src, int64_t sbatch, int H, int W,
               int* __restrict__ out, int64_t obatch, int* __restrict__ ll,
               int64_t lbatch) {
  const int X = blockIdx.x * 32 + threadIdx.x;
  const int Y = blockIdx.y * 8 + threadIdx.y;
  const int b = blockIdx.z;
  if (X >= W || Y >= H) return;
  const int* s = src + b * sbatch;
  // rows then columns: the vertical pass over the horizontal outputs
  auto hz = [&](int r) {
    return b4t_fwd_1d([&](int c) { return s[(int64_t)r * W + c]; }, W, X);
  };
  const int v = b4t_fwd_1d(hz, H, Y);
  out[b * obatch + (int64_t)Y * W + X] = v;
  if (Y < H / 2 && X < W / 2) ll[b * lbatch + (int64_t)Y * (W / 2) + X] = v;
}

// Per plane of residual_in
struct Res {
  int64_t src;      // flat index of pixel (0, 0) in the image
  int64_t sstride;  // image row stride
  int64_t pred;     // offset of the plane's prediction in its buffer
  int64_t pstride;  // prediction row stride
  int64_t out;      // offset of the plane's (C, ch, cw) block in out
  int h, w, ch, cw;
};

struct ResFrame {
  Res p[3];
};

__global__ void __launch_bounds__(kThreads)
residual_in_kernel(const uint8_t* __restrict__ img, int64_t ibatch,
                   const uint8_t* __restrict__ pred, int64_t pbatch,
                   int* __restrict__ out, ResFrame F, int is_p) {
  const Res& R = F.p[blockIdx.z];
  const int b = blockIdx.y;
  const int64_t n = (int64_t)R.ch * R.cw;
  const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const int y = (int)(p / R.cw), x = (int)(p - (int64_t)y * R.cw);
  int v = 0;
  if (y < R.h) {
    const int s = img[b * ibatch + R.src + y * R.sstride + x];
    v = s - 128;
    if (is_p && x < R.w) {  // subf, then centred
      const int pr = pred[b * pbatch + R.pred + y * R.pstride + x];
      v = clampi(s - pr + 128, 0, 255) - 128;
    }
  }
  out[R.out + b * n + p] = v;
}

}  // namespace

// The inverse pyramid of C planes (H, W) at a (+ z * abatch, row stride
// as), levels top..1, the small stage running top..small_lo (none when
// small_lo > top; small_lo >= 2), then one launch per level. s0, s1:
// scratch of C * round_shift(H, 1) * round_shift(W, 1) ints each. q: int32
// per plane (+ z * qstride) or null for qscalar. mode, out, ostride,
// obatch, h, w, ext, pred, pstride, pbatch: the last level's output (see
// Epi).
extern "C" int dsv1_inv_sbt(const int* a, int64_t as, int64_t abatch, int H,
                            int W, int C, int top, int small_lo,
                            const int* q, int64_t qstride, int qscalar,
                            int is_p, int luma, int* s0, int* s1, int mode,
                            void* out, int64_t ostride, int64_t obatch, int h,
                            int w, int ext, const uint8_t* pred,
                            int64_t pstride, int64_t pbatch,
                            cudaStream_t stream) {
  if (C < 1 || C > 65535 || top < 1 || H < 2 || W < 2 || h > H || w > W ||
      (!is_p && (H % 2 || W % 2)) || mode < 0 || mode > 2 ||
      (mode == 2 && !pred))
    return (int)cudaErrorInvalidValue;
  const Inv P{a, as, abatch, H, W, q, qstride, qscalar, is_p, luma};
  const int64_t lvl_n =
      (int64_t)((H + 1) / 2) * ((W + 1) / 2);  // largest LL region
  const int* ll = a;  // the LL region entering the next level
  int64_t lls = as, lbatch = abatch;
  int* bufs[2] = {s0, s1};
  int k = 0, i = top;
  if (small_lo <= top && top >= 2) {
    // the small stage's buffers hold its largest level's output
    int bufn = 1;
    for (int j = top; j > small_lo; --j) {
      const int hs = (H + (1 << (j - 1)) - 1) >> (j - 1);
      const int ws = (W + (1 << (j - 1)) - 1) >> (j - 1);
      bufn = hs * ws > bufn ? hs * ws : bufn;
    }
    const size_t smem = 2 * (size_t)bufn * sizeof(int);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          inv_small_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    inv_small_kernel<<<C, kSmallThreads, smem, stream>>>(P, top, small_lo,
                                                         bufs[k], lvl_n, bufn);
    ll = bufs[k];
    lls = (W + (1 << (small_lo - 1)) - 1) >> (small_lo - 1);
    lbatch = lvl_n;
    k ^= 1;
    i = small_lo - 1;
  }
  for (; i >= 2; --i) {
    const int hs = (H + (1 << (i - 1)) - 1) >> (i - 1);
    const int ws = (W + (1 << (i - 1)) - 1) >> (i - 1);
    inv_level_kernel<<<dim3((ws + 31) / 32, (hs + 7) / 8, C), dim3(32, 8), 0,
                       stream>>>(P, i, ll, lls, lbatch, bufs[k], lvl_n);
    ll = bufs[k];
    lls = ws;
    lbatch = lvl_n;
    k ^= 1;
  }
  const Epi E{out, ostride, obatch, mode, h, w, ext, pred, pstride, pbatch};
  const int rows = mode ? h + 2 * ext : H, cols = mode ? w + 2 * ext : W;
  inv_last_kernel<<<dim3((cols + 31) / 32, (rows + 7) / 8, C), dim3(32, 8), 0,
                    stream>>>(P, ll, lls, lbatch, E);
  return (int)cudaGetLastError();
}

// The intra level 1 of C planes (H, W) (even) at src (+ z * sbatch,
// contiguous rows) into out (+ z * obatch), its LL quadrant also into ll
// (+ z * lbatch, row stride W / 2).
extern "C" int dsv1_b4t_fwd(const int* src, int64_t sbatch, int H, int W,
                            int C, int* out, int64_t obatch, int* ll,
                            int64_t lbatch, cudaStream_t stream) {
  if (C < 1 || C > 65535 || H < 2 || W < 2 || H % 2 || W % 2)
    return (int)cudaErrorInvalidValue;
  b4t_fwd_kernel<<<dim3((W + 31) / 32, (H + 7) / 8, C), dim3(32, 8), 0,
                   stream>>>(src, sbatch, H, W, out, obatch, ll, lbatch);
  return (int)cudaGetLastError();
}

// The centred coefficient planes of C frames: images at img (+ z *
// ibatch), for P frames the predictions at pred (+ z * pbatch), into out;
// geo: 9 int64 per plane (src, sstride, pred, pstride, out, h, w, ch, cw).
extern "C" int dsv1_residual_in(const uint8_t* img, int64_t ibatch,
                                const uint8_t* pred, int64_t pbatch, int* out,
                                const int64_t* geo, int C, int is_p,
                                cudaStream_t stream) {
  if (C < 1 || C > 65535 || (is_p && !pred)) return (int)cudaErrorInvalidValue;
  ResFrame F;
  int64_t nmax = 1;
  for (int c = 0; c < 3; ++c) {
    const int64_t* g = geo + 9 * c;
    Res& R = F.p[c];
    R.src = g[0];
    R.sstride = g[1];
    R.pred = g[2];
    R.pstride = g[3];
    R.out = g[4];
    R.h = (int)g[5];
    R.w = (int)g[6];
    R.ch = (int)g[7];
    R.cw = (int)g[8];
    if (R.h > R.ch || R.w > R.cw || R.h < 1 || R.w < 1)
      return (int)cudaErrorInvalidValue;
    nmax = (int64_t)R.ch * R.cw > nmax ? (int64_t)R.ch * R.cw : nmax;
  }
  residual_in_kernel<<<dim3((unsigned)((nmax + kThreads - 1) / kThreads), C,
                            3),
                       kThreads, 0, stream>>>(img, ibatch, pred, pbatch, out,
                                              F, is_p);
  return (int)cudaGetLastError();
}
