// Hierarchical motion estimation search, one thread block per motion block.
//
// Replaces two Pallas TPU kernels of dsv1_tpu/ops/pallas_hme.py:
//   hme_refine_kernel  <- `_refine_kernel` (pallas_hme.py:130): one coarse
//     pyramid level — masked SAD of up to NC candidate MVs (>> level) with
//     border-validity bounds and a strict first-minimum pick, the full-pel
//     clamp, then the 9-point XF/YF refine (reference hme.c:452-541).
//   hme_base_kernel    <- `_base_kernel`, banded=False (pallas_hme.py:339):
//     level 0 at effort 0 — the same search, the 8-point half-pel refine
//     on 14x14 windows with the 4-tap luma filters applied in-kernel, the
//     block texture/variance statistics with the reference's u32 wrap, the
//     zero-MV intra test, the luma GO_INTRA cascade and the quadrant
//     good/evil metric (hme.c:543-716).
//
// Bound by window loads and integer reductions, not by arithmetic: a
// block reads its source window once into shared memory and compares it
// against 6 candidate windows, a (BH+2) x (BW+2) refine window and a
// 24 x 24 half-pel neighbourhood. The source, refine and neighbourhood
// windows sit in shared memory; candidate windows are read once each,
// straight from device memory (neighbouring blocks' candidates overlap,
// so many of those reads hit L2). Every sum of a
// stage is accumulated per thread and reduced once per stage (warp
// shuffles + one shared pass). Windows read the unpadded extended
// (EH, S) plane, every origin clamped into it exactly as the Pallas
// bodies clamp (the C reference reads out of bounds there). Unsigned
// arithmetic is plain uint32_t.

#include "common.cuh"

using namespace dsv1;

namespace {

constexpr int kMaxBlk = 64;         // MAX_BLOCK_SIZE
constexpr int kMaxNC = 6;           // zero MV + 5 parent candidates
constexpr int kHP = 14;             // HP_SAD_SZ
constexpr int kNB = 24;             // half-pel neighbourhood
__constant__ int XF[9] = {0, 1, -1, 0, 0, -1, 1, -1, 1};
__constant__ int YF[9] = {0, 0, 0, 1, -1, -1, -1, 1, 1};
__constant__ int XH[8] = {1, -1, 0, 0, -1, 1, -1, 1};
__constant__ int YH[8] = {0, 0, 1, -1, -1, -1, 1, 1};

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

// Candidate search + 9-point refine shared by both kernels. s_src holds
// the BH x BW source window; s_pad is scratch for the refine window.
// Returns the refined full-pel (dx, dy) in level units and its SAD.
__device__ void search(const uint8_t* rp, const int* cand, int NC, int level,
                       const Block& b, int EH, int S, int E, int w, int h,
                       int BW, int BH, const uint8_t* s_src, uint8_t* s_pad,
                       int* red, int& dx, int& dy, int& best) {
  const int bnd = 64;  // FRAME_BORDER
  int acc[kMaxNC] = {0, 0, 0, 0, 0, 0};
  int rr[kMaxNC], cc[kMaxNC];
  for (int k = 0; k < NC; ++k) {
    rr[k] = clampi(E + b.by + (cand[NC + k] >> level), 0, EH - BH);
    cc[k] = clampi(E + b.bx + (cand[k] >> level), 0, S - BW);
  }
  for (int p = threadIdx.x; p < BH * BW; p += kThreads) {
    const int r = p / BW, c = p - r * BW;
    if (r >= b.bh_c || c >= b.bw_c) continue;
    const int s = s_src[p];
    for (int k = 0; k < NC; ++k)
      acc[k] += absi(s - rp[(int64_t)(rr[k] + r) * S + cc[k] + c]);
  }
  block_sum<kMaxNC>(acc, red);
  int bsad = kIntMax, bk = 0;
  for (int k = 0; k < NC; ++k) {
    const int rx = b.bx + (cand[k] >> level);
    const int ry = b.by + (cand[NC + k] >> level);
    const bool ok = rx >= -bnd && ry >= -bnd && rx + b.bw_c <= w + bnd &&
                    ry + b.bh_c <= h + bnd && b.inframe;
    const int sad = ok ? acc[k] : kIntMax;
    if (sad < bsad) {
      bsad = sad;
      bk = k;
    }
  }
  int bdx = cand[bk] >> level, bdy = cand[NC + bk] >> level;
  bdx = min(max(bdx, -b.bw_c - b.bx), w - b.bx);  // full-pel clamp
  bdy = min(max(bdy, -b.bh_c - b.by), h - b.by);

  // 9-point refine (hme.c:526-541) from one padded window
  const int PW = BW + 2;
  load_window(s_pad, rp, S, clampi(E + b.by + bdy - 1, 0, EH - (BH + 2)),
              clampi(E + b.bx + bdx - 1, 0, S - (BW + 2)), BH + 2, PW);
  __syncthreads();
  int a9[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  for (int p = threadIdx.x; p < BH * BW; p += kThreads) {
    const int r = p / BW, c = p - r * BW;
    if (r >= b.bh_c || c >= b.bw_c) continue;
    const int s = s_src[p];
#pragma unroll
    for (int k = 0; k < 9; ++k)
      a9[k] += absi(s - s_pad[(r + YF[k] + 1) * PW + c + XF[k] + 1]);
  }
  block_sum<9>(a9, red);
  best = kIntMax;
  int m9 = 0;
  for (int k = 0; k < 9; ++k) {
    if (a9[k] < best) {
      best = a9[k];
      m9 = k;
    }
  }
  dx = bdx + XF[m9];
  dy = bdy + YF[m9];
}

__global__ void __launch_bounds__(kThreads)
hme_refine_kernel(const uint8_t* __restrict__ src,
                  const uint8_t* __restrict__ ref,
                  const int* __restrict__ cm, int64_t pstride, int EH, int S,
                  int E, int w, int h, int nbh_l, int nb, int BW, int BH,
                  int NC, int level, int* odx, int* ody, int* obest) {
  __shared__ uint8_t s_src[kMaxBlk * kMaxBlk];
  __shared__ uint8_t s_pad[(kMaxBlk + 2) * (kMaxBlk + 2)];
  __shared__ int red[16 * kWarps];
  const int t = blockIdx.x, bb = blockIdx.y;
  const uint8_t* sp = src + bb * pstride;
  const uint8_t* rp = ref + bb * pstride;
  const int* cand = cm + ((int64_t)bb * nb + t) * 2 * NC;
  const Block b = block_of(t, nbh_l, BW, BH, w, h);
  load_window(s_src, sp, S, clampi(E + b.by, 0, (EH - BH) & ~7),
              clampi(E + b.bx, 0, S - BW), BH, BW);
  __syncthreads();
  int dx, dy, best;
  search(rp, cand, NC, level, b, EH, S, E, w, h, BW, BH, s_src, s_pad, red,
         dx, dy, best);
  if (threadIdx.x == 0) {
    const int64_t o = (int64_t)bb * nb + t;
    odx[o] = dx;
    ody[o] = dy;
    obest[o] = best;
  }
}

// Luma half-pel value of search point k at (i, j) of its 14 x 14 window,
// from the 24 x 24 neighbourhood nb (D.1.1, bmc.c:112-174): h and v use
// (x + 8) >> 4, the diagonal runs on unclamped h values with
// (x + 128) >> 8. The window origin in nb is (2 + (yh >> 1), 2 + (xh >> 1)).
__device__ __forceinline__ int hfil(const uint8_t* nb, int r, int c) {
  return 9 * (nb[r * kNB + c] + nb[r * kNB + c + 1]) -
         (nb[r * kNB + c - 1] + nb[r * kNB + c + 2]);
}

__device__ __forceinline__ int hpval(const uint8_t* nb, int k, int i, int j) {
  const int xh = XH[k], yh = YH[k];
  const int r = 2 + (yh >> 1) + i, c = 2 + (xh >> 1) + j;
  if ((xh & 1) && (yh & 1)) {
    const int d = 9 * (hfil(nb, r, c) + hfil(nb, r + 1, c)) -
                  (hfil(nb, r - 1, c) + hfil(nb, r + 2, c));
    return clampi((d + 128) >> 8, 0, 255);
  }
  if (xh & 1) return clampi((hfil(nb, r, c) + 8) >> 4, 0, 255);
  const int v = 9 * (nb[r * kNB + c] + nb[(r + 1) * kNB + c]) -
                (nb[(r - 1) * kNB + c] + nb[(r + 2) * kNB + c]);
  return clampi((v + 8) >> 4, 0, 255);
}

// The chosen prediction's centre window: half-pel point m, or the
// full-pel window (m < 0).
__device__ __forceinline__ int selval(const uint8_t* nb, int m, int i,
                                      int j) {
  return m < 0 ? nb[(2 + i) * kNB + 2 + j] : hpval(nb, m, i, j);
}

__global__ void __launch_bounds__(kThreads)
hme_base_kernel(const uint8_t* __restrict__ src,
                const uint8_t* __restrict__ ref, const int* __restrict__ cm,
                int64_t pstride, int EH, int S, int E, int w, int h,
                int nbh_l, int nb, int BW, int BH, int NC, int* omvx,
                int* omvy, int* oflags, int* oqbits, int* oltex,
                int* osvar) {
  __shared__ uint8_t s_src[kMaxBlk * kMaxBlk];
  __shared__ uint8_t s_zero[kMaxBlk * kMaxBlk];
  __shared__ uint8_t s_pad[(kMaxBlk + 2) * (kMaxBlk + 2)];
  __shared__ uint8_t s_nb[kNB * kNB];
  __shared__ uint8_t s_c14[kHP * kHP];
  __shared__ int red[24 * kWarps];
  const int t = blockIdx.x, bb = blockIdx.y;
  const uint8_t* sp = src + bb * pstride;
  const uint8_t* rp = ref + bb * pstride;
  const int* cand = cm + ((int64_t)bb * nb + t) * 2 * NC;
  const Block b = block_of(t, nbh_l, BW, BH, w, h);
  const int zr = clampi(E + b.by, 0, (EH - BH) & ~7);
  const int zc = clampi(E + b.bx, 0, S - BW);
  load_window(s_src, sp, S, zr, zc, BH, BW);
  load_window(s_zero, rp, S, zr, zc, BH, BW);
  __syncthreads();
  int dx, dy, best;
  search(rp, cand, NC, 0, b, EH, S, E, w, h, BW, BH, s_src, s_pad, red, dx,
         dy, best);

  // --- half-pel refine (hme.c:543-597)
  const int yarea = b.bw_c * b.bh_c;
  const int yareasq = yarea * yarea;
  const int cx = b.bx + (b.bw_c >> 1) - kHP / 2;
  const int cy = b.by + (b.bh_c >> 1) - kHP / 2;
  load_window(s_c14, sp, S, clampi(E + cy, 0, EH - kHP),
              clampi(E + cx, 0, S - kHP), kHP, kHP);
  load_window(s_nb, rp, S, clampi(E + cy + dy - 2, 0, EH - kNB),
              clampi(E + cx + dx - 2, 0, S - kNB), kNB, kNB);
  __syncthreads();
  int a8[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int p = threadIdx.x; p < kHP * kHP; p += kThreads) {
    const int i = p / kHP, j = p - i * kHP;
    const int s = s_c14[p];
#pragma unroll
    for (int k = 0; k < 8; ++k) a8[k] += absi(s - hpval(s_nb, k, i, j));
  }
  block_sum<8>(a8, red);
  const bool do_hp = best > BW * BH && b.inframe;
  int run_best = best * (kHP * kHP) / max(yarea, 1), run_m = -1;
  for (int k = 0; k < 8; ++k) {
    if (a8[k] < run_best) {
      run_best = a8[k];
      run_m = k;
    }
  }
  const bool hp_hit = do_hp && run_m >= 0;
  const int m = hp_hit ? run_m : -1;
  const int mvx = 2 * dx + (hp_hit ? XH[run_m] : 0);
  const int mvy = 2 * dy + (hp_hit ? YH[run_m] : 0);
  if (hp_hit) best = run_best * yarea / (kHP * kHP);

  // --- statistics: centre windows (texture), block, zero-MV, quadrants
  enum { RS, RSS, RSH, RSV, SS, SSS, SSH, SSV, LS, LSS, LSH, LSV, ZS, ZSS,
         G0, G1, G2, G3, E0, E1, E2, E3, NSUM };
  int a[NSUM];
#pragma unroll
  for (int k = 0; k < NSUM; ++k) a[k] = 0;
  for (int p = threadIdx.x; p < kHP * kHP; p += kThreads) {
    const int i = p / kHP, j = p - i * kHP;
    const int rv = selval(s_nb, m, i, j), sv = s_c14[p];
    a[RS] += rv;
    a[RSS] += rv * rv;
    a[SS] += sv;
    a[SSS] += sv * sv;
    if (j >= 1) {
      a[RSH] += absi(rv - selval(s_nb, m, i, j - 1));
      a[SSH] += absi(sv - s_c14[p - 1]);
    }
    if (i >= 1) {
      a[RSV] += absi(rv - selval(s_nb, m, i - 1, j));
      a[SSV] += absi(sv - s_c14[p - kHP]);
    }
  }
  const int sbw = b.bw_c / 2, sbh = b.bh_c / 2;
  for (int p = threadIdx.x; p < BH * BW; p += kThreads) {
    const int r = p / BW, c = p - r * BW;
    if (r >= b.bh_c || c >= b.bw_c) continue;
    const int s = s_src[p], z = s_zero[p];
    a[LS] += s;
    a[LSS] += s * s;
    a[ZS] += z;
    a[ZSS] += z * z;
    if (c >= 1) a[LSH] += absi(s - s_src[p - 1]);
    if (r >= 1) a[LSV] += absi(s - s_src[p - BW]);
    if (c < 2 * sbw && r < 2 * sbh) {  // inside a quadrant
      const int qx = c >= sbw, qy = r >= sbh, q = qy * 2 + qx;
      const int dif = absi(s - z);
      int good = dif == 0 ? 192 : dif == 1 ? 128 : dif == 2 ? 96 : 0;
      if (c - qx * sbw >= 1)
        good += absi(s - s_src[p - 1]) + absi(z - s_zero[p - 1]);
      if (r - qy * sbh >= 1)
        good += absi(s - s_src[p - BW]) + absi(z - s_zero[p - BW]);
      a[G0 + q] += good;
      a[E0 + q] += dif > 2 ? dif : 0;
    }
  }
  block_sum<NSUM>(a, red);

  const unsigned n14 = kHP * kHP;
  const int rtex = (a[RSH] + a[RSV]) / 2 / (int)n14;
  const int ravg = a[RS] / (int)n14;
  const int rvar = (int)((unsigned)a[RSS] - (unsigned)a[RS] * (unsigned)a[RS] / n14);
  const int stex = (a[SSH] + a[SSV]) / 2 / (int)n14;
  const int savg = a[SS] / (int)n14;
  const int svar = (int)((unsigned)a[SSS] - (unsigned)a[SS] * (unsigned)a[SS] / n14);
  const int area = max(yarea, 1);
  const int luma_tex = (a[LSH] + a[LSV]) / 2 / area;
  const unsigned luma_var =
      (unsigned)a[LSS] - (unsigned)a[LS] * (unsigned)a[LS] / (unsigned)area;
  const unsigned zvar =
      (unsigned)a[ZSS] - (unsigned)a[ZS] * (unsigned)a[ZS] / (unsigned)area;
  const bool lo_tex = luma_tex <= 2 && b.inframe;
  const bool lo_var = (unsigned)yareasq > luma_var && b.inframe;

  // block_intra_test (hme.c:143-178): does a DC-only block survive?
  const int ravg0 = a[ZS] / area;
  int bad[1] = {0};
  for (int p = threadIdx.x; p < BH * BW; p += kThreads) {
    const int r = p / BW, c = p - r * BW;
    if (r >= b.bh_c || c >= b.bw_c) continue;
    const int s = s_src[p];
    const int inner = clampi(s - ravg0 + 128, 0, 255);
    bad[0] += clampi(ravg0 + inner - 128, 0, 255) != s;
  }
  block_sum<1>(bad, red);

  const bool go_intra =
      (stex < 2 && zvar > luma_var * 2u) ||
      rvar > (int)((unsigned)svar * 2u) || (stex == 0 && rtex != 0) ||
      absi(savg - ravg) > 8 || (luma_tex <= 10 && best > yareasq / 16);
  const int ethr = (sbw + sbh) >> 1;
  int qb = 0;
  for (int q = 0; q < 4; ++q)
    if (stex > 1 && a[G0 + q] >= ethr * a[E0 + q]) qb |= 1 << q;

  if (threadIdx.x == 0) {
    const int64_t o = (int64_t)bb * nb + t;
    omvx[o] = mvx;
    omvy[o] = mvy;
    oflags[o] = (go_intra ? 1 : 0) | (bad[0] > 0 ? 2 : 0) | (lo_tex ? 4 : 0) |
                (lo_var ? 8 : 0) | (hp_hit ? 16 : 0);
    oqbits[o] = qb;
    oltex[o] = luma_tex;
    osvar[o] = svar;
  }
}

}  // namespace

extern "C" int dsv1_hme_refine(const uint8_t* src, const uint8_t* ref,
                               const int* cm, int64_t pstride, int EH, int S,
                               int E, int w, int h, int nbh_l, int nb, int BW,
                               int BH, int NC, int level, int B, int* dx,
                               int* dy, int* best, cudaStream_t stream) {
  if (BW > kMaxBlk || BH > kMaxBlk || NC > kMaxNC) return (int)cudaErrorInvalidValue;
  dim3 grid(nb, B);
  hme_refine_kernel<<<grid, kThreads, 0, stream>>>(
      src, ref, cm, pstride, EH, S, E, w, h, nbh_l, nb, BW, BH, NC, level, dx,
      dy, best);
  return (int)cudaGetLastError();
}

extern "C" int dsv1_hme_base(const uint8_t* src, const uint8_t* ref,
                             const int* cm, int64_t pstride, int EH, int S,
                             int E, int w, int h, int nbh_l, int nb, int BW,
                             int BH, int NC, int B, int* mvx, int* mvy,
                             int* flags, int* qbits, int* ltex, int* svar,
                             cudaStream_t stream) {
  if (BW > kMaxBlk || BH > kMaxBlk || NC > kMaxNC) return (int)cudaErrorInvalidValue;
  dim3 grid(nb, B);
  hme_base_kernel<<<grid, kThreads, 0, stream>>>(
      src, ref, cm, pstride, EH, S, E, w, h, nbh_l, nb, BW, BH, NC, mvx, mvy,
      flags, qbits, ltex, svar);
  return (int)cudaGetLastError();
}
