// Motion-compensated prediction build, one thread block per motion block.
//
// Replaces the Pallas TPU kernel `_mc_kernel` (dsv1_tpu/ops/pallas_mc.py:38,
// wrapper compensate_plane_pallas): for each block, the BH x BW inter
// window of one of four precomputed half-pel variant planes at a clamped
// origin, or an intra fill from the zero-MV window — the full-block DC
// (submask 15), else a quadrant DC per set submask bit, 0 outside the
// sub-area and the zero-MV pixel elsewhere — selected by mode
// (reference compensate, bmc.c:204-302).
//
// Bound by window loads (a few KB per block) and five small integer sums,
// not by arithmetic. The block's zero-MV window is read once for the
// sums and again per output pixel from L2; the variants stay in device
// memory in the flat image layout, so no re-layout pass is needed, and
// each thread writes its pixels straight into the (h, w) plane.

#include "common.cuh"

using namespace dsv1;

__global__ void __launch_bounds__(kThreads)
mc_kernel(const uint8_t* __restrict__ vflat, int64_t n, int64_t start,
          int EH, int S, int E, int w, int h, int BW, int BH, int nbh,
          const int* __restrict__ inter, const int* __restrict__ sub,
          const int* __restrict__ ir, const int* __restrict__ ic,
          const int* __restrict__ phase, uint8_t* __restrict__ out) {
  __shared__ int red[5 * kWarps];
  const int gi = blockIdx.x, gj = blockIdx.y;
  const int t = gj * nbh + gi;
  const int bx = gi * BW, by = gj * BH;
  const int bw_c = clampi(w - bx, 0, BW), bh_c = clampi(h - by, 0, BH);
  const int mode = inter[t], sb = sub[t];
  const uint8_t* v0 = vflat + start;  // phase 0: the unfiltered plane
  const int zr = clampi(E + by, 0, (EH - BH) & ~7);
  const int zc = clampi(E + bx, 0, S - BW);
  const int sbw = bw_c / 2, sbh = bh_c / 2;

  // zero-MV window sums: full clipped block + the four quadrants
  int acc[5] = {0, 0, 0, 0, 0};
  if (mode != 1) {
    for (int p = threadIdx.x; p < BH * BW; p += kThreads) {
      const int r = p / BW, c = p - r * BW;
      if (r >= bh_c || c >= bw_c) continue;
      const int z = v0[(int64_t)(zr + r) * S + zc + c];
      acc[0] += z;
      const int qx = c >= sbw, qy = r >= sbh;
      if (c - qx * sbw < sbw && r - qy * sbh < sbh) acc[1 + qy * 2 + qx] += z;
    }
  }
  block_sum<5>(acc, red);

  const int area = max(bw_c * bh_c, 1), sarea = max(sbw * sbh, 1);
  const int rr = clampi(ir[t], 0, EH - BH), cc = clampi(ic[t], 0, S - BW);
  const uint8_t* vp = vflat + (int64_t)phase[t] * n + start;
  for (int p = threadIdx.x; p < BH * BW; p += kThreads) {
    const int r = p / BW, c = p - r * BW;
    if (r >= bh_c || c >= bw_c) continue;
    int val;
    if (mode == 1) {
      val = vp[(int64_t)(rr + r) * S + cc + c];
    } else if (sb == 15) {
      val = acc[0] / area;
    } else {
      const int qx = c >= sbw, qy = r >= sbh;
      const int lx = c - qx * sbw, ly = r - qy * sbh;
      const bool in_sub = lx < sbw && ly < sbh && sbw > 0 && sbh > 0 &&
                          c < 2 * sbw && r < 2 * sbh;
      if (!in_sub)
        val = 0;
      else if ((sb >> (qy * 2 + qx)) & 1)
        val = acc[1 + qy * 2 + qx] / sarea;
      else
        val = v0[(int64_t)(zr + r) * S + zc + c];
    }
    out[(int64_t)(by + r) * w + bx + c] = (uint8_t)val;
  }
}

extern "C" int dsv1_mc_predict(const uint8_t* vflat, int64_t n,
                               int64_t start, int EH, int S, int E, int w,
                               int h, int BW, int BH, int nbh, int nbv,
                               const int* inter, const int* sub,
                               const int* ir, const int* ic,
                               const int* phase, uint8_t* out,
                               cudaStream_t stream) {
  dim3 grid(nbh, nbv);
  mc_kernel<<<grid, kThreads, 0, stream>>>(vflat, n, start, EH, S, E, w, h,
                                           BW, BH, nbh, inter, sub, ir, ic,
                                           phase, out);
  return (int)cudaGetLastError();
}
