// One forward Haar level of the subband transform, one thread per 2x2 quad.
//
// Replaces the Pallas TPU kernel `kern` (tools/bench_haar.py:169, the fused
// Haar level that sbt.fwd_sbt computes at every Haar level): row-pair sums
// and differences, then LL = (su + sv), scaled to trunc(LL * 4 / 5) above
// level 1, LH = su - sv, HL = du + dv, HH = du - dv (reference
// sbt.c:267-349).
//
// The input is the carried int32 LL region of the previous level (hs x ws,
// any row stride); odd dimensions replicate the last column or row, as the
// reference's oddw/oddh branches do. LH, HL and HH go straight into their
// final rectangles of the assembled (H, W) coefficient array, so no
// assembly pass follows; LL goes to a separate (ch, cw) buffer that the
// next level reads. The caller never lets the input overlap what this
// level writes.
//
// Bound by memory: each input int32 is read once and each output written
// once (8 bytes per pixel of the region), a few integer ops per pixel.
// Adjacent threads take adjacent quads, so a warp's reads of a row pair
// and its writes of each band row are contiguous.

#include "common.cuh"

using namespace dsv1;

__global__ void __launch_bounds__(kThreads)
haar_fwd_kernel(const int* __restrict__ src, int64_t sstride, int hs, int ws,
                int* __restrict__ ll, int* __restrict__ out, int64_t ostride,
                int scale_ll) {
  const int ch = (hs + 1) / 2, cw = (ws + 1) / 2, fh = hs / 2, fw = ws / 2;
  const int64_t n = (int64_t)ch * cw;
  for (int64_t k = (int64_t)blockIdx.x * kThreads + threadIdx.x; k < n;
       k += (int64_t)gridDim.x * kThreads) {
    const int qy = (int)(k / cw), qx = (int)(k - (int64_t)qy * cw);
    const int c0 = 2 * qx, c1 = min(2 * qx + 1, ws - 1);
    const int* r0 = src + (int64_t)(2 * qy) * sstride;
    const int* r1 = src + (int64_t)min(2 * qy + 1, hs - 1) * sstride;
    const int x0 = r0[c0], x1 = r0[c1], x2 = r1[c0], x3 = r1[c1];
    const int su = x0 + x2, sv = x1 + x3, du = x0 - x2, dv = x1 - x3;
    const int s = su + sv;
    ll[k] = scale_ll ? (s * 4) / 5 : s;  // C division truncates
    if (qx < fw) out[(int64_t)qy * ostride + cw + qx] = su - sv;  // LH
    if (qy < fh) {
      int* o = out + (int64_t)(ch + qy) * ostride;
      o[qx] = du + dv;                                   // HL
      if (qx < fw) o[cw + qx] = du - dv;                 // HH
    }
  }
}

extern "C" int dsv1_haar_fwd(const int* src, int64_t sstride, int hs, int ws,
                             int* ll, int* out, int64_t ostride, int scale_ll,
                             cudaStream_t stream) {
  if (hs < 1 || ws < 1) return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)((hs + 1) / 2) * ((ws + 1) / 2);
  const int64_t blocks = (n + kThreads - 1) / kThreads;  // grid-stride loop
  haar_fwd_kernel<<<(int)(blocks < (1 << 20) ? blocks : (1 << 20)), kThreads,
                    0, stream>>>(src, sstride, hs, ws, ll, out, ostride,
                                 scale_ll);
  return (int)cudaGetLastError();
}
