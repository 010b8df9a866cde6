// Motion-compensated prediction of a batch of frames (all three planes of
// each) in one launch, one thread block per motion block of each plane of
// each frame, the half-pel filter of the block's phase inside the kernel.
//
// Replaces the Pallas TPU kernel `_mc_kernel` (dsv1_tpu/ops/pallas_mc.py:38,
// wrapper compensate_plane_pallas) together with the whole-image half-pel
// variant build that feeds it (dsv1_tpu/ops/bmc.py hpel_variants_luma and
// hpel_variants_chroma). Per block (reference compensate, bmc.c:204-302):
// from the raw mode / mvx / mvy / submask fields, the shifted MV, the
// window origin clamped to -FRAME_BORDER..lim, moved by the border and
// clamped into [0, EH - BH] x [0, S - BW] of the extended plane, the
// half-pel phase and the inter flag; then the BH x BW inter window of that
// phase, or an intra fill from the zero-MV window (the full-block DC for
// submask 15, else a quadrant DC per set bit, 0 outside the sub-area and
// the zero-MV pixel elsewhere). Luma phases: 4-tap 9 * (p0 + p1) -
// (p-1 + p2), (x + 8) >> 4 horizontally and vertically, the diagonal a
// vertical 4-tap over the unclamped horizontal values with (x + 128) >> 8
// (D.1.1, bmc.c:112-174; the same taps as csrc/hme.cu hpval). Chroma
// phases: bilinear (D.1.2).
//
// Exactness traps, which the JAX package's whole-image filters define:
// 1. The taps are flat indices into the whole image of all planes (the C
//    layout, ops/frame.py): a tap past a row's end reads the next row's
//    byte, and a tap past a plane's edge the neighbouring plane's byte.
//    So the kernel stages a flat neighbourhood at the plane stride: for
//    luma rows -1..BH+1 and, per row, the flat span -1..BW+1 around the
//    window; for chroma rows 0..BH and the span 0..BW.
// 2. A tap a(j) with j outside [0, n) is 0 (the filters pad the flat
//    image with zeros): the staging loads 0 there.
// 3. The diagonal runs on unclamped horizontal values hu(j), and hu(j) is
//    itself 0 for j outside [0, n) (the second zero pad), not a 4-tap of
//    zero-filled bytes: hu checks its own index.
// 4. Those edges are reachable: a window clamped to the top border of
//    plane 0 reaches j < 0 when the layout's guard margin is small (and
//    its diagonal reaches hu(-2), hu(-1) when the luma stride has no zero
//    tail). At the bottom of the last plane the window clamps one row
//    short of the end, so its chroma neighbourhood stays below n.
//
// Bound by the window bytes: each block reads its neighbourhood (about
// 1.1 bytes per predicted pixel) or its zero-MV window and writes its
// pixels once; the luma diagonal is about 30 integer operations per pixel,
// so a frame of mostly diagonal blocks is bound by operations. Per block
// the neighbourhood is staged once in shared memory (at most 67 x 67
// bytes) and every thread filters its pixels from there, so no variant
// plane is ever written to device memory and the whole frame is one
// launch with no host work per plane.
//
// Batch: grid z is the frame of the batch. Frame z reads its reference
// image at img + z * img_stride (each image n bytes: the zero rule of
// trap 2 holds per image), its four fields at + z * fstride and writes
// its prediction at out + z * out_stride. The GOP encoder predicts the P
// frames of one frame index of every GOP of a chunk in one launch; a
// batch of one is the single-frame call.

#include "common.cuh"

using namespace dsv1;

namespace {

constexpr int kMaxBlk = 64;             // MAX_BLOCK_SIZE
constexpr int kNbMax = (kMaxBlk + 3) * (kMaxBlk + 3);

// One plane of the frame: where its extended (EH, S) region starts in
// the flat image, where its (h, w) prediction starts in the output, its
// block size and chroma shifts.
struct McPlane {
  int64_t start, out_off;
  int EH, S, E, w, h, BW, BH, sh, sv;
};

struct McFrame {
  McPlane p[3];
  int border;      // FRAME_BORDER
  int mode_inter;  // MODE_INTER
};

__device__ __forceinline__ int clamp_lo_hi(int v, int lo, int hi) {
  return min(max(v, lo), hi);  // jnp.clip / torch.clamp order: hi wins
}

__device__ __forceinline__ int u8(int v) { return clampi(v, 0, 255); }

}  // namespace

__global__ void __launch_bounds__(kThreads)
mc_frame_kernel(const uint8_t* __restrict__ img, int64_t n,
                int64_t img_stride, McFrame f, int nbh,
                const int* __restrict__ modes, const int* __restrict__ mvx,
                const int* __restrict__ mvy, const int* __restrict__ sub,
                int64_t fstride, uint8_t* __restrict__ out,
                int64_t out_stride) {
  __shared__ uint8_t nb[kNbMax];
  __shared__ int red[5 * kWarps];
  const int t = blockIdx.x, c = blockIdx.y;
  const int64_t fz = blockIdx.z;  // the frame of the batch
  img += fz * img_stride;
  modes += fz * fstride;
  mvx += fz * fstride;
  mvy += fz * fstride;
  sub += fz * fstride;
  out += fz * out_stride;
  const McPlane P = f.p[c];
  const int gj = t / nbh, gi = t - gj * nbh;
  const int BW = P.BW, BH = P.BH, S = P.S;
  const int bx = gi * BW, by = gj * BH;
  const int bw_c = clampi(P.w - bx, 0, BW), bh_c = clampi(P.h - by, 0, BH);
  if (bw_c == 0 || bh_c == 0) return;  // the whole block: nothing to write
  uint8_t* o = out + P.out_off + (int64_t)by * P.w + bx;
  const int npx = bw_c * bh_c;

  if (modes[t] == f.mode_inter) {
    const int dx2 = mvx[t] >> P.sh, dy2 = mvy[t] >> P.sv;
    const int px = clamp_lo_hi(bx + (dx2 >> 1), -f.border,
                               P.w - BW + f.border - 1);
    const int py = clamp_lo_hi(by + (dy2 >> 1), -f.border,
                               P.h - BH + f.border - 1);
    const int phase = ((dx2 & 1) << 1) | (dy2 & 1);
    const int rr = clampi(py + P.E, 0, P.EH - BH);
    const int cc = clampi(px + P.E, 0, S - BW);
    const int64_t j0 = P.start + (int64_t)rr * S + cc;
    // stage the neighbourhood (traps 1, 2, 4): luma rows -1..BH+1 x flat
    // span -1..BW+1, chroma rows 0..BH x span 0..BW
    const bool luma = c == 0;
    const int lo = luma ? 1 : 0, ext = luma ? 3 : 1;
    const int NW = BW + ext, NH = BH + ext;
    for (int p = threadIdx.x; p < NH * NW; p += kThreads) {
      const int r = p / NW, q = p - r * NW;
      const int64_t j = j0 + (int64_t)(r - lo) * S + (q - lo);
      nb[p] = (j >= 0 && j < n) ? img[j] : 0;
    }
    __syncthreads();
    for (int p = threadIdx.x; p < npx; p += kThreads) {
      const int r = p / bw_c, q = p - r * bw_c;
      const uint8_t* a = nb + (r + lo) * NW + (q + lo);  // a[0] is a(j)
      int val;
      if (phase == 0) {
        val = a[0];
      } else if (!luma) {
        if (phase == 1)
          val = (a[0] + a[NW] + 1) >> 1;
        else if (phase == 2)
          val = (a[0] + a[1] + 1) >> 1;
        else
          val = (a[0] + a[1] + a[NW] + a[NW + 1] + 2) >> 2;
      } else if (phase == 1) {
        val = u8((9 * (a[0] + a[NW]) - (a[-NW] + a[2 * NW]) + 8) >> 4);
      } else if (phase == 2) {
        val = u8((9 * (a[0] + a[1]) - (a[-1] + a[2]) + 8) >> 4);
      } else {
        // hu at rows r-1..r+2 of this column, 0 where its own index j
        // lies outside the image (trap 3)
        int hu[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint8_t* b = a + (k - 1) * NW;
          const int64_t j = j0 + (int64_t)(r + k - 1) * S + q;
          hu[k] = (j >= 0 && j < n) ? 9 * (b[0] + b[1]) - (b[-1] + b[2]) : 0;
        }
        val = u8((9 * (hu[1] + hu[2]) - (hu[0] + hu[3]) + 128) >> 8);
      }
      o[(int64_t)r * P.w + q] = (uint8_t)val;
    }
    return;
  }

  // intra: sums over the zero-MV window, exactly as the Pallas kernel
  // reads it (the clamp never binds for a block inside the plane)
  const int zr = clampi(P.E + by, 0, (P.EH - BH) & ~7);
  const int zc = clampi(P.E + bx, 0, S - BW);
  const uint8_t* z = img + P.start + (int64_t)zr * S + zc;
  const int sb = sub[t];
  const int sbw = bw_c / 2, sbh = bh_c / 2;
  int acc[5] = {0, 0, 0, 0, 0};
  for (int p = threadIdx.x; p < npx; p += kThreads) {
    const int r = p / bw_c, q = p - r * bw_c;
    const int v = z[(int64_t)r * S + q];
    acc[0] += v;
    const int qx = q >= sbw, qy = r >= sbh;
    if (q - qx * sbw < sbw && r - qy * sbh < sbh) acc[1 + qy * 2 + qx] += v;
  }
  block_sum<5>(acc, red);
  const int area = max(npx, 1), sarea = max(sbw * sbh, 1);
  for (int p = threadIdx.x; p < npx; p += kThreads) {
    const int r = p / bw_c, q = p - r * bw_c;
    int val;
    if (sb == 15) {
      val = acc[0] / area;
    } else {
      const int qx = q >= sbw, qy = r >= sbh;
      const int lx = q - qx * sbw, ly = r - qy * sbh;
      if (!(lx < sbw && ly < sbh && sbw > 0 && sbh > 0))
        val = 0;
      else if ((sb >> (qy * 2 + qx)) & 1)
        val = acc[1 + qy * 2 + qx] / sarea;
      else
        val = z[(int64_t)r * S + q];
    }
    o[(int64_t)r * P.w + q] = (uint8_t)val;
  }
}

// geo: host array of 3 x 11 int64 per plane (start, out_off, EH, S, E, w,
// h, BW, BH, sh, sv), then FRAME_BORDER and MODE_INTER. Fields: nbh * nbv
// int32 each per frame. out: per frame the three (h, w) planes back to
// back. nbatch frames, frame z's image, fields and output at z times
// img_stride, fstride and out_stride elements.
extern "C" int dsv1_mc_frame(const uint8_t* img, int64_t n,
                             int64_t img_stride, const int64_t* geo, int nbh,
                             int nbv, const int* modes, const int* mvx,
                             const int* mvy, const int* sub, int64_t fstride,
                             uint8_t* out, int64_t out_stride, int nbatch,
                             cudaStream_t stream) {
  if (nbatch < 1 || nbatch > 65535) return (int)cudaErrorInvalidValue;
  McFrame f;
  for (int c = 0; c < 3; ++c) {
    const int64_t* g = geo + 11 * c;
    McPlane& P = f.p[c];
    P.start = g[0];
    P.out_off = g[1];
    P.EH = (int)g[2];
    P.S = (int)g[3];
    P.E = (int)g[4];
    P.w = (int)g[5];
    P.h = (int)g[6];
    P.BW = (int)g[7];
    P.BH = (int)g[8];
    P.sh = (int)g[9];
    P.sv = (int)g[10];
    if (P.BW < 1 || P.BH < 1 || P.BW > kMaxBlk || P.BH > kMaxBlk)
      return (int)cudaErrorInvalidValue;
  }
  f.border = (int)geo[33];
  f.mode_inter = (int)geo[34];
  mc_frame_kernel<<<dim3(nbh * nbv, 3, nbatch), kThreads, 0, stream>>>(
      img, n, img_stride, f, nbh, modes, mvx, mvy, sub, fstride, out,
      out_stride);
  return (int)cudaGetLastError();
}
