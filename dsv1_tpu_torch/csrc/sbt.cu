// The whole forward Haar pyramid of a batch of planes in one C call: a tile
// stage and a coarse stage.
//
// Replaces the Pallas TPU kernel `kern` (tools/bench_haar.py:169, the fused
// Haar level that sbt.fwd_sbt computes at every Haar level): row-pair sums
// and differences, then LL = (su + sv), scaled to trunc(LL * 4 / 5) above
// level 1, LH = su - sv, HL = du + dv, HH = du - dv (reference
// sbt.c:267-349).
//
// Levels first..lvls run on the carried LL region: level `first` reads the
// (hs, ws) int32 input, level i + 1 the ceil-halved LL of level i. Odd
// dimensions replicate the last column or row (min(2q + 1, n - 1)), as the
// reference's oddw/oddh branches do. Each level's LH, HL and HH go straight
// into their rectangles of the assembled coefficient array `out` (LH at
// [0, ch) x [cw, cw + fw), HL at [ch, ch + fh) x [0, cw), HH at
// [ch, ch + fh) x [cw, cw + fw) of that level's region), and the last
// level's LL into its top-left corner. The input must not overlap `out`.
//
// Why tiles are independent: the region of level first + k is
// ceil(hs / 2^k) x ceil(ws / 2^k), so a 64 x 64 tile of the level-`first`
// region, aligned to 64, holds exactly the (64 >> k)-aligned tile of level
// first + k; a quad's second row and column (2q + 1, or the replicated edge
// 2q) lie in the same tile while the tile is at least 2 wide. So one thread
// block runs up to 6 levels of its tile in shared memory (64 -> 1) and
// writes to device memory only the bands and its last LL.
//
// Tile stage: one block per 64 x 64 tile. It loads the tile (16-byte loads
// where the row stride and the pointer allow) into shared memory, then per
// level computes each 2x2 quad from shared memory, writes the three bands
// to `out` (adjacent threads on adjacent quads: coalesced rows) and the LL
// to the other shared buffer. Its last LL goes to the corner of `out` when
// no level is left, else to the (gh, gw) grid `mid`, one value per tile.
// Coarse stage: one block loads `mid` into shared memory and runs the
// remaining levels there (at most 68 x 120 values at 8K: 32 KB).
//
// Batch: the tile stage's grid z and the coarse stage's blocks are the
// planes of the batch (plane z at src + z * sbatch, out + z * obatch, its
// coarse grid at mid + z * gh * gw); a coarse block's shared memory holds
// its own plane's grid only. The GOP encoder runs the pyramids of one
// frame index of every GOP of a chunk this way; a batch of one is the
// single-plane call.
//
// Bound by memory: each input int32 is read once and each band value and
// the final LL written once (8 bytes per pixel of the region), about 3
// integer ops per pixel; the coarse levels are a few KB.

#include "common.cuh"

using namespace dsv1;

namespace {

constexpr int kTile = 64;        // tile side at level `first`
constexpr int kTileLevels = 6;   // levels a tile runs: 64 -> 1

// One Haar level of the region part held in `src` (rows x cols valid,
// row stride ss) whose top-left is (oy, ox) in the level's (hk, wk)
// region: bands into `out`, the LL into `dst` (row stride ds). `level` is
// the absolute level (LL scaled above 1). Quads are spread over the block.
__device__ __forceinline__ void haar_level(const int* src, int ss, int rows,
                                           int cols, int oy, int ox, int hk,
                                           int wk, int level, int* dst,
                                           int ds, int* __restrict__ out,
                                           int64_t ostride) {
  const int ch = (hk + 1) / 2, cw = (wk + 1) / 2, fh = hk / 2, fw = wk / 2;
  const int qr = (rows + 1) / 2, qc = (cols + 1) / 2;
  for (int p = threadIdx.x; p < qr * qc; p += kThreads) {
    const int ly = p / qc, lx = p - ly * qc;
    const int r0 = 2 * ly, c0 = 2 * lx;
    const int r1 = min(r0 + 1, rows - 1), c1 = min(c0 + 1, cols - 1);
    const int x0 = src[r0 * ss + c0], x1 = src[r0 * ss + c1];
    const int x2 = src[r1 * ss + c0], x3 = src[r1 * ss + c1];
    const int su = x0 + x2, sv = x1 + x3, du = x0 - x2, dv = x1 - x3;
    const int s = su + sv;
    dst[ly * ds + lx] = level > 1 ? (s * 4) / 5 : s;  // C division truncates
    const int qy = (oy >> 1) + ly, qx = (ox >> 1) + lx;
    if (qx < fw) out[(int64_t)qy * ostride + cw + qx] = su - sv;  // LH
    if (qy < fh) {
      int* o = out + (int64_t)(ch + qy) * ostride;
      o[qx] = du + dv;                                   // HL
      if (qx < fw) o[cw + qx] = du - dv;                 // HH
    }
  }
}

}  // namespace

__global__ void __launch_bounds__(kThreads)
haar_tile_kernel(const int* __restrict__ src, int64_t sstride,
                 int64_t sbatch, int hs, int ws, int first, int nlev,
                 int* __restrict__ out, int64_t ostride, int64_t obatch,
                 int* __restrict__ mid, int gh, int gw) {
  __shared__ __align__(16) int buf_a[kTile * kTile];
  __shared__ __align__(16) int buf_b[(kTile / 2) * (kTile / 2)];
  const int ty = blockIdx.y, tx = blockIdx.x;
  const int64_t pz = blockIdx.z;  // the plane of the batch
  src += pz * sbatch;
  out += pz * obatch;
  if (mid) mid += pz * gh * gw;
  const int r0 = ty * kTile, c0 = tx * kTile;
  const int rows = min(kTile, hs - r0), cols = min(kTile, ws - c0);

  // load the tile: 16 int4 chunks per row where aligned, else scalars
  const int* tsrc = src + (int64_t)r0 * sstride + c0;
  const bool vec = ((sstride & 3) == 0) &&
                   ((reinterpret_cast<uintptr_t>(src) & 15) == 0);
  for (int p = threadIdx.x; p < kTile * (kTile / 4); p += kThreads) {
    const int r = p >> 4, c = (p & 15) * 4;
    if (r >= rows || c >= cols) continue;
    const int* g = tsrc + (int64_t)r * sstride + c;
    int* d = buf_a + r * kTile + c;
    if (vec && c + 4 <= cols) {
      *reinterpret_cast<int4*>(d) = __ldg(reinterpret_cast<const int4*>(g));
    } else {
      for (int k = 0; k < 4 && c + k < cols; ++k) d[k] = g[k];
    }
  }
  __syncthreads();

  int* cur = buf_a;
  int* nxt = buf_b;
  int side = kTile, hk = hs, wk = ws, oy = r0, ox = c0;
  int vr = rows, vc = cols;
  for (int k = 0; k < nlev; ++k) {
    haar_level(cur, side, vr, vc, oy, ox, hk, wk, first + k, nxt, side / 2,
               out, ostride);
    __syncthreads();
    int* t = cur;
    cur = nxt;
    nxt = t;
    side >>= 1;
    hk = (hk + 1) / 2;
    wk = (wk + 1) / 2;
    oy >>= 1;
    ox >>= 1;
    vr = (vr + 1) / 2;
    vc = (vc + 1) / 2;
  }
  // the tile's last LL: the corner of `out` when the pyramid is done,
  // else its cell of the coarse grid
  if (mid) {
    if (threadIdx.x == 0) mid[(int64_t)ty * gw + tx] = cur[0];
    return;
  }
  for (int p = threadIdx.x; p < vr * vc; p += kThreads) {
    const int r = p / vc, c = p - r * vc;
    out[(int64_t)(oy + r) * ostride + ox + c] = cur[r * side + c];
  }
}

__global__ void __launch_bounds__(kThreads)
haar_coarse_kernel(const int* __restrict__ mid, int gh, int gw, int first,
                   int lvls, int* __restrict__ out, int64_t ostride,
                   int64_t obatch) {
  extern __shared__ int smem[];
  mid += (int64_t)blockIdx.x * gh * gw;  // one block per plane
  out += blockIdx.x * obatch;
  // ping-pong: a holds the grid and every second level's LL, b the others
  int* a = smem;
  int* b = smem + gh * gw;
  for (int p = threadIdx.x; p < gh * gw; p += kThreads) a[p] = mid[p];
  __syncthreads();
  int* cur = a;
  int* nxt = b;
  int hk = gh, wk = gw;
  for (int i = first; i <= lvls; ++i) {
    haar_level(cur, wk, hk, wk, 0, 0, hk, wk, i, nxt, (wk + 1) / 2, out,
               ostride);
    __syncthreads();
    int* t = cur;
    cur = nxt;
    nxt = t;
    hk = (hk + 1) / 2;
    wk = (wk + 1) / 2;
  }
  for (int p = threadIdx.x; p < hk * wk; p += kThreads) {
    const int r = p / wk, c = p - r * wk;
    out[(int64_t)r * ostride + c] = cur[p];
  }
}

// Levels first..lvls of the (hs, ws) region of each of nbatch planes at
// src (plane z at src + z * sbatch) into out (+ z * obatch). mid: scratch
// of nbatch * ceil(hs / 64) * ceil(ws / 64) ints, used when more than 6
// levels run. Launches the tile stage and, past 6 levels, the coarse
// stage: returns cudaGetLastError() after them.
extern "C" int dsv1_haar_pyramid(const int* src, int64_t sstride,
                                 int64_t sbatch, int hs, int ws, int first,
                                 int lvls, int* out, int64_t ostride,
                                 int64_t obatch, int nbatch, int* mid,
                                 cudaStream_t stream) {
  const int nall = lvls - first + 1;
  if (hs < 1 || ws < 1 || first < 1 || nall < 1 || nbatch < 1 ||
      nbatch > 65535)
    return (int)cudaErrorInvalidValue;
  const int nt = nall < kTileLevels ? nall : kTileLevels;
  const int gh = (hs + kTile - 1) / kTile, gw = (ws + kTile - 1) / kTile;
  const bool coarse = nall > kTileLevels;
  haar_tile_kernel<<<dim3(gw, gh, nbatch), kThreads, 0, stream>>>(
      src, sstride, sbatch, hs, ws, first, nt, out, ostride, obatch,
      coarse ? mid : nullptr, gh, gw);
  if (coarse) {
    const int nb = (gh + 1) / 2 * ((gw + 1) / 2);
    const size_t smem = (size_t)(gh * gw + nb) * sizeof(int);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          haar_coarse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    haar_coarse_kernel<<<nbatch, kThreads, smem, stream>>>(
        mid, gh, gw, first + kTileLevels, lvls, out, ostride, obatch);
  }
  return (int)cudaGetLastError();
}
