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
// residual_in and b4t_fwd are bound by memory: residual_in reads 1 or 2
// bytes and writes 4 a position, b4t_fwd reads 4 and writes 4 plus 1 for
// the LL copy. Each thread reads its taps (up to 16 values for a B4T
// output) from the L1 cache, which its neighbours share; a thread takes
// one output and neighbouring threads neighbouring columns, so writes
// coalesce.
//
// inv_sbt is bound by memory too: it reads each band value once and
// writes one u8 a pixel (the border too), 3.8 us for a 1080p luma plane's
// recon at 3.35 TB/s. Each level needs the whole LL region of the level
// above, so levels are dependent, and the small top levels are latency,
// not bytes: a few short launches, each level's values read once into
// shared memory, each nudge computed once (the wrapper's `inv_plan`
// chooses the split):
// - the coarse stage: one 1024-thread block per plane copies the corner
//   of the coefficient array that levels top..lo read (lo >= 3; a corner
//   of at most 48 KB: 32 KB at 1080p, levels 11..5) into shared memory
//   with asynchronous 16-byte copies, then runs those levels there, each
//   level's output into one of two shared buffers, a block barrier a
//   level (levels of at most 64 quads on one warp). Level lo writes to
//   device memory. A level is a chain of dependent steps on one SM
//   (about 1,000 to 1,500 cycles a level of at most one quad a thread,
//   clock64() stamps of tools/torch_recon_probe.py), so each quad's step
//   is kept short: the bands read unconditionally inside the staged
//   corner (`coarse_quad_out`), the quad row by a multiply-high, each
//   level's geometry computed while the corner loads. One level deeper,
//   the corner and buffers (260,160 bytes for levels 11..4 of a 1080p
//   luma plane or 12..5 of a 4K one) would not fit the block's 232,448.
// - then levels lo - 1..3, two a launch where they pair, a tile of 32x16
//   quads a block (none at CIF, a pair for 1080p luma, a level for 1080p
//   chroma, a pair and a level for 4K luma).
// - the last launch runs levels 2 and 1 together.
// A two-level launch stages the LL entering its upper level over its
// tile with a two-value halo, computes that level's output over the tile
// and a one-value halo into shared memory (the halo's quads are
// recomputed by the neighbouring tiles), then the lower level: Haar, or
// at level 1 of an I plane the B4T's column pass into shared memory, then
// its row pass, and the epilogue: a tile off the plane's edges stores
// each thread's pixel pairs straight from registers; an edge tile stages
// its pixels in shared memory and writes them with the replicated border
// (each image pixel by one block), 32-bit words where the image allows.
// A thread computes two 2x2 quads 8 rows apart (one or four a thread:
// 25.0 and 24.2 us against 22.2 for a 1080p luma recon, 58.6 and 52.2
// against 49.5 at 4K; tools/torch_recon_probe.py lr1, lr4):
// it loads LL, LH, HL and HH once (the LL neighbourhood from shared
// memory, the bands straight from device memory, coalesced, since each
// band value is read by one thread once) and computes each nudge once.
// Every launch is chained to the one before by programmatic dependent
// launch: it may start while the previous kernel runs, loads its bands
// and the prediction, and waits (griddepcontrol.wait) only before it
// reads the previous level's output. 1080p: 3 launches a plane; 4K 4 a
// luma plane, 3 a chroma plane; CIF 2 a plane.

#include "common.cuh"

using namespace dsv1;

namespace {

constexpr int kMinQuant = 16;  // MINQUANT
constexpr int kMaxLvl = 3;     // MAXLVL
constexpr int kQpI = 3, kQpP = 1;
constexpr int kCoarseThreads = 1024;
constexpr int kCoarseSmem = 232448;  // a block's shared memory on sm_90
constexpr int kMaxLevels = 31;  // levels of a plane below 2^31 wide
// a tile: kTQX x kLQY quads, a thread kLR quads kTQY rows apart
constexpr int kTQX = 32, kTQY = 8, kLR = 2, kLQY = kTQY * kLR;
static_assert(kTQX * kTQY == kThreads, "a thread a quad column");
// the LL entering a tile's lower level with its one-value halo; the quads
// of its upper level behind it, and their LL with its halo
constexpr int kHW = kTQX + 2, kH1H = kLQY + 2;
constexpr int kQ2W = kTQX / 2 + 2, kQ2H = kLQY / 2 + 2;
constexpr int kL2W = kQ2W + 2, kL2H = kQ2H + 2;
constexpr int kQ2N = (kQ2W * kQ2H + kThreads - 1) / kThreads;  // a thread

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

// the count of j in 0..30 with n > 2^j
__device__ __forceinline__ int lb2(int n) {
  return n > 1 ? 32 - __clz(n - 1) : 0;
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

__host__ __device__ __forceinline__ int round_shift(int x, int s) {
  return (x + (1 << s) - 1) >> s;
}

// A level's geometry (_quad_dims, sbt.c:630-651)
struct Quad {
  int ws, hs, cw, ch, fw, fh;
};

__host__ __device__ __forceinline__ Quad quad_dims(int W, int H, int lvl) {
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

__device__ __forceinline__ int sc(int v) { return v * 5 / 4; }

// The bands of quad (qy, qx) of a Haar level; B(r, c) reads the
// coefficient array (0 past odd dims)
template <class BF>
__device__ __forceinline__ void quad_bands(BF B, const Quad& d, int qy,
                                           int qx, int& LH, int& HL,
                                           int& HH) {
  LH = qx < d.fw ? B(qy, d.cw + qx) : 0;
  HL = qy < d.fh ? B(d.ch + qy, qx) : 0;
  HH = (qy < d.fh && qx < d.fw) ? B(d.ch + qy, d.cw + qx) : 0;
}

// The four outputs (2 qy + dy, 2 qx + dx), at o[2 dy + dx], of quad (qy,
// qx) of a Haar inverse level (sbt.c:351-574). L(r, c): the LL entering
// the level, scaled where the level scales, which at c == cw holds the
// level's first LH column and at r == ch its first HL row (the nudge's
// edge reads, scaled too). hqp < 0: no filter (chroma).
template <class LF>
__device__ __forceinline__ void haar_quad(LF L, int LH, int HL, int HH,
                                          const Quad& d, int hqp, int qy,
                                          int qx, int o[4]) {
  const int LL = L(qy, qx);
  if (hqp >= 0) {
    if (qx >= 1 && qx <= d.fw - 1 && qy <= d.fh - 1)
      LH = nudge(LL, L(qy, qx - 1), L(qy, qx + 1), LH, hqp);
    if (qy >= 1 && qy <= d.fh - 1 && qx <= d.fw - 1)
      HL = nudge(LL, L(qy - 1, qx), L(qy + 1, qx), HL, hqp);
  }
  o[0] = (LL + LH + HL + HH) / 4;
  o[1] = (LL - LH + HL - HH) / 4;
  o[2] = (LL + LH - HL - HH) / 4;
  o[3] = (LL - LH - HL + HH) / 4;
}

// Programmatic dependent launch (sm_90): a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start while the
// previous kernel on its stream runs; dep_wait() returns once that kernel
// has finished and its writes are visible, dep_launch() lets the next
// kernel start. No-ops for a kernel launched without the attribute.
__device__ __forceinline__ void dep_wait() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  asm volatile("griddepcontrol.wait;" ::: "memory");
#endif
}

__device__ __forceinline__ void dep_launch() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  asm volatile("griddepcontrol.launch_dependents;");
#endif
}

// An asynchronous 4-byte copy from device to shared memory (sm_80):
// copy_async issues it, copy_wait waits for the thread's copies.
__device__ __forceinline__ void copy_async(int* dst, const int* src) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 800
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
               "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void copy_async16(int* dst, const int* src) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 800
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src)
               : "memory");
#else
  for (int k = 0; k < 4; ++k) dst[k] = src[k];
#endif
}

__device__ __forceinline__ void copy_wait() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 800
  asm volatile("cp.async.wait_all;" ::: "memory");
#endif
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

// Stages the LL entering level d (scaled where `scale`) at rows r0.. and
// columns c0.. into T (nr x nc): inside the LL region from ll (row stride
// lls), elsewhere (the level's first band row and column, which the
// nudge reads) from a; 0 off the plane.
__device__ __forceinline__ void stage_ll(int* T, int nr, int nc, int r0,
                                         int c0, const int* ll, int64_t lls,
                                         const int* a, const Inv& P,
                                         const Quad& d, bool scale, int tid) {
  for (int p = tid; p < nr * nc; p += kThreads) {
    const int rr = p / nc, r = r0 + rr, c = c0 + (p - rr * nc);
    int v = 0;
    if (r >= 0 && c >= 0 && r < P.H && c < P.W)
      v = (r < d.ch && c < d.cw) ? ll[(int64_t)r * lls + c]
                                 : a[(int64_t)r * P.as + c];
    T[p] = scale ? sc(v) : v;
  }
}

// A level's quad index p as (p / cw, ...) without a division: m =
// quad_rcp(cw), exact for p * cw < 2^32 (the coarse stage's levels hold at
// most 232,448 / 4 values)
__device__ __forceinline__ unsigned quad_rcp(int cw) {
  return cw > 1 ? 0xffffffffu / (unsigned)cw + 1u : 0u;
}
__device__ __forceinline__ int quad_row(int p, int cw, unsigned m) {
  return cw > 1 ? (int)__umulhi((unsigned)p, m) : p;
}

// The four outputs, at o[2 dy + dx], of quad (qy, qx) of a coarse level:
// haar_quad on the stage's shared memory A, the LL entering the level at
// A + in (row stride S; where the nudge reads past it, at column cw or
// row ch, the level's first LH column and HL row in the staged corner),
// the bands in the corner, read unconditionally (every such read is
// inside A, whose corner the two LL buffers follow) and zeroed past odd
// dims.
__device__ __forceinline__ void coarse_quad_out(const int* A, int in, int S,
                                                const Quad& d, int hqp,
                                                int qy, int qx, int o[4]) {
  const int* hrow = A + (d.ch + qy) * S;
  const int lh = A[qy * S + d.cw + qx], hl = hrow[qx], hh = hrow[d.cw + qx];
  auto L = [&](int r, int c) {
    return sc(A[(r < d.ch && c < d.cw ? in : 0) + r * S + c]);
  };
  haar_quad(L, qx < d.fw ? lh : 0, qy < d.fh ? hl : 0,
            qy < d.fh && qx < d.fw ? hh : 0, d, hqp, qy, qx, o);
}

// coarse_quad_out into the LL buffer at A + out (row stride S)
__device__ __forceinline__ void coarse_quad(int* A, int in, int out, int S,
                                            const Quad& d, int hqp, int qy,
                                            int qx) {
  int o[4];
  coarse_quad_out(A, in, S, d, hqp, qy, qx, o);
  int* r = A + out + 2 * qy * S + 2 * qx;
  r[0] = o[0];
  if (2 * qx + 1 < d.ws) r[1] = o[1];
  if (2 * qy + 1 < d.hs) {
    r[S] = o[2];
    if (2 * qx + 1 < d.ws) r[S + 1] = o[3];
  }
}

// The coarse stage: one block per plane runs levels top..lo (lo >= 3) on
// the corner of a that they read, staged into shared memory A (row
// stride S, level lo's width) and only read there; each level's output,
// the LL entering the next, goes to one of two buffers X, Y (ch_lo rows
// of stride S each) in turns, level lo's to dst (+ z * dbatch, row
// stride its width). Levels of at most 64 quads run on one warp, the
// others on the block, a thread every 1024th quad.
__global__ void __launch_bounds__(kCoarseThreads, 1)
inv_coarse_kernel(Inv P, int top, int lo, int* __restrict__ dst,
                  int64_t dbatch) {
  extern __shared__ int A[];
  // launched chained to the kernel that wrote a: its launch overlaps that
  // kernel's end; the next launches may start once a is complete
  dep_wait();
  dep_launch();
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  constexpr int kWarps = kCoarseThreads / 32;
  const int* a = P.a + b * P.abatch;
  const Quad dl = quad_dims(P.W, P.H, lo);
  const int S = dl.ws;
  // the two LL buffers, as offsets into A so that every access is a
  // shared-memory one
  const int buf0 = dl.hs * S, buf1 = (dl.hs + dl.ch) * S;
  // every copy in flight at once: a warp a row, a lane 16 bytes (or 4)
  if (S % 4 == 0 && P.as % 4 == 0 && (uintptr_t)a % 16 == 0) {
    for (int r = warp; r < dl.hs; r += kWarps)
      for (int c = 4 * lane; c < S; c += 128)
        copy_async16(A + r * S + c, a + (int64_t)r * P.as + c);
  } else {
    for (int r = warp; r < dl.hs; r += kWarps)
      for (int c = lane; c < S; c += 32)
        copy_async(A + r * S + c, a + (int64_t)r * P.as + c);
  }
  // each level's geometry and quad-row reciprocal, computed while the
  // corner is in flight, so that no level waits on them
  __shared__ Quad s_d[kMaxLevels + 1];
  __shared__ unsigned s_m[kMaxLevels + 1];
  if (tid >= lo && tid <= top) {
    s_d[tid] = quad_dims(P.W, P.H, tid);
    s_m[tid] = quad_rcp(s_d[tid].cw);
  }
  copy_wait();
  __syncthreads();
  const int hqp4 = level_hqp(P, b, 4);  // every level above 3
  int in = 0, k = 0, i = top;
  for (; i > lo; --i, k ^= 1) {  // the top levels: warp 0
    const Quad d = s_d[i];
    const int nq = d.ch * d.cw;
    if (nq > 64) break;
    if (warp == 0) {
      const unsigned m = s_m[i];
      for (int p = lane; p < nq; p += 32) {
        const int qy = quad_row(p, d.cw, m);
        coarse_quad(A, in, k ? buf1 : buf0, S, d, hqp4, qy, p - qy * d.cw);
      }
      __syncwarp();
    }
    in = k ? buf1 : buf0;
  }
  __syncthreads();
  for (; i >= lo; --i, k ^= 1) {
    const Quad d = s_d[i];
    const int nq = d.ch * d.cw;
    const unsigned m = s_m[i];
    const int hqp = i > 3 ? hqp4 : level_hqp(P, b, i);
    for (int p = tid; p < nq; p += kCoarseThreads) {
      const int qy = quad_row(p, d.cw, m), qx = p - qy * d.cw;
      if (i > lo) {
        coarse_quad(A, in, k ? buf1 : buf0, S, d, hqp, qy, qx);
      } else {
        int o[4];
        coarse_quad_out(A, in, S, d, hqp, qy, qx, o);
        int* out = dst + b * dbatch + 2 * qy * S + 2 * qx;
        out[0] = o[0];
        if (2 * qx + 1 < d.ws) out[1] = o[1];
        if (2 * qy + 1 < d.hs) {
          out[S] = o[2];
          if (2 * qx + 1 < d.ws) out[S + 1] = o[3];
        }
      }
    }
    if (i > lo) __syncthreads();
    in = k ? buf1 : buf0;
  }
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

// The first part of a tile kernel of level i, and of level u = i + 1
// where has_up: the LL entering level i over a tile of kTQX x kLQY
// level-i quads from (qy0, qx0), with its one-value halo, into T1
// (scaled where level i scales). With has_up: level u's output, computed
// from the LL entering level u at ll (row stride lls; staged into T2
// with its halo, scaled), and past it a (level i's first band row and
// column); else staged from ll (the LL entering level i) and a. The
// loads that do not depend on the previous kernel come first, `pre` (the
// caller's own) among them; then dep_wait(). Ends with a block barrier.
template <class Pre>
__device__ __forceinline__ void tile_upper(const Inv& P, int b, int i,
                                           int has_up, const int* ll,
                                           int64_t lls, int* T1, int* T2,
                                           int qy0, int qx0, int tid,
                                           Pre pre) {
  const int* a = P.a + b * P.abatch;
  auto B = [&](int r, int c) { return __ldg(a + (int64_t)r * P.as + c); };
  const Quad d1 = quad_dims(P.W, P.H, i), d2 = quad_dims(P.W, P.H, i + 1);
  const bool scale = i > 1;
  const int r2 = qy0 / 2 - 1, c2 = qx0 / 2 - 1;  // the tile's level-u quads
  int q2y[kQ2N], q2x[kQ2N], lh[kQ2N], hl[kQ2N], hh[kQ2N];
  bool in2[kQ2N];
#pragma unroll
  for (int k = 0; k < kQ2N; ++k) {
    const int t = tid + k * kThreads, ty = t / kQ2W;
    q2y[k] = r2 + ty;
    q2x[k] = c2 + (t - ty * kQ2W);
    in2[k] = has_up && t < kQ2H * kQ2W && q2y[k] >= 0 && q2x[k] >= 0 &&
             q2y[k] < d2.ch && q2x[k] < d2.cw;
    lh[k] = hl[k] = hh[k] = 0;
    if (in2[k]) quad_bands(B, d2, q2y[k], q2x[k], lh[k], hl[k], hh[k]);
  }
  const int hqp2 = level_hqp(P, b, i + 1);
  pre();
  // T1 off level u's output, on tiles at the level's edges only
  if (has_up && (qy0 == 0 || qx0 == 0 || qy0 + kLQY >= d1.ch ||
                 qx0 + kTQX >= d1.cw)) {
    for (int p = tid; p < kH1H * kHW; p += kThreads) {
      const int rr = p / kHW, r = qy0 - 1 + rr, c = qx0 - 1 + (p - rr * kHW);
      if (r >= 0 && c >= 0 && r < d1.ch && c < d1.cw) continue;
      const int v = (r >= 0 && c >= 0 && r < P.H && c < P.W)
                        ? a[(int64_t)r * P.as + c] : 0;
      T1[p] = scale ? sc(v) : v;
    }
  }
  dep_wait();  // the level above has written ll
  if (!has_up)
    stage_ll(T1, kH1H, kHW, qy0 - 1, qx0 - 1, ll, lls, a, P, d1, scale, tid);
  if (has_up) {
    stage_ll(T2, kL2H, kL2W, r2 - 1, c2 - 1, ll, lls, a, P, d2, true, tid);
    __syncthreads();
    auto L2 = [&](int r, int c) {
      return T2[(r - r2 + 1) * kL2W + (c - c2 + 1)];
    };
#pragma unroll
    for (int k = 0; k < kQ2N; ++k) {
      if (!in2[k]) continue;
      int o[4];
      haar_quad(L2, lh[k], hl[k], hh[k], d2, hqp2, q2y[k], q2x[k], o);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int y = 2 * q2y[k] + (j >> 1), x = 2 * q2x[k] + (j & 1);
        const int ty1 = y - qy0 + 1, tx1 = x - qx0 + 1;
        if (y < d2.hs && x < d2.ws && ty1 >= 0 && ty1 < kH1H && tx1 >= 0 &&
            tx1 < kHW)
          T1[ty1 * kHW + tx1] = scale ? sc(o[j]) : o[j];
      }
    }
  }
  __syncthreads();
}

// Level i >= 3, and level i + 1 where has_up, over the batch, a tile of
// kTQX x kLQY level-i quads a block: the LL entering the first of them at
// ll (row stride lls, + z * lbatch), level i's output into dst (+ z *
// dbatch, row stride its width).
__global__ void __launch_bounds__(kThreads)
inv_tile_kernel(Inv P, int i, int has_up, const int* __restrict__ ll,
                int64_t lls, int64_t lbatch, int* __restrict__ dst,
                int64_t dbatch) {
  __shared__ int T1[kH1H * kHW];
  __shared__ int T2[kL2H * kL2W];
  dep_launch();
  const Quad d = quad_dims(P.W, P.H, i);
  const int b = blockIdx.z, tid = threadIdx.y * kTQX + threadIdx.x;
  const int qx0 = blockIdx.x * kTQX, qy0 = blockIdx.y * kLQY;
  const int qx = qx0 + threadIdx.x;
  const int* a = P.a + b * P.abatch;
  auto B = [&](int r, int c) { return __ldg(a + (int64_t)r * P.as + c); };
  int LH[kLR], HL[kLR], HH[kLR];
  auto pre = [&] {
#pragma unroll
    for (int r = 0; r < kLR; ++r) {
      const int qy = qy0 + threadIdx.y + r * kTQY;
      LH[r] = HL[r] = HH[r] = 0;
      if (qy < d.ch && qx < d.cw) quad_bands(B, d, qy, qx, LH[r], HL[r], HH[r]);
    }
  };
  tile_upper(P, b, i, has_up, ll + b * lbatch, lls, T1, T2, qy0, qx0, tid,
             pre);
  auto L1 = [&](int r, int c) {
    return T1[(r - qy0 + 1) * kHW + (c - qx0 + 1)];
  };
  const int hqp = level_hqp(P, b, i);
  int* out = dst + b * dbatch;
#pragma unroll
  for (int r = 0; r < kLR; ++r) {
    const int qy = qy0 + threadIdx.y + r * kTQY;
    if (qy >= d.ch || qx >= d.cw) continue;
    int o[4];
    haar_quad(L1, LH[r], HL[r], HH[r], d, hqp, qy, qx, o);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int y = 2 * qy + (j >> 1), x = 2 * qx + (j & 1);
      if (y < d.hs && x < d.ws) out[(int64_t)y * d.ws + x] = o[j];
    }
  }
}

// Levels 2 (where the plane has it: has2) and 1 and the epilogue over the
// batch, a tile of kTQX x kLQY level-1 quads a block. ll: the LL entering
// level 2 (row stride lls, + z * lbatch). w4: the image takes aligned
// 32-bit stores (modes 1 and 2).
__global__ void __launch_bounds__(kThreads)
inv_last_kernel(Inv P, int has2, const int* __restrict__ ll, int64_t lls,
                int64_t lbatch, Epi E, int w4) {
  __shared__ int T1[kH1H * kHW];     // the LL entering level 1, its halo
  __shared__ int T2[kL2H * kL2W];    // the LL entering level 2 behind it
  __shared__ int V[2][2 * kLQY][kHW];  // I planes: the B4T's column pass
  // the tile's pixels, read back as 32-bit words
  __shared__ __align__(16) uint8_t U[2 * kLQY][2 * kTQX];
  dep_launch();
  const Quad d1 = quad_dims(P.W, P.H, 1);
  const int b = blockIdx.z, tid = threadIdx.y * kTQX + threadIdx.x;
  const int qx0 = blockIdx.x * kTQX, qy0 = blockIdx.y * kLQY;
  const int qx = qx0 + threadIdx.x;
  const int* a = P.a + b * P.abatch;
  auto B = [&](int r, int c) { return __ldg(a + (int64_t)r * P.as + c); };
  // this thread's level-1 bands and prediction
  int LH[kLR], HL[kLR], HH[kLR];
  uint8_t pr[kLR][4];
  auto pre = [&] {
#pragma unroll
    for (int r = 0; r < kLR; ++r) {
      const int qy = qy0 + threadIdx.y + r * kTQY;
      LH[r] = HL[r] = HH[r] = 0;
      if (P.is_p && qy < d1.ch && qx < d1.cw)
        quad_bands(B, d1, qy, qx, LH[r], HL[r], HH[r]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int y = 2 * qy + (j >> 1), x = 2 * qx + (j & 1);
        pr[r][j] = E.mode == 2 && y < E.h && x < E.w
                       ? E.pred[b * E.pbatch + (int64_t)y * E.pstride + x]
                       : 0;
      }
    }
  };
  tile_upper(P, b, 1, has2, ll + b * lbatch, lls, T1, T2, qy0, qx0, tid, pre);
  auto L1 = [&](int r, int c) {
    return T1[(r - qy0 + 1) * kHW + (c - qx0 + 1)];
  };
  int v[kLR][4];
  if (P.is_p) {
    const int hqp = level_hqp(P, b, 1);
#pragma unroll
    for (int r = 0; r < kLR; ++r) {
      const int qy = qy0 + threadIdx.y + r * kTQY;
      if (qy < d1.ch && qx < d1.cw)
        haar_quad(L1, LH[r], HL[r], HH[r], d1, hqp, qy, qx, v[r]);
    }
  } else {
    // the inverse B4T of the (H, W) in-place state (inv_b4t_2d,
    // sbt.c:195-265): the reconstructed LL corner and the raw bands. First
    // each column's inverse at the tile's rows, for columns qx0 - 1..qx0 +
    // kTQX of the L half (V[0]) and of the H half (V[1]), then the rows.
    const int m = P.H / 2, mw = P.W / 2;
    auto F = [&](int r, int c) {
      return r < m && c < mw ? L1(r, c) : B(r, c);
    };
    for (int p = tid; p < 2 * 2 * kLQY * kHW; p += kThreads) {
      const int g = p / (2 * kLQY * kHW), e = p - g * (2 * kLQY * kHW);
      const int yy = e / kHW, cc = e - yy * kHW;
      const int y = 2 * qy0 + yy, c0 = qx0 - 1 + cc;
      if (y >= P.H || c0 < 0 || c0 >= mw) continue;
      const int c = g ? mw + c0 : c0, k = y >> 1;
      int t;
      if ((y & 1) == 0) {
        const int kp = max(k - 1, 0);
        t = round8(F(kp, c) + 3 * F(k, c) + F(m + kp, c) - 3 * F(m + k, c));
      } else {
        const int kn = min(k + 1, m - 1);
        t = round8(3 * F(k, c) + F(kn, c) + 3 * F(m + k, c) - F(m + kn, c));
      }
      V[g][yy][cc] = t;
    }
    __syncthreads();
    const int jp = max(qx - 1, 0) - qx0 + 1, j = qx - qx0 + 1;
    const int jn = min(qx + 1, mw - 1) - qx0 + 1;
#pragma unroll
    for (int r = 0; r < kLR; ++r) {
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int* V0 = V[0][2 * (threadIdx.y + r * kTQY) + dy];
        const int* V1 = V[1][2 * (threadIdx.y + r * kTQY) + dy];
        v[r][2 * dy] = round8(V0[jp] + 3 * V0[j] + V1[jp] - 3 * V1[j]);
        v[r][2 * dy + 1] = round8(3 * V0[j] + V0[jn] + 3 * V1[j] - V1[jn]);
      }
    }
  }
  if (E.mode == 0) {
    int* out = static_cast<int*>(E.out) + b * E.obatch;
#pragma unroll
    for (int r = 0; r < kLR; ++r) {
      const int qy = qy0 + threadIdx.y + r * kTQY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int y = 2 * qy + (j >> 1), x = 2 * qx + (j & 1);
        if (y < P.H && x < P.W) out[(int64_t)y * E.ostride + x] = v[r][j];
      }
    }
    return;
  }
  const int Y0 = 2 * qy0, X0 = 2 * qx0;
  uint8_t* out = static_cast<uint8_t*>(E.out) + b * E.obatch;
  // a tile off the plane's edges: each thread stores its quads' pixel
  // pairs straight away
  const bool inner = w4 && Y0 > 0 && X0 > 0 && Y0 + 2 * kLQY < E.h &&
                     X0 + 2 * kTQX < E.w;
  uint8_t px[kLR][4];
#pragma unroll
  for (int r = 0; r < kLR; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int t = clampi(v[r][j] + 128, 0, 255);                 // sbc2int
      if (E.mode == 2) t = clampi(pr[r][j] + t - 128, 0, 255);  // addf
      px[r][j] = (uint8_t)t;
    }
  }
  if (inner) {
#pragma unroll
    for (int r = 0; r < kLR; ++r) {
      const int y = 2 * (qy0 + threadIdx.y + r * kTQY);
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
        *reinterpret_cast<uint16_t*>(out + (int64_t)(y + dy) * E.ostride +
                                     2 * qx) =
            (uint16_t)(px[r][2 * dy] | px[r][2 * dy + 1] << 8);
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < kLR; ++r) {
    const int qy = qy0 + threadIdx.y + r * kTQY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int y = 2 * qy + (j >> 1), x = 2 * qx + (j & 1);
      if (y < E.h && x < E.w)
        U[2 * (threadIdx.y + r * kTQY) + (j >> 1)]
         [2 * threadIdx.x + (j & 1)] = px[r][j];
    }
  }
  __syncthreads();
  // the tile's pixels and, where it holds the plane's edge, the border
  // pixels that repeat them: each image pixel is written by one block
  if (Y0 >= E.h || X0 >= E.w) return;
  const int Y1 = min(Y0 + 2 * kLQY, E.h), X1 = min(X0 + 2 * kTQX, E.w);
  const int ey0 = Y0 == 0 ? -E.ext : Y0, ey1 = Y1 == E.h ? E.h + E.ext : Y1;
  const int ex0 = X0 == 0 ? -E.ext : X0, ex1 = X1 == E.w ? E.w + E.ext : X1;
  auto src = [&](const uint8_t* u, int X) {
    return u[clampi(X, 0, E.w - 1) - X0];
  };
  for (int Y = ey0 + (int)threadIdx.y; Y < ey1; Y += kTQY) {
    const uint8_t* u = U[clampi(Y, 0, E.h - 1) - Y0];
    uint8_t* o = out + (int64_t)Y * E.ostride;
    if (w4) {  // ex0 is a multiple of 4: a word a lane, bytes at the end
      for (int X = ex0 + 4 * (int)threadIdx.x; X < ex1; X += 4 * kTQX) {
        if (X + 4 > ex1) {
          for (int k = X; k < ex1; ++k) o[k] = src(u, k);
        } else if (X >= 0 && X + 4 <= E.w) {
          *reinterpret_cast<uint32_t*>(o + X) =
              *reinterpret_cast<const uint32_t*>(u + (X - X0));
        } else {
          *reinterpret_cast<uint32_t*>(o + X) =
              (uint32_t)src(u, X) | (uint32_t)src(u, X + 1) << 8 |
              (uint32_t)src(u, X + 2) << 16 | (uint32_t)src(u, X + 3) << 24;
        }
      }
    } else {
      for (int X = ex0 + (int)threadIdx.x; X < ex1; X += kTQX)
        o[X] = src(u, X);
    }
  }
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

// A launch of kern with smem bytes of dynamic shared memory on stream s;
// with dep, chained to the stream's previous kernel by programmatic
// dependent launch.
template <class... K, class... Args>
cudaError_t launch_k(void (*kern)(K...), dim3 grid, dim3 block, size_t smem,
                     cudaStream_t s, bool dep, Args... args) {
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = at;
  cfg.numAttrs = dep ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

}  // namespace

// The inverse pyramid of C planes (H, W) at a (+ z * abatch, row stride
// as), levels top..1: with top >= 3 the coarse stage runs top..lo (3 <=
// lo <= top), then levels lo - 1..3 two a launch (the last alone where
// their count is odd), then levels 2 and 1 in one launch. scratch, where
// top >= 3: C * n3 ints, twice where lo > 3 (n3 = round_shift(H, 2) *
// round_shift(W, 2), level 3's output a plane). q: int32 per plane (+ z
// * qstride) or null for qscalar. mode, out, ostride, obatch, h, w, ext,
// pred, pstride, pbatch: the last level's output (see Epi).
extern "C" int dsv1_inv_sbt(const int* a, int64_t as, int64_t abatch, int H,
                            int W, int C, int top, int lo, const int* q,
                            int64_t qstride, int qscalar, int is_p, int luma,
                            int* scratch, int mode, void* out,
                            int64_t ostride, int64_t obatch, int h, int w,
                            int ext, const uint8_t* pred, int64_t pstride,
                            int64_t pbatch, cudaStream_t stream) {
  if (C < 1 || C > 65535 || top < 1 || H < 2 || W < 2 || h > H || w > W ||
      (!is_p && (H % 2 || W % 2)) || mode < 0 || mode > 2 ||
      (mode == 2 && !pred))
    return (int)cudaErrorInvalidValue;
  auto n_of = [&](int i) {
    const Quad d = quad_dims(W, H, i);
    return (int64_t)d.hs * d.ws;
  };
  // the coarse stage's shared memory: the corner and two LL buffers
  const Quad dl = quad_dims(W, H, top >= 3 ? lo : 1);
  const int64_t smem = (int64_t)(dl.hs + 2 * dl.ch) * dl.ws * sizeof(int);
  // with the stage's static table of level geometry
  const int64_t static_smem =
      (int64_t)(kMaxLevels + 1) * (sizeof(Quad) + sizeof(unsigned));
  if (top >= 3 && (lo < 3 || lo > top || top > kMaxLevels || !scratch ||
                   smem + static_smem > kCoarseSmem))
    return (int)cudaErrorInvalidValue;
  const Inv P{a, as, abatch, H, W, q, qstride, qscalar, is_p, luma};
  const dim3 tile(kTQX, kTQY);
  const int* ll = a;  // the LL region entering level 2
  int64_t lls = as, lbatch = abatch;
  cudaError_t e;
  if (top >= 3) {
    // the launches write scratch and scratch + C * n3 in turns, each a
    // level's output (plane stride n3, the largest, level 3's)
    const int64_t n3 = n_of(3);
    int* buf = scratch;
    if (smem + static_smem > 48 * 1024) {
      e = cudaFuncSetAttribute(inv_coarse_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    e = launch_k(inv_coarse_kernel, dim3(C), dim3(kCoarseThreads), smem,
                 stream, true, P, top, lo, buf, n3);
    if (e != cudaSuccess) return (int)e;
    // levels lo - 1..3: two a launch, the last one alone where their
    // count is odd
    for (int i = lo - 1; i >= 3;) {
      int* next = buf == scratch ? scratch + C * n3 : scratch;
      const int lower = i - 1 >= 3 ? i - 1 : i;
      const Quad d = quad_dims(W, H, lower);
      e = launch_k(inv_tile_kernel,
                   dim3((d.cw + kTQX - 1) / kTQX, (d.ch + kLQY - 1) / kLQY,
                        C),
                   tile, 0, stream, true, P, lower, (int)(lower < i),
                   (const int*)buf, (int64_t)quad_dims(W, H, i + 1).ws, n3,
                   next, n3);
      if (e != cudaSuccess) return (int)e;
      buf = next;
      i = lower - 1;
    }
    ll = buf;
    lls = quad_dims(W, H, 3).ws;
    lbatch = n3;
  }
  const Epi E{out, ostride, obatch, mode, h, w, ext, pred, pstride, pbatch};
  const Quad d1 = quad_dims(W, H, 1);
  // aligned 32-bit stores: the words from column -ext start at multiples
  // of 4 of the image (pixel (0, 0) and the rows at multiples of 4)
  const int w4 = mode > 0 && ext % 4 == 0 && (uintptr_t)out % 4 == 0 &&
                 ostride % 4 == 0 && obatch % 4 == 0;
  e = launch_k(inv_last_kernel,
               dim3((d1.cw + kTQX - 1) / kTQX, (d1.ch + kLQY - 1) / kLQY, C),
               tile, 0, stream, top >= 3, P, (int)(top >= 2), ll, lls, lbatch,
               E, w4);
  if (e != cudaSuccess) return (int)e;
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
