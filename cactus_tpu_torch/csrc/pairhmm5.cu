// 5-state (match M / short and long query gaps SX, LX / short and long
// target gaps SY, LY) banded pair-HMM forward and backward passes in
// scaled linear float32 -- cPecan's stateMachine5 -- for NVIDIA Hopper
// (built for sm_90a with -fmad=false, bound with ctypes).
//
// pairhmm5_fwd replaces the Pallas TPU kernel
// cactus_tpu/ops/pairhmm5_pallas.py::_fwd_kernel and pairhmm5_bwd replaces
// ::_bwd_kernel (entry posterior_banded_batch5_pallas).  Their contract is
// cactus_tpu/ops/pairhmm5.py::posterior_banded_batch5, split in two:
//   fwd:  q, t_shift, m_len, n_len, lo, em, nine transitions -> fM (P, M, B)
//         f32 (match band of every row after rescaling), lsF (P, M) f32
//         (running log-scale after each row), logZ (P,) f32
//   bwd:  fM, lsF, logZ and the same inputs -> post (P, M, B) f32, the
//         match posterior fM*bM*exp(clip(lsF+lsB-logZ, -60, 60)) clipped
//         to [0, 1.5] and zero past each pair's m_len; the combine is fused
//         into the backward row loop, so bM never reaches device memory.
// Every row is rescaled by its band maximum, as the contract does
// (pairhmm5.py:254-257, :327-331) -- not every 8 rows as the Pallas kernel
// does -- by a multiply with the maximum's reciprocal: IEEE divisions,
// five a cell, took 84% of a row at band 1024 (tests/pairhmm_sweep_report.py
// --model 5 on the H100; the posteriors' gap to the plain version moved
// by under 2e-4).  The backward pass starts at each pair's own terminal row m_len.
// The transitions are kernel arguments, so one build serves every
// divergence-trained p_match and parameter set.  Float results follow the
// plain PyTorch version (cactus_tpu_torch/ops/pairhmm5.py) to rounding:
// the in-row chains are summed in another order, and expf/logf differ
// from the host's by an ulp.
//
// What bounds them on an H100: the chain of rows.  A row needs the whole
// previous row, so a pair's rows run one after another; the bytes (4 a
// cell written forward, 4 read and 4 written backward, over the full band
// the contract's (P, M, B) layout has) and the ~40 float32 operations a
// live cell are far below the card's rates.  So the design shortens a row:
//  - Only the live window.  Row i has live columns j = jlo(i) .. jhi(i),
//    jlo = max(0, i + lo), jhi = min(n, i + lo + B - 1); every other cell
//    of the contract is exactly 0 (tests/test_torch_pairhmm5_live.py).
//    The kernels index a row by its window cell k = j - jlo(i): lane l
//    owns the C cells k = l C .. l C + C - 1 of every row.  From row i - 1
//    to row i the window moves by delta = jlo(i) - jlo(i - 1) in {0, 1}:
//    M at k reads the previous row at k - 1 + delta, SX and LX at
//    k + delta, so a read outside the previous row's window meets the
//    zeros stored there (or past the lanes' cover).  A pair's whole
//    (M, B) output is first zeroed in one coalesced pass (the rows past
//    m, the cells outside each row's window); each row then stores its
//    window.
//  - Blocks sized by the launch's widest live row, max_live (the wrapper
//    checks it against each pair's min(B, n + 1)): 4 cells a lane in
//    ceil(max_live / 128) warps, one warp up to 128 cells (8, 16 and 64
//    cells a lane past 4096, 8192 and 16384 cells; launch_shape).
//  - The previous row's states live in shared memory (five rows forward:
//    M, SX, LX, SY, LY; three backward: bM, bSX, bLX), one pad word in 33
//    so the lanes' contiguous runs fall on distinct banks; above 8192
//    cells in a per-pair global scratch row the wrapper allocates.
//  - The coupled in-row chain [SY,LY][k] = A [SY,LY][k-1] + c[k], with
//    A = [[e_s, w_ls], [w_sl, e_l]] forward and A^T reversed backward, is
//    an affine scan of 2x2 maps: each lane composes its cells' maps, a
//    warp-shuffle Kogge-Stone scan combines the lanes with
//    (M2,v2)o(M1,v1) = (M2 M1, M2 v1 + v2), and each lane replays its
//    cells from its exact carry.  The row maximum is a warp-shuffle
//    reduction.  So a one-warp row has no block barrier.
//  - Several warps take one block barrier a row.  Each warp publishes its
//    chain map (and, forward, its map followed by the next warp's first
//    cell, whose c needs this warp's last M; backward, its map without
//    its first cell) in a slot double-buffered by row parity, and after
//    the barrier composes the carries of the warps before (forward) or
//    after (backward) it itself.  The row maximum then needs a second
//    exchange, so it waits for the next row's barrier: row i is computed
//    from row i - 1 as it stood before its rescale, and rescaled by row
//    i - 1's scale after the barrier, where row i - 1 is stored (the
//    values agree with the contract's to rounding).  The neighbour cells
//    a warp reads across its edge travel in the same slots: the M, SX,
//    LX of a warp's first and last cells, known before the barrier, and
//    forward the SY, LY of the previous warp's last cell, which is the
//    carry composed without the current warp's first cell; backward, the
//    next warp's first bM, formed from its pass-1 values and its map
//    without that cell.
// tests/test_torch_pairhmm5_live.py holds a numpy model of this schedule
// to the plain version and the JAX package.
// A launch whose widest live row passes kMaxCells (65,536 cells: 32 warps
// of 64 cells a lane) takes the wide kernels (pairhmm5_fwd_wide_kernel,
// pairhmm5_bwd_wide_kernel): the whole band of every row, a block's
// threads looping over it, the state rows in global scratch.  The
// wrapper routes by max_live (ops/pairhmm5_cuda.py::pairhmm5_route).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kTiny = 1e-30f;   // pairhmm5.py TINY
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;
// the widest cover (lanes x cells) whose state rows live in shared memory
constexpr int kSmemMaxCells = 8192;
// the widest live row a narrow launch takes (32 warps of 64 cells a
// lane); wider launches take the wide kernels
constexpr int kMaxCells = 32 * kMaxWarps * 64;
// the wide kernels' block
constexpr int kWideThreads = 512;

struct Trans {
  float mc, os, ol, es, el, wsl, wls, ms, ml;
};

// y -> [[a11, a12], [a21, a22]] y + (v1, v2)
struct Aff {
  float a11, a12, a21, a22, v1, v2;
};

__device__ __forceinline__ Aff aff_identity() {
  return Aff{1.f, 0.f, 0.f, 1.f, 0.f, 0.f};
}

// L after E: (L.M E.M, L.M E.v + L.v)
__device__ __forceinline__ Aff compose(const Aff& L, const Aff& E) {
  return Aff{L.a11 * E.a11 + L.a12 * E.a21, L.a11 * E.a12 + L.a12 * E.a22,
             L.a21 * E.a11 + L.a22 * E.a21, L.a21 * E.a12 + L.a22 * E.a22,
             (L.a11 * E.v1 + L.a12 * E.v2) + L.v1,
             (L.a21 * E.v1 + L.a22 * E.v2) + L.v2};
}

// one chain cell y -> A y + c applied after the map `a`
__device__ __forceinline__ Aff push_cell(const Aff& a, const float (&A)[4],
                                         float c1, float c2) {
  return Aff{A[0] * a.a11 + A[1] * a.a21, A[0] * a.a12 + A[1] * a.a22,
             A[2] * a.a11 + A[3] * a.a21, A[2] * a.a12 + A[3] * a.a22,
             (A[0] * a.v1 + A[1] * a.v2) + c1,
             (A[2] * a.v1 + A[3] * a.v2) + c2};
}

__device__ __forceinline__ void apply(const Aff& T, float& y1, float& y2) {
  const float n1 = (T.a11 * y1 + T.a12 * y2) + T.v1;
  const float n2 = (T.a21 * y1 + T.a22 * y2) + T.v2;
  y1 = n1;
  y2 = n2;
}

template <bool kDown>
__device__ __forceinline__ Aff shfl_aff(const Aff& x, int off) {
  Aff o;
  if (kDown) {
    o.a11 = __shfl_down_sync(kFull, x.a11, off);
    o.a12 = __shfl_down_sync(kFull, x.a12, off);
    o.a21 = __shfl_down_sync(kFull, x.a21, off);
    o.a22 = __shfl_down_sync(kFull, x.a22, off);
    o.v1 = __shfl_down_sync(kFull, x.v1, off);
    o.v2 = __shfl_down_sync(kFull, x.v2, off);
  } else {
    o.a11 = __shfl_up_sync(kFull, x.a11, off);
    o.a12 = __shfl_up_sync(kFull, x.a12, off);
    o.a21 = __shfl_up_sync(kFull, x.a21, off);
    o.a22 = __shfl_up_sync(kFull, x.a22, off);
    o.v1 = __shfl_up_sync(kFull, x.v1, off);
    o.v2 = __shfl_up_sync(kFull, x.v2, off);
  }
  return o;
}

// Inclusive scan of the lanes' maps over the warp (forward: the maps of
// lower lanes apply first; reverse: those of higher lanes); *ex gets the
// lane-exclusive map.
template <bool kReverse>
__device__ __forceinline__ Aff warp_scan(Aff x, Aff* ex) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Aff o = shfl_aff<kReverse>(x, off);
    if (kReverse ? lane + off < 32 : lane >= off) x = compose(x, o);
  }
  *ex = shfl_aff<kReverse>(x, 1);
  if (lane == (kReverse ? 31 : 0)) *ex = aff_identity();
  return x;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Exclusive scan of the threads' chain maps over the block, applied to
// y = 0: the chain value entering this thread's first cell.  Forward: the
// maps of lower threads apply first.  Reverse: those of higher threads.
template <bool kReverse>
__device__ float2 block_chain_carry(Aff x, Aff* buf) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Aff o = shfl_aff<kReverse>(x, off);
    const bool has = kReverse ? (lane + off < 32) : (lane >= off);
    if (has) x = compose(x, o);   // the other lanes' maps apply first
  }
  Aff ex = shfl_aff<kReverse>(x, 1);   // lane-exclusive map
  if (lane == (kReverse ? 31 : 0)) ex = aff_identity();
  if (lane == (kReverse ? 0 : 31)) buf[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    Aff acc = aff_identity();
    for (int k = 0; k < nwarps; ++k) {
      const int w = kReverse ? nwarps - 1 - k : k;
      const Aff tot = buf[w];
      buf[w] = acc;
      acc = compose(tot, acc);
    }
  }
  __syncthreads();
  const Aff wp = buf[warp];
  return make_float2((ex.a11 * wp.v1 + ex.a12 * wp.v2) + ex.v1,
                     (ex.a21 * wp.v1 + ex.a22 * wp.v2) + ex.v2);
}

__device__ float block_max(float v, float* buf) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) buf[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = buf[0];
    for (int w = 1; w < nwarps; ++w) acc = fmaxf(acc, buf[w]);
    buf[32] = acc;
  }
  __syncthreads();
  return buf[32];
}

// The exchange between the warps of a pair, double-buffered by row parity
// (kW = 1 for one-warp blocks, which never use it).
template <int kW>
struct Slots {
  Aff tot[2][kW];      // each warp's chain map
  Aff tot2[2][kW];     // fwd: then the next warp's first cell; bwd: the
                       // map without the warp's first cell
  float max[2][kW];    // each warp's row maximum
  float edge[2][kW][6];
};

// window cell k -> word of a state row: one pad word every 32 cells
__device__ __forceinline__ int pix(int k) { return k + (k >> 5); }

__host__ __device__ inline int row_words(int cells) {
  return cells + (cells >> 5) + 1;
}

// the live window of row i: first column jlo and width (0: none)
struct Window {
  int jlo, wd;
};

__device__ __forceinline__ Window window(int i, int n, int lo, int B) {
  const int jlo = max(0, i + lo);
  const int jhi = min(n, i + lo + B - 1);
  return Window{jlo, max(0, jhi - jlo + 1)};
}

// Zeros over a pair's (M, B) band, coalesced.
__device__ void zero_band(float* base, int M, int B) {
  const size_t cells = (size_t)M * B;
  if ((B & 3) == 0 && (reinterpret_cast<uintptr_t>(base) & 15) == 0) {
    float4* p4 = reinterpret_cast<float4*>(base);
    for (size_t k = threadIdx.x; k < cells / 4; k += blockDim.x)
      p4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (size_t k = threadIdx.x; k < cells; k += blockDim.x) base[k] = 0.f;
  }
}

template <bool kSmem>
__device__ __forceinline__ float* state_rows(float4* smem, float* scratch,
                                             int rows, int words) {
  return kSmem ? reinterpret_cast<float*>(smem)
               : scratch + (size_t)blockIdx.x * rows * words;
}

// The forward chain of one row over the lane's cells: c[k] = ok(k) *
// (os, ol) * M[k - 1] with M in mM (the previous lane's last M by
// shuffle).  Composes the lane's map (with several warps a warp's first
// cell is left to the warp before, whose published map tot2 ends with
// it), scans it over the warp and publishes the warp's maps.  Returns the
// lane-exclusive map.
template <int C, bool kMulti, int kW>
__device__ __forceinline__ Aff fwd_scan(const float (&mM)[C], int k0, int jl,
                                        int wd, int cover, const Trans& tr,
                                        const float (&A)[4], Slots<kW>& xs,
                                        int par) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float left = __shfl_up_sync(kFull, mM[C - 1], 1);
  if (lane == 0) left = 0.f;
  const bool skip = kMulti && lane == 0 && warp > 0;
  Aff a = aff_identity();
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = k0 + c;
    const bool ok = k < wd && jl + k >= 1;
    const float prev = c > 0 ? mM[c - 1] : left;
    if (!(c == 0 && skip))
      a = push_cell(a, A, ok ? tr.os * prev : 0.f, ok ? tr.ol * prev : 0.f);
  }
  Aff ex;
  const Aff x = warp_scan<false>(a, &ex);
  if (kMulti && lane == 31) {
    const int kn = k0 + C;   // the next warp's first cell
    const bool ok = kn < wd && jl + kn >= 1 && kn < cover;
    xs.tot[par][warp] = x;
    xs.tot2[par][warp] = push_cell(x, A, ok ? tr.os * mM[C - 1] : 0.f,
                                   ok ? tr.ol * mM[C - 1] : 0.f);
  }
  return ex;
}

// After the barrier: the chain value entering this warp (the maps tot2 of
// the warps before it applied to 0) and the value at the previous warp's
// last cell (its map tot).
template <int kW>
__device__ __forceinline__ void fwd_carry(const Slots<kW>& xs, int par,
                                          int warp, float& cy1, float& cy2,
                                          float& yl1, float& yl2) {
  cy1 = cy2 = yl1 = yl2 = 0.f;
  for (int w = 0; w < warp; ++w) {
    if (w == warp - 1) {
      yl1 = cy1;
      yl2 = cy2;
      apply(xs.tot[par][w], yl1, yl2);
    }
    apply(xs.tot2[par][w], cy1, cy2);
  }
}

template <int C, int kThreads, bool kSmem>
__global__ void __launch_bounds__(kThreads)
pairhmm5_fwd_kernel(const uint8_t* __restrict__ q,
                    const uint8_t* __restrict__ t_shift,
                    const int* __restrict__ m_len,
                    const int* __restrict__ n_len,
                    const int* __restrict__ lo,
                    const float* __restrict__ em, int M, int B, Trans tr,
                    float* scratch, float* __restrict__ fM_out,
                    float* __restrict__ lsF_out,
                    float* __restrict__ logZ_out) {
  constexpr bool kMulti = kThreads > 32;
  constexpr int kW = kMulti ? kMaxWarps : 1;
  extern __shared__ float4 smem_f4[];
  __shared__ Slots<kW> xs;
  __shared__ float s_em[36];
  __shared__ float s_end;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nw = blockDim.x >> 5;
  const int cover = blockDim.x * C;
  const int RW = row_words(cover);
  float* sM = state_rows<kSmem>(smem_f4, scratch, 5, RW);
  float* sSX = sM + RW;
  float* sLX = sSX + RW;
  float* sSY = sLX + RW;
  float* sLY = sSY + RW;

  const int p = blockIdx.x;
  const int k0 = t * C;               // the lane's first window cell
  const int kw0 = warp * 32 * C;      // the warp's first window cell
  const int lo_p = lo[p];
  const int m = min(m_len[p], M);
  const int n = n_len[p];
  const int end_row = m > 1 ? m : 1;
  const uint8_t* qp = q + (size_t)p * M;
  const uint8_t* tp = t_shift + (size_t)p * (M + B);
  float* fp = fM_out + (size_t)p * M * B;
  float* lp = lsF_out + (size_t)p * M;
  // forward chain matrix A = [[es, wls], [wsl, el]]
  const float A[4] = {tr.es, tr.wls, tr.wsl, tr.el};

  for (int k = t; k < 36; k += blockDim.x) s_em[k] = em[k];
  if (t == 0) s_end = 0.f;
  // the whole band first (rows past m, and the cells outside each row's
  // window); the rows then store their windows
  zero_band(fp, M, B);

  // row 0: M at j == 0; the SY/LY chains seeded by that M cell
  Window win = window(0, n, lo_p, B);
  float rM[C], rSX[C], rLX[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = k0 + c;
    rM[c] = k < win.wd && win.jlo + k == 0 ? 1.f : 0.f;
    rSX[c] = 0.f;
    rLX[c] = 0.f;
  }
  {
    const Aff ex = fwd_scan<C, kMulti>(rM, k0, win.jlo, win.wd, cover, tr, A,
                                       xs, 0);
    if (kMulti) __syncthreads();
    float y1 = 0.f, y2 = 0.f, yl1, yl2;
    if (kMulti) fwd_carry(xs, 0, warp, y1, y2, yl1, yl2);
    apply(ex, y1, y2);
    const bool skip = kMulti && lane == 0 && warp > 0;
    float left = __shfl_up_sync(kFull, rM[C - 1], 1);
    if (lane == 0) left = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = k0 + c;
      const bool ok = k < win.wd && win.jlo + k >= 1;
      const float prev = c > 0 ? rM[c - 1] : left;
      if (!(c == 0 && skip)) {
        const float c1 = ok ? tr.os * prev : 0.f;
        const float c2 = ok ? tr.ol * prev : 0.f;
        const float n1 = (A[0] * y1 + A[1] * y2) + c1;
        const float n2 = (A[2] * y1 + A[3] * y2) + c2;
        y1 = n1;
        y2 = n2;
      }
      const int kk = pix(k);
      sM[kk] = rM[c];
      sSX[kk] = 0.f;
      sLX[kk] = 0.f;
      sSY[kk] = ok ? y1 : 0.f;
      sLY[kk] = ok ? y2 : 0.f;
    }
  }
  __syncthreads();
  // the cells across the warp's edges, as stored: the next warp's first
  // cell (M, SX, LX) and the previous warp's last cell (all five)
  float nbR[3] = {0.f, 0.f, 0.f}, nbL[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (kMulti && lane == 31 && warp + 1 < nw) {
    const int kk = pix(k0 + C);
    nbR[0] = sM[kk];
    nbR[1] = sSX[kk];
    nbR[2] = sLX[kk];
  }
  if (kMulti && lane == 0 && warp > 0) {
    const int kk = pix(k0 - 1);
    nbL[0] = sM[kk];
    nbL[1] = sSX[kk];
    nbL[2] = sLX[kk];
    nbL[3] = sSY[kk];
    nbL[4] = sLY[kk];
  }

  float ls = 0.f;
  float sp = 1.f;   // several warps: the scale of the row before
  float isp = 1.f;  // its reciprocal
  for (int i = 1; i <= m; ++i) {
    const Window prev = win;
    win = window(i, n, lo_p, B);
    const int delta = win.jlo - prev.jlo;
    const int par = i & 1;
    const int bb = win.jlo - i - lo_p;   // band cell of window cell 0
    const float* erow = s_em + 6 * qp[i - 1];
    __syncwarp();
    // pass 1: mM, mSX, mLX from the previous row, M at k - 1 + delta and
    // SX, LX at k + delta
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = k0 + c;
      const int pk = k - 1 + delta;
      float fm, fsx, flx, fsy, fly;
      if (pk < 0) {
        fm = fsx = flx = fsy = fly = 0.f;
      } else if (kMulti && pk < kw0) {
        fm = nbL[0];
        fsx = nbL[1];
        flx = nbL[2];
        fsy = nbL[3];
        fly = nbL[4];
      } else {
        const int kk = pix(pk);
        fm = sM[kk];
        fsx = sSX[kk];
        flx = sLX[kk];
        fsy = sSY[kk];
        fly = sLY[kk];
      }
      const int qk = k + delta;
      float fmu, fsxu, flxu;
      if (qk >= cover) {
        fmu = fsxu = flxu = 0.f;
      } else if (kMulti && qk >= kw0 + 32 * C) {
        fmu = nbR[0];
        fsxu = nbR[1];
        flxu = nbR[2];
      } else {
        const int kk = pix(qk);
        fmu = sM[kk];
        fsxu = sSX[kk];
        flxu = sLX[kk];
      }
      const bool okx = k < win.wd;
      const bool ok = okx && win.jlo + k >= 1;
      const float emit = okx ? erow[tp[i - 1 + bb + k]] : 0.f;
      rM[c] = ok ? emit * ((tr.mc * fm + tr.ms * (fsx + fsy)) +
                           tr.ml * (flx + fly))
                 : 0.f;
      rSX[c] = okx ? (tr.os * fmu + tr.es * fsxu) + tr.wls * flxu : 0.f;
      rLX[c] = okx ? (tr.ol * fmu + tr.el * flxu) + tr.wsl * fsxu : 0.f;
    }
    const Aff ex = fwd_scan<C, kMulti>(rM, k0, win.jlo, win.wd, cover, tr, A,
                                       xs, par);
    if (kMulti) {
      if (lane == 0) {
        xs.edge[par][warp][0] = rM[0];
        xs.edge[par][warp][1] = rSX[0];
        xs.edge[par][warp][2] = rLX[0];
      }
      if (lane == 31) {
        xs.edge[par][warp][3] = rM[C - 1];
        xs.edge[par][warp][4] = rSX[C - 1];
        xs.edge[par][warp][5] = rLX[C - 1];
      }
      __syncthreads();   // the row's one barrier
    } else {
      __syncwarp();
    }

    // pass 2: the chain from the exact carry, the row maximum
    float y1 = 0.f, y2 = 0.f, yl1 = 0.f, yl2 = 0.f;
    if (kMulti) {
      fwd_carry(xs, par, warp, y1, y2, yl1, yl2);
      if (i >= 2) {
        float mx = xs.max[par ^ 1][0];
        for (int w = 1; w < nw; ++w) mx = fmaxf(mx, xs.max[par ^ 1][w]);
        sp = fmaxf(mx, kTiny);
        isp = 1.f / sp;
        // row i - 1, stored as it stood, rescaled
        const int bbp = prev.jlo - (i - 1) - lo_p;
        float* frow = fp + (size_t)(i - 2) * B;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int k = k0 + c;
          if (k < prev.wd) frow[bbp + k] = sM[pix(k)] * isp;
        }
        ls = ls + logf(sp);
        if (t == 0) lp[i - 2] = ls;
      }
    }
    apply(ex, y1, y2);
    const bool skip = kMulti && lane == 0 && warp > 0;
    float left = __shfl_up_sync(kFull, rM[C - 1], 1);
    if (lane == 0) left = 0.f;
    float rSY[C], rLY[C];
    float lmax = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = k0 + c;
      const bool ok = k < win.wd && win.jlo + k >= 1;
      const float prevM = c > 0 ? rM[c - 1] : left;
      if (!(c == 0 && skip)) {
        const float c1 = ok ? tr.os * prevM : 0.f;
        const float c2 = ok ? tr.ol * prevM : 0.f;
        const float n1 = (A[0] * y1 + A[1] * y2) + c1;
        const float n2 = (A[2] * y1 + A[3] * y2) + c2;
        y1 = n1;
        y2 = n2;
      }
      rSY[c] = ok ? y1 : 0.f;
      rLY[c] = ok ? y2 : 0.f;
    }
    if (kMulti && i >= 2) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        rM[c] = rM[c] * isp;
        rSX[c] = rSX[c] * isp;
        rLX[c] = rLX[c] * isp;
        rSY[c] = rSY[c] * isp;
        rLY[c] = rLY[c] * isp;
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
      lmax = fmaxf(lmax, (((rM[c] + rSX[c]) + rLX[c]) + rSY[c]) + rLY[c]);
    lmax = warp_max(lmax);

    if (kMulti) {
      // the row as it stands, before its rescale; its maximum and the
      // cells across the warp's edges for the next row
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int kk = pix(k0 + c);
        sM[kk] = rM[c];
        sSX[kk] = rSX[c];
        sLX[kk] = rLX[c];
        sSY[kk] = rSY[c];
        sLY[kk] = rLY[c];
      }
      if (lane == 0) xs.max[par][warp] = lmax;
      if (lane == 31 && warp + 1 < nw) {
        nbR[0] = xs.edge[par][warp + 1][0];
        nbR[1] = xs.edge[par][warp + 1][1];
        nbR[2] = xs.edge[par][warp + 1][2];
        if (i >= 2) {
          nbR[0] = nbR[0] * isp;
          nbR[1] = nbR[1] * isp;
          nbR[2] = nbR[2] * isp;
        }
      }
      if (lane == 0 && warp > 0) {
        const int kl = k0 - 1;
        const bool okl = kl < win.wd && win.jlo + kl >= 1;
        nbL[0] = xs.edge[par][warp - 1][3];
        nbL[1] = xs.edge[par][warp - 1][4];
        nbL[2] = xs.edge[par][warp - 1][5];
        nbL[3] = okl ? yl1 : 0.f;
        nbL[4] = okl ? yl2 : 0.f;
        if (i >= 2) {
#pragma unroll
          for (int s = 0; s < 5; ++s) nbL[s] = nbL[s] * isp;
        }
      }
    } else {
      // rescale by the row maximum, store the row
      const float s = fmaxf(lmax, kTiny);
      const float is = 1.f / s;
      ls = ls + logf(s);
      float* frow = fp + (size_t)(i - 1) * B;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int k = k0 + c;
        const int kk = pix(k);
        const float nM = rM[c] * is;
        const float nSX = rSX[c] * is;
        const float nLX = rLX[c] * is;
        const float nSY = rSY[c] * is;
        const float nLY = rLY[c] * is;
        sM[kk] = nM;
        sSX[kk] = nSX;
        sLX[kk] = nLX;
        sSY[kk] = nSY;
        sLY[kk] = nLY;
        if (k < win.wd) {
          frow[bb + k] = nM;
          if (i == end_row && win.jlo + k == n)
            s_end = nM + (((nSX + nLX) + nSY) + nLY);
        }
      }
      if (t == 0) lp[i - 1] = ls;
    }
  }
  if (kMulti && m >= 1) {
    // row m's scale, from the last row's maxima
    __syncthreads();
    float mx = xs.max[m & 1][0];
    for (int w = 1; w < nw; ++w) mx = fmaxf(mx, xs.max[m & 1][w]);
    sp = fmaxf(mx, kTiny);
    isp = 1.f / sp;
    const int bb = win.jlo - m - lo_p;
    float* frow = fp + (size_t)(m - 1) * B;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = k0 + c;
      if (k < win.wd) {
        const int kk = pix(k);
        const float nM = sM[kk] * isp;
        frow[bb + k] = nM;
        if (win.jlo + k == n) {
          const float nSX = sSX[kk] * isp;
          const float nLX = sLX[kk] * isp;
          const float nSY = sSY[kk] * isp;
          const float nLY = sLY[kk] * isp;
          s_end = nM + (((nSX + nLX) + nSY) + nLY);
        }
      }
    }
    ls = ls + logf(sp);
    if (t == 0) lp[m - 1] = ls;
  }
  __syncthreads();
  if (t == 0) {
    // rows past m: every state masked to 0, the row scale TINY
    float lz = logf(fmaxf(s_end, kTiny)) + ls;
    for (int i = m + 1; i <= M; ++i) {
      ls = ls + logf(kTiny);
      lp[i - 1] = ls;
      if (i == end_row) lz = logf(kTiny) + ls;
    }
    if (M < end_row) lz = logf(kTiny) + ls;
    logZ_out[p] = lz;
  }
}

// The backward chain of one row, from the right: c[k] = (ms, ml) * mm[k].
// Composes the lane's map (and the map without its first cell), scans it
// over the warp and publishes the warp's maps (lane 0: the whole warp's,
// and the one without the warp's first cell).  Returns the lane-exclusive
// map.
template <int C, bool kMulti, int kW>
__device__ __forceinline__ Aff bwd_scan(const float (&c1)[C],
                                        const float (&c2)[C],
                                        const float (&At)[4], Slots<kW>& xs,
                                        int par) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Aff a = aff_identity(), rest = a;
#pragma unroll
  for (int c = C - 1; c >= 0; --c) {
    if (c == 0) rest = a;
    a = push_cell(a, At, c1[c], c2[c]);
  }
  Aff ex;
  const Aff x = warp_scan<true>(a, &ex);
  if (kMulti && lane == 0) {
    xs.tot[par][warp] = x;
    xs.tot2[par][warp] = compose(rest, ex);
  }
  return ex;
}

// After the barrier: the chain value entering this warp from the right
// (the maps of the warps after it applied to 0) and the value at the
// next warp's second cell (its map without its first cell).
template <int kW>
__device__ __forceinline__ void bwd_carry(const Slots<kW>& xs, int par,
                                          int warp, int nw, float& cy1,
                                          float& cy2, float& yn1,
                                          float& yn2) {
  cy1 = cy2 = yn1 = yn2 = 0.f;
  for (int w = nw - 1; w > warp; --w) {
    if (w == warp + 1) {
      yn1 = cy1;
      yn2 = cy2;
      apply(xs.tot2[par][w], yn1, yn2);
    }
    apply(xs.tot[par][w], cy1, cy2);
  }
}

// The posterior of row i over the lane's window cells from its bM values
// (the rest of the band row holds the zeros stored first).
template <int C>
__device__ __forceinline__ void posterior_row(
    const float* __restrict__ frow, float* __restrict__ prow,
    const float (&bm)[C], int k0, int bb, int wd, float g) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = k0 + c;
    if (k < wd) {
      const float v = (frow[bb + k] * bm[c]) * g;
      prow[bb + k] = fminf(fmaxf(v, 0.f), 1.5f);
    }
  }
}

template <int C, int kThreads, bool kSmem>
__global__ void __launch_bounds__(kThreads)
pairhmm5_bwd_kernel(const float* __restrict__ fM,
                    const float* __restrict__ lsF,
                    const float* __restrict__ logZ,
                    const uint8_t* __restrict__ q,
                    const uint8_t* __restrict__ t_shift,
                    const int* __restrict__ m_len,
                    const int* __restrict__ n_len,
                    const int* __restrict__ lo,
                    const float* __restrict__ em, int M, int B, Trans tr,
                    float* scratch, float* __restrict__ post) {
  constexpr bool kMulti = kThreads > 32;
  constexpr int kW = kMulti ? kMaxWarps : 1;
  extern __shared__ float4 smem_f4[];
  __shared__ Slots<kW> xs;
  __shared__ float s_em[36];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nw = blockDim.x >> 5;
  const int cover = blockDim.x * C;
  const int RW = row_words(cover);
  // bM, bSX, bLX of the carried row; bSY and bLY of a row feed only its
  // rescale, so they are never stored
  float* sM = state_rows<kSmem>(smem_f4, scratch, 5, RW);
  float* sSX = sM + RW;
  float* sLX = sSX + RW;

  const int p = blockIdx.x;
  const int k0 = t * C;
  const int kw0 = warp * 32 * C;
  const int lo_p = lo[p];
  const int m = m_len[p];
  const int n = n_len[p];
  const uint8_t* qp = q + (size_t)p * M;
  const uint8_t* tp = t_shift + (size_t)p * (M + B);
  const float* fp = fM + (size_t)p * M * B;
  const float* lp = lsF + (size_t)p * M;
  float* pp = post + (size_t)p * M * B;
  const float lz = logZ[p];
  // backward chain matrix A^T = [[es, wsl], [wls, el]]
  const float At[4] = {tr.es, tr.wsl, tr.wls, tr.el};

  for (int k = t; k < 36; k += blockDim.x) s_em[k] = em[k];
  // rows past the pair's end have zero posterior (every row when m_len
  // is 0, or beyond the padded row count, where no terminal row exists)
  const bool live = m >= 1 && m <= M;
  // the whole band first (rows past m, and the cells outside each row's
  // window); the rows then store their windows
  zero_band(pp, M, B);
  if (!live) return;

  // terminal row i = m: only the Y-gap chains remain,
  // ty[k] = A^T ty[k+1] + (1, 1)[j == n], and bM = opens . ty[k+1]
  Window win = window(m, n, lo_p, B);
  float at_end[C];
  {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = k0 + c;
      at_end[c] = k < win.wd && win.jlo + k == n ? 1.f : 0.f;
    }
    const Aff ex = bwd_scan<C, kMulti>(at_end, at_end, At, xs, 0);
    if (kMulti) __syncthreads();
    float y1 = 0.f, y2 = 0.f, yn1, yn2;
    if (kMulti) bwd_carry(xs, 0, warp, nw, y1, y2, yn1, yn2);
    apply(ex, y1, y2);
#pragma unroll
    for (int c = C - 1; c >= 0; --c) {
      const int k = k0 + c;
      const bool okc = k < win.wd;
      const bool okr = k + 1 < win.wd;
      const float ce = at_end[c];
      const float bm = ce != 0.f ? 1.f
                       : (okc && okr ? tr.os * y1 + tr.ol * y2 : 0.f);
      const float n1 = (At[0] * y1 + At[1] * y2) + ce;
      const float n2 = (At[2] * y1 + At[3] * y2) + ce;
      y1 = n1;
      y2 = n2;
      const int kk = pix(k);
      sM[kk] = bm;
      sSX[kk] = ce;
      sLX[kk] = ce;
    }
  }
  __syncthreads();
  // the cells across the warp's edges, as stored: the next warp's first
  // bM and the previous warp's last bSX, bLX
  float nbR = 0.f, nbL[2] = {0.f, 0.f};
  if (kMulti && lane == 31 && warp + 1 < nw) nbR = sM[pix(k0 + C)];
  if (kMulti && lane == 0 && warp > 0) {
    nbL[0] = sSX[pix(k0 - 1)];
    nbL[1] = sLX[pix(k0 - 1)];
  }

  float ls = 0.f;
  float sp = 1.f;   // several warps: the scale of the carried row
  float isp = 1.f;  // its reciprocal
  float rMM[C], rSX[C], rLX[C];
  for (int i = m; i >= 2; --i) {
    const Window cur = win;   // row i, whose posterior this step forms
    const int bbi = cur.jlo - i - lo_p;
    __syncwarp();
    if (!kMulti) {
      // row i's posterior from the rescaled bM
      const float g = expf(fminf(fmaxf((lp[i - 1] + ls) - lz, -60.f), 60.f));
      float bm[C];
#pragma unroll
      for (int c = 0; c < C; ++c) bm[c] = sM[pix(k0 + c)];
      posterior_row<C>(fp + (size_t)(i - 1) * B, pp + (size_t)(i - 1) * B,
                       bm, k0, bbi, cur.wd, g);
    }
    win = window(i - 1, n, lo_p, B);
    const int delta = cur.jlo - win.jlo;
    const int par = (i - 1) & 1;
    const int bb = win.jlo - (i - 1) - lo_p;
    const float* erow = s_em + 6 * qp[i - 1];
    // pass 1: mm from bM at k + 1 - delta, sx and lx from bSX, bLX at
    // k - delta
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = k0 + c;
      const int mk = k + 1 - delta;
      float mmv;
      if (mk >= cover) {
        mmv = 0.f;
      } else if (kMulti && mk >= kw0 + 32 * C) {
        mmv = nbR;
      } else {
        mmv = sM[pix(mk)];
      }
      const int sk = k - delta;
      float sxv, lxv;
      if (sk < 0) {
        sxv = lxv = 0.f;
      } else if (kMulti && sk < kw0) {
        sxv = nbL[0];
        lxv = nbL[1];
      } else {
        sxv = sSX[pix(sk)];
        lxv = sLX[pix(sk)];
      }
      const bool okp = k < win.wd;
      const bool okm = okp && win.jlo + k + 1 <= n;
      rMM[c] = okm ? erow[tp[i - 1 + bb + k]] * mmv : 0.f;
      rSX[c] = okp ? sxv : 0.f;
      rLX[c] = okp ? lxv : 0.f;
    }
    float c1[C], c2[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      c1[c] = tr.ms * rMM[c];
      c2[c] = tr.ml * rMM[c];
    }
    const Aff ex = bwd_scan<C, kMulti>(c1, c2, At, xs, par);
    if (kMulti) {
      if (lane == 0) {
        xs.edge[par][warp][0] = rMM[0];
        xs.edge[par][warp][1] = rSX[0];
        xs.edge[par][warp][2] = rLX[0];
      }
      if (lane == 31) {
        const float mm = rMM[C - 1], sx = rSX[C - 1], lx = rLX[C - 1];
        xs.edge[par][warp][3] = (tr.ms * mm + tr.es * sx) + tr.wsl * lx;
        xs.edge[par][warp][4] = (tr.ml * mm + tr.el * lx) + tr.wls * sx;
      }
      __syncthreads();   // the row's one barrier
    } else {
      __syncwarp();
    }

    // pass 2 (descending): the chain from the exact carry, nM, masks, the
    // row maximum
    float y1 = 0.f, y2 = 0.f, yn1 = 0.f, yn2 = 0.f;
    if (kMulti) {
      bwd_carry(xs, par, warp, nw, y1, y2, yn1, yn2);
      if (i < m) {
        float mx = xs.max[par ^ 1][0];
        for (int w = 1; w < nw; ++w) mx = fmaxf(mx, xs.max[par ^ 1][w]);
        sp = fmaxf(mx, kTiny);
        isp = 1.f / sp;
        ls = ls + logf(sp);
      }
      // row i's posterior from its bM, rescaled
      const float g = expf(fminf(fmaxf((lp[i - 1] + ls) - lz, -60.f), 60.f));
      float bm[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        bm[c] = sM[pix(k0 + c)];
        if (i < m) bm[c] = bm[c] * isp;
      }
      posterior_row<C>(fp + (size_t)(i - 1) * B, pp + (size_t)(i - 1) * B,
                       bm, k0, bbi, cur.wd, g);
    }
    apply(ex, y1, y2);
    float lmax = 0.f;
#pragma unroll
    for (int c = C - 1; c >= 0; --c) {
      const int k = k0 + c;
      const float mm = rMM[c], sx = rSX[c], lx = rLX[c];
      const float r1 = y1, r2 = y2;   // the chain at k + 1 (unmasked)
      const float n1 = (At[0] * y1 + At[1] * y2) + c1[c];
      const float n2 = (At[2] * y1 + At[3] * y2) + c2[c];
      y1 = n1;
      y2 = n2;
      float nM = (tr.mc * mm + tr.os * (sx + r1)) + tr.ol * (lx + r2);
      float nSX = (tr.ms * mm + tr.es * sx) + tr.wsl * lx;
      float nLX = (tr.ml * mm + tr.el * lx) + tr.wls * sx;
      float nSY = n1, nLY = n2;
      if (!(k < win.wd)) {
        nM = nSX = nLX = nSY = nLY = 0.f;
      }
      if (kMulti && i < m) {
        nM = nM * isp;
        nSX = nSX * isp;
        nLX = nLX * isp;
        nSY = nSY * isp;
        nLY = nLY * isp;
      }
      lmax = fmaxf(lmax, (((nM + nSX) + nLX) + nSY) + nLY);
      rMM[c] = nM;
      rSX[c] = nSX;
      rLX[c] = nLX;
    }
    lmax = warp_max(lmax);
    if (kMulti) {
      // the row as it stands, before its rescale; its maximum and the
      // cells across the warp's edges for the next row
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int kk = pix(k0 + c);
        sM[kk] = rMM[c];
        sSX[kk] = rSX[c];
        sLX[kk] = rLX[c];
      }
      if (lane == 0) xs.max[par][warp] = lmax;
      if (lane == 31 && warp + 1 < nw) {
        // the next warp's first bM, from its pass-1 values and the chain
        // at its second cell
        const int x = k0 + C;
        const float mm = xs.edge[par][warp + 1][0];
        const float sx = xs.edge[par][warp + 1][1];
        const float lx = xs.edge[par][warp + 1][2];
        nbR = x < win.wd
                  ? (tr.mc * mm + tr.os * (sx + yn1)) + tr.ol * (lx + yn2)
                  : 0.f;
        if (i < m) nbR = nbR * isp;
      }
      if (lane == 0 && warp > 0) {
        nbL[0] = xs.edge[par][warp - 1][3];
        nbL[1] = xs.edge[par][warp - 1][4];
        if (i < m) {
          nbL[0] = nbL[0] * isp;
          nbL[1] = nbL[1] * isp;
        }
      }
    } else {
      const float s = fmaxf(lmax, kTiny);
      const float is = 1.f / s;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int kk = pix(k0 + c);
        sM[kk] = rMM[c] * is;
        sSX[kk] = rSX[c] * is;
        sLX[kk] = rLX[c] * is;
      }
      ls = ls + logf(s);
    }
  }
  // row 1's posterior (row m's when m is 1)
  if (kMulti) {
    __syncthreads();
    if (m >= 2) {
      float mx = xs.max[1][0];
      for (int w = 1; w < nw; ++w) mx = fmaxf(mx, xs.max[1][w]);
      sp = fmaxf(mx, kTiny);
      isp = 1.f / sp;
      ls = ls + logf(sp);
    }
  } else {
    __syncwarp();
  }
  const float g = expf(fminf(fmaxf((lp[0] + ls) - lz, -60.f), 60.f));
  float bm[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    bm[c] = sM[pix(k0 + c)];
    if (kMulti && m >= 2) bm[c] = bm[c] * isp;
  }
  posterior_row<C>(fp, pp, bm, k0, win.jlo - 1 - lo_p, win.wd, g);
}

// ------------------------------------------------------------ wide rows

// The wide kernels take a launch whose widest live row passes kMaxCells:
// one block of kWideThreads threads a pair, each thread a contiguous run
// of B / kWideThreads cells of every row's whole band (masked to the
// contract's zeros outside the live window), the state rows in a
// per-pair global scratch row (pairhmm5_wide_scratch_floats), three
// passes a row with a block scan of the chain maps and a block maximum
// between them, and every row rescaled by division as the plain version
// does.  They are the full-band kernels of the port's first design.
__global__ void __launch_bounds__(kWideThreads)
pairhmm5_fwd_wide_kernel(const uint8_t* __restrict__ q,
                    const uint8_t* __restrict__ t_shift,
                    const int* __restrict__ m_len,
                    const int* __restrict__ n_len,
                    const int* __restrict__ lo,
                    const float* __restrict__ em, int M, int B, Trans tr,
                    float* scratch, float* __restrict__ fM_out,
                    float* __restrict__ lsF_out,
                    float* __restrict__ logZ_out) {
  __shared__ Aff aff_buf[32];
  __shared__ float max_buf[33];
  __shared__ float s_em[36];
  __shared__ float s_end;
  const int W = row_words(B);
  float* sM = scratch + (size_t)blockIdx.x * 5 * W;
  float* sSX = sM + W;
  float* sLX = sSX + W;
  float* sSY = sLX + W;
  float* sLY = sSY + W;

  const int p = blockIdx.x;
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int C = (B + T - 1) / T;
  const int b0 = min(t * C, B);
  const int b1 = min(b0 + C, B);
  const int lo_p = lo[p];
  const int m = m_len[p];
  const int n = n_len[p];
  const int b_end = n - m - lo_p;
  const int end_row = m > 1 ? m : 1;
  const uint8_t* qp = q + (size_t)p * M;
  const uint8_t* tp = t_shift + (size_t)p * (M + B);
  float* fp = fM_out + (size_t)p * M * B;
  // forward chain matrix A = [[es, wls], [wsl, el]]
  const float a11 = tr.es, a12 = tr.wls, a21 = tr.wsl, a22 = tr.el;
  const float A[4] = {a11, a12, a21, a22};

  for (int k = t; k < 36; k += T) s_em[k] = em[k];
  if (t == 0) s_end = 0.f;
  // row 0: M at j == 0; the SY/LY chains seeded by that M cell
  for (int b = b0; b < b1; ++b) {
    sM[pix(b)] = lo_p + b == 0 ? 1.f : 0.f;
    sSX[pix(b)] = 0.f;
    sLX[pix(b)] = 0.f;
  }
  __syncthreads();
  {
    Aff a = aff_identity();
    for (int b = b0; b < b1; ++b) {
      const int j0 = lo_p + b;
      const bool ok = j0 >= 1 && j0 <= n;
      const float prev = b > 0 ? sM[pix(b - 1)] : 0.f;
      a = push_cell(a, A, ok ? tr.os * prev : 0.f,
                    ok ? tr.ol * prev : 0.f);
    }
    const float2 y0 = block_chain_carry<false>(a, aff_buf);
    float y1 = y0.x, y2 = y0.y;
    for (int b = b0; b < b1; ++b) {
      const int j0 = lo_p + b;
      const bool ok = j0 >= 1 && j0 <= n;
      const float prev = b > 0 ? sM[pix(b - 1)] : 0.f;
      const float c1 = ok ? tr.os * prev : 0.f;
      const float c2 = ok ? tr.ol * prev : 0.f;
      const float n1 = (a11 * y1 + a12 * y2) + c1;
      const float n2 = (a21 * y1 + a22 * y2) + c2;
      y1 = n1;
      y2 = n2;
      sSY[pix(b)] = ok ? y1 : 0.f;
      sLY[pix(b)] = ok ? y2 : 0.f;
    }
  }
  float ls = 0.f;
  __syncthreads();

  const bool vec_ok = (B % 4) == 0;
  for (int i = 1; i <= M; ++i) {
    float* frow = fp + (size_t)(i - 1) * B;
    if (i > m) {
      // past the pair's end every state is masked to exactly 0 and the
      // row scale is TINY
      if (vec_ok) {
        float4* dst = reinterpret_cast<float4*>(frow);
        for (int k = t; k < B / 4; k += T) dst[k] = make_float4(0, 0, 0, 0);
      } else {
        for (int k = t; k < B; k += T) frow[k] = 0.f;
      }
      ls = ls + logf(kTiny);
      if (t == 0) {
        lsF_out[(size_t)p * M + i - 1] = ls;
        if (i == end_row) logZ_out[p] = logf(kTiny) + ls;
      }
      continue;
    }
    const float* erow = s_em + 6 * qp[i - 1];
    // the right neighbour's first cell of the previous row, read before
    // that thread overwrites it
    float nbM = 0.f, nbSX = 0.f, nbLX = 0.f;
    if (b1 < B && b0 < b1) {
      nbM = sM[pix(b1)];
      nbSX = sSX[pix(b1)];
      nbLX = sLX[pix(b1)];
    }
    __syncthreads();

    // pass 1: mM, mSX, mLX from the previous row (cell b and b + 1)
    for (int b = b0; b < b1; ++b) {
      const float fm = sM[pix(b)], fsx = sSX[pix(b)], flx = sLX[pix(b)];
      const float fsy = sSY[pix(b)], fly = sLY[pix(b)];
      const bool last = b + 1 >= b1;
      const float fmu = last ? nbM : sM[pix(b + 1)];
      const float fsxu = last ? nbSX : sSX[pix(b + 1)];
      const float flxu = last ? nbLX : sLX[pix(b + 1)];
      const float emit = erow[tp[i - 1 + b]];
      const int j = i + lo_p + b;
      float mM = emit * ((tr.mc * fm + tr.ms * (fsx + fsy)) +
                         tr.ml * (flx + fly));
      if (!(j >= 1 && j <= n)) mM = 0.f;
      float mSX = (tr.os * fmu + tr.es * fsxu) + tr.wls * flxu;
      float mLX = (tr.ol * fmu + tr.el * flxu) + tr.wsl * fsxu;
      if (!(j >= 0 && j <= n)) {
        mSX = 0.f;
        mLX = 0.f;
      }
      sM[pix(b)] = mM;
      sSX[pix(b)] = mSX;
      sLX[pix(b)] = mLX;
    }
    __syncthreads();

    // compose this thread's chain maps y -> A y + ok*(os, ol)*mM[b-1]
    Aff a = aff_identity();
    for (int b = b0; b < b1; ++b) {
      const int j = i + lo_p + b;
      const bool ok = j >= 1 && j <= n;
      const float prev = b > 0 ? sM[pix(b - 1)] : 0.f;
      a = push_cell(a, A, ok ? tr.os * prev : 0.f,
                    ok ? tr.ol * prev : 0.f);
    }
    const float2 carry = block_chain_carry<false>(a, aff_buf);

    // pass 2: replay the chain from the exact carry; the band maximum
    float y1 = carry.x, y2 = carry.y;
    float lmax = -INFINITY;
    for (int b = b0; b < b1; ++b) {
      const int j = i + lo_p + b;
      const bool ok = j >= 1 && j <= n;
      const float prev = b > 0 ? sM[pix(b - 1)] : 0.f;
      const float c1 = ok ? tr.os * prev : 0.f;
      const float c2 = ok ? tr.ol * prev : 0.f;
      const float n1 = (a11 * y1 + a12 * y2) + c1;
      const float n2 = (a21 * y1 + a22 * y2) + c2;
      y1 = n1;
      y2 = n2;
      const float mSY = ok ? y1 : 0.f;
      const float mLY = ok ? y2 : 0.f;
      sSY[pix(b)] = mSY;
      sLY[pix(b)] = mLY;
      lmax = fmaxf(lmax, (((sM[pix(b)] + sSX[pix(b)]) + sLX[pix(b)]) + mSY) +
                             mLY);
    }
    const float scale = fmaxf(block_max(lmax, max_buf), kTiny);

    // pass 3: rescale
    for (int b = b0; b < b1; ++b) {
      const int k = pix(b);
      const float nM = sM[k] / scale;
      const float nSX = sSX[k] / scale;
      const float nLX = sLX[k] / scale;
      const float nSY = sSY[k] / scale;
      const float nLY = sLY[k] / scale;
      sM[k] = nM;
      sSX[k] = nSX;
      sLX[k] = nLX;
      sSY[k] = nSY;
      sLY[k] = nLY;
      if (i == end_row && b == b_end)
        s_end = nM + (((nSX + nLX) + nSY) + nLY);
    }
    ls = ls + logf(scale);
    __syncthreads();
    for (int k = t; k < B; k += T) frow[k] = sM[pix(k)];
    if (t == 0) {
      lsF_out[(size_t)p * M + i - 1] = ls;
      if (i == end_row) logZ_out[p] = logf(fmaxf(s_end, kTiny)) + ls;
    }
  }
  if (M < end_row && t == 0) logZ_out[p] = logf(kTiny) + ls;
}

__global__ void __launch_bounds__(kWideThreads)
pairhmm5_bwd_wide_kernel(const float* __restrict__ fM,
                    const float* __restrict__ lsF,
                    const float* __restrict__ logZ,
                    const uint8_t* __restrict__ q,
                    const uint8_t* __restrict__ t_shift,
                    const int* __restrict__ m_len,
                    const int* __restrict__ n_len,
                    const int* __restrict__ lo,
                    const float* __restrict__ em, int M, int B, Trans tr,
                    float* scratch, float* __restrict__ post) {
  __shared__ Aff aff_buf[32];
  __shared__ float max_buf[33];
  __shared__ float s_em[36];
  const int W = row_words(B);
  // bM, bSX, bLX of the carried row; sx and lx (bSX, bLX of the cell to
  // the left, masked) between the two passes of a row.  bSY and bLY of a
  // row feed only its rescale, so they are never stored.
  float* sM = scratch + (size_t)blockIdx.x * 5 * W;
  float* sSX = sM + W;
  float* sLX = sSX + W;
  float* sTX = sLX + W;
  float* sTL = sTX + W;

  const int p = blockIdx.x;
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int C = (B + T - 1) / T;
  const int b0 = min(t * C, B);
  const int b1 = min(b0 + C, B);
  const int lo_p = lo[p];
  const int m = m_len[p];
  const int n = n_len[p];
  const uint8_t* qp = q + (size_t)p * M;
  const uint8_t* tp = t_shift + (size_t)p * (M + B);
  const float* fp = fM + (size_t)p * M * B;
  float* pp = post + (size_t)p * M * B;
  const float lz = logZ[p];
  // backward chain matrix A^T = [[es, wsl], [wls, el]]
  const float a11 = tr.es, a12 = tr.wsl, a21 = tr.wls, a22 = tr.el;
  const float A[4] = {a11, a12, a21, a22};

  for (int k = t; k < 36; k += T) s_em[k] = em[k];
  // rows past the pair's end have zero posterior (every row when m_len
  // is 0, or beyond the padded row count, where no terminal row exists)
  const bool live = m >= 1 && m <= M;
  for (size_t k = (size_t)(live ? m : 0) * B + t; k < (size_t)M * B; k += T)
    pp[k] = 0.f;
  if (!live) return;

  // terminal row i = m: only the Y-gap chains remain,
  // ty[b] = A^T ty[b+1] + (1, 1)[j == n], and bM = opens . ty[b+1]
  {
    Aff a = aff_identity();
    for (int b = b1 - 1; b >= b0; --b) {
      const float c = n - (m + lo_p + b) == 0 ? 1.f : 0.f;
      a = push_cell(a, A, c, c);
    }
    const float2 carry = block_chain_carry<true>(a, aff_buf);
    // ty of the cell to the right, masked (sl of the masked chain)
    float r1 = 0.f, r2 = 0.f;
    if (b1 < B) {
      const int j1 = m + lo_p + b1;
      if (n - j1 >= 0 && j1 >= 0) {
        r1 = carry.x;
        r2 = carry.y;
      }
    }
    float y1 = carry.x, y2 = carry.y;
    for (int b = b1 - 1; b >= b0; --b) {
      const int j = m + lo_p + b;
      const int jn = n - j;
      const bool at_end = jn == 0;
      const bool okc = jn >= 0 && j >= 0;
      const float c = at_end ? 1.f : 0.f;
      const float n1 = (a11 * y1 + a12 * y2) + c;
      const float n2 = (a21 * y1 + a22 * y2) + c;
      y1 = n1;
      y2 = n2;
      sM[pix(b)] = at_end ? 1.f : (okc ? tr.os * r1 + tr.ol * r2 : 0.f);
      sSX[pix(b)] = c;
      sLX[pix(b)] = c;
      r1 = okc ? y1 : 0.f;
      r2 = okc ? y2 : 0.f;
    }
  }
  float ls = 0.f;
  __syncthreads();

  for (int i = m; i >= 1; --i) {
    // posterior of row i from fM, the current bM and the log-scales
    {
      const float g = expf(fminf(fmaxf((lsF[(size_t)p * M + i - 1] + ls) - lz,
                                       -60.f), 60.f));
      const float* frow = fp + (size_t)(i - 1) * B;
      float* prow = pp + (size_t)(i - 1) * B;
      for (int k = t; k < B; k += T) {
        const float v = (frow[k] * sM[pix(k)]) * g;
        prow[k] = fminf(fmaxf(v, 0.f), 1.5f);
      }
    }
    if (i == 1) break;
    const float* erow = s_em + 6 * qp[i - 1];
    // the left neighbour's last cell, read before that thread overwrites it
    float nbSX = 0.f, nbLX = 0.f;
    if (b0 > 0 && b0 < b1) {
      nbSX = sSX[pix(b0 - 1)];
      nbLX = sLX[pix(b0 - 1)];
    }
    __syncthreads();

    // pass 1 (descending): mm, sx, lx, nSX, nLX; compose the reverse chain
    // maps y -> A^T y + (ms, ml) * mm
    Aff a = aff_identity();
    for (int b = b1 - 1; b >= b0; --b) {
      const int jprev = i - 1 + lo_p + b;
      float mm = erow[tp[i - 1 + b]] * sM[pix(b)];
      if (!(jprev + 1 <= n)) mm = 0.f;
      const bool first = b <= b0;
      float sx = first ? nbSX : sSX[pix(b - 1)];
      float lx = first ? nbLX : sLX[pix(b - 1)];
      if (!(jprev >= 0 && jprev <= n)) {
        sx = 0.f;
        lx = 0.f;
      }
      sM[pix(b)] = mm;
      sSX[pix(b)] = (tr.ms * mm + tr.es * sx) + tr.wsl * lx;
      sLX[pix(b)] = (tr.ml * mm + tr.el * lx) + tr.wls * sx;
      sTX[pix(b)] = sx;
      sTL[pix(b)] = lx;
      a = push_cell(a, A, tr.ms * mm, tr.ml * mm);
    }
    // y at b1 = composite of every later cell's map applied to y[B] = 0
    const float2 carry = block_chain_carry<true>(a, aff_buf);

    // pass 2 (descending): the chain, nM, masks, band maximum
    float y1 = carry.x, y2 = carry.y;   // the chain at b + 1 (unmasked)
    float lmax = -INFINITY;
    for (int b = b1 - 1; b >= b0; --b) {
      const int jprev = i - 1 + lo_p + b;
      const int k = pix(b);
      const float mm = sM[k], sx = sTX[k], lx = sTL[k];
      const float c1 = tr.ms * mm, c2 = tr.ml * mm;
      const float n1 = (a11 * y1 + a12 * y2) + c1;
      const float n2 = (a21 * y1 + a22 * y2) + c2;
      float nM = (tr.mc * mm + tr.os * (sx + y1)) + tr.ol * (lx + y2);
      float nSX = sSX[k], nLX = sLX[k], nSY = n1, nLY = n2;
      if (!(jprev >= 0 && jprev <= n)) {
        nM = 0.f;
        nSX = 0.f;
        nLX = 0.f;
        nSY = 0.f;
        nLY = 0.f;
      }
      lmax = fmaxf(lmax, (((nM + nSX) + nLX) + nSY) + nLY);
      sM[k] = nM;
      sSX[k] = nSX;
      sLX[k] = nLX;
      y1 = n1;
      y2 = n2;
    }
    const float scale = fmaxf(block_max(lmax, max_buf), kTiny);
    for (int b = b0; b < b1; ++b) {
      const int k = pix(b);
      sM[k] = sM[k] / scale;
      sSX[k] = sSX[k] / scale;
      sLX[k] = sLX[k] / scale;
    }
    ls = ls + logf(scale);
    __syncthreads();
  }
}

// Cells a lane and threads a block for the launch's widest live row W:
// one warp of 4 cells a lane up to W = 128, else the fewest cells a lane
// of 4, 8, 16 and 64 with which 32 warps cover W, in ceil(W / 32 C)
// warps.  Measured on the H100 (tests/pairhmm_sweep_report.py --model 5):
// 4 cells a lane in more warps beat 8 and 16 in fewer, and one warp of 16
// (W up to 512), at every sweep shape but the band-2048 and band-4096
// forward passes, where 8 cells were 6% faster and the backward passes 13%
// and 3% slower.
void launch_shape(int W, int* C, int* threads) {
  int c = 4;
  while (32 * kMaxWarps * c < W) c = c < 16 ? 2 * c : 64;
  *C = c;
  *threads = 32 * ((W + 32 * c - 1) / (32 * c));
}

// Whether a launch for max_live W keeps its state rows in shared memory
// (else in global scratch).
bool state_in_smem(int W) {
  int C, threads;
  launch_shape(W, &C, &threads);
  return threads * C <= kSmemMaxCells;
}

// Above 48 KB a kernel's dynamic shared memory must be allowed first: once
// per kernel and size, not every launch.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, size_t* allowed) {
  if (smem <= *allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) *allowed = smem;
  return err;
}

struct Args {
  const uint8_t* q;
  const uint8_t* t;
  const int* m;
  const int* n;
  const int* lo;
  const float* em;
  int P, M, B;
  Trans tr;
  float* scratch;
  cudaStream_t stream;
};

template <int C, int kThreads, bool kSmem>
cudaError_t fwd_launch(const Args& a, int threads, float* fM, float* lsF,
                       float* logZ) {
  static size_t allowed = 48 * 1024;
  const size_t smem = kSmem ? 5 * (size_t)row_words(threads * C) * 4 : 0;
  const cudaError_t err =
      allow_smem(pairhmm5_fwd_kernel<C, kThreads, kSmem>, smem, &allowed);
  if (err != cudaSuccess) return err;
  if (!kSmem && a.scratch == nullptr) return cudaErrorInvalidValue;
  pairhmm5_fwd_kernel<C, kThreads, kSmem><<<a.P, threads, smem, a.stream>>>(
      a.q, a.t, a.m, a.n, a.lo, a.em, a.M, a.B, a.tr, a.scratch, fM, lsF,
      logZ);
  return cudaGetLastError();
}

template <int C, int kThreads, bool kSmem>
cudaError_t bwd_launch(const Args& a, int threads, const float* fM,
                       const float* lsF, const float* logZ, float* post) {
  static size_t allowed = 48 * 1024;
  const size_t smem = kSmem ? 3 * (size_t)row_words(threads * C) * 4 : 0;
  const cudaError_t err =
      allow_smem(pairhmm5_bwd_kernel<C, kThreads, kSmem>, smem, &allowed);
  if (err != cudaSuccess) return err;
  if (!kSmem && a.scratch == nullptr) return cudaErrorInvalidValue;
  pairhmm5_bwd_kernel<C, kThreads, kSmem><<<a.P, threads, smem, a.stream>>>(
      fM, lsF, logZ, a.q, a.t, a.m, a.n, a.lo, a.em, a.M, a.B, a.tr,
      a.scratch, post);
  return cudaGetLastError();
}

// The instance of FN<C, bound, smem> for max_live W: one warp of 4 cells
// a lane; up to 16 warps of 4 (the 128 registers of a 512-thread bound);
// up to 32 warps of 4 or 8 with shared-memory rows; 16 or 64 cells a lane
// with global scratch rows.
#define PAIRHMM5_DISPATCH(FN, W, ...)                                      \
  do {                                                                     \
    int C_, threads_;                                                      \
    launch_shape(W, &C_, &threads_);                                       \
    switch (C_) {                                                          \
      case 4:                                                              \
        if (threads_ == 32)                                                \
          return (int)FN<4, 32, true>(a, threads_, __VA_ARGS__);           \
        if (threads_ <= 512)                                               \
          return (int)FN<4, 512, true>(a, threads_, __VA_ARGS__);          \
        return (int)FN<4, 1024, true>(a, threads_, __VA_ARGS__);           \
      case 8: return (int)FN<8, 1024, true>(a, threads_, __VA_ARGS__);     \
      case 16: return (int)FN<16, 1024, false>(a, threads_, __VA_ARGS__);  \
      case 64: return (int)FN<64, 1024, false>(a, threads_, __VA_ARGS__);  \
    }                                                                      \
    return (int)cudaErrorInvalidValue;                                     \
  } while (0)

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// float32 words of global scratch a wide launch needs per pair of band B
int pairhmm5_wide_scratch_floats(int B) { return 5 * row_words(B); }

// float32 words of global scratch a launch needs per pair for max_live W
// (0 when the state rows fit shared memory)
int pairhmm5_scratch_floats(int W) {
  int C, threads;
  launch_shape(W, &C, &threads);
  return state_in_smem(W) ? 0 : 5 * row_words(threads * C);
}

// threads a block for max_live W
int pairhmm5_threads(int W) {
  int C, threads;
  launch_shape(W, &C, &threads);
  return threads;
}

// window cells a lane for max_live W
int pairhmm5_cells_per_lane(int W) {
  int C, threads;
  launch_shape(W, &C, &threads);
  return C;
}

int pairhmm5_fwd_launch(const void* q, const void* t_shift, const void* m_len,
                        const void* n_len, const void* lo, const void* em,
                        int P, int M, int B, int W, float mc, float os,
                        float ol, float es, float el, float wsl, float wls,
                        float ms, float ml, void* scratch, void* fM,
                        void* lsF, void* logZ, void* stream) {
  if (P <= 0) return 0;
  if (W < 1 || W > B || W > kMaxCells) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const uint8_t*>(q),
               static_cast<const uint8_t*>(t_shift),
               static_cast<const int*>(m_len), static_cast<const int*>(n_len),
               static_cast<const int*>(lo), static_cast<const float*>(em),
               P, M, B, Trans{mc, os, ol, es, el, wsl, wls, ms, ml},
               static_cast<float*>(scratch),
               static_cast<cudaStream_t>(stream)};
  PAIRHMM5_DISPATCH(fwd_launch, W, static_cast<float*>(fM),
                    static_cast<float*>(lsF), static_cast<float*>(logZ));
}

int pairhmm5_bwd_launch(const void* fM, const void* lsF, const void* logZ,
                        const void* q, const void* t_shift, const void* m_len,
                        const void* n_len, const void* lo, const void* em,
                        int P, int M, int B, int W, float mc, float os,
                        float ol, float es, float el, float wsl, float wls,
                        float ms, float ml, void* scratch, void* post,
                        void* stream) {
  if (P <= 0) return 0;
  if (W < 1 || W > B || W > kMaxCells) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const uint8_t*>(q),
               static_cast<const uint8_t*>(t_shift),
               static_cast<const int*>(m_len), static_cast<const int*>(n_len),
               static_cast<const int*>(lo), static_cast<const float*>(em),
               P, M, B, Trans{mc, os, ol, es, el, wsl, wls, ms, ml},
               static_cast<float*>(scratch),
               static_cast<cudaStream_t>(stream)};
  PAIRHMM5_DISPATCH(bwd_launch, W, static_cast<const float*>(fM),
                    static_cast<const float*>(lsF),
                    static_cast<const float*>(logZ),
                    static_cast<float*>(post));
}

// The wide route (max_live past kMaxCells): full-band kernels with the
// state rows in `scratch`, pairhmm5_wide_scratch_floats(B) words a pair.
int pairhmm5_fwd_wide_launch(const void* q, const void* t_shift,
                             const void* m_len, const void* n_len,
                             const void* lo, const void* em, int P, int M,
                             int B, float mc, float os, float ol, float es,
                             float el, float wsl, float wls, float ms,
                             float ml, void* scratch, void* fM, void* lsF,
                             void* logZ, void* stream) {
  if (P <= 0) return 0;
  if (B < 1 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  pairhmm5_fwd_wide_kernel<<<P, kWideThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(t_shift),
      static_cast<const int*>(m_len), static_cast<const int*>(n_len),
      static_cast<const int*>(lo), static_cast<const float*>(em), M, B,
      Trans{mc, os, ol, es, el, wsl, wls, ms, ml},
      static_cast<float*>(scratch), static_cast<float*>(fM),
      static_cast<float*>(lsF), static_cast<float*>(logZ));
  return (int)cudaGetLastError();
}

int pairhmm5_bwd_wide_launch(const void* fM, const void* lsF,
                             const void* logZ, const void* q,
                             const void* t_shift, const void* m_len,
                             const void* n_len, const void* lo,
                             const void* em, int P, int M, int B, float mc,
                             float os, float ol, float es, float el,
                             float wsl, float wls, float ms, float ml,
                             void* scratch, void* post, void* stream) {
  if (P <= 0) return 0;
  if (B < 1 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  pairhmm5_bwd_wide_kernel<<<P, kWideThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fM), static_cast<const float*>(lsF),
      static_cast<const float*>(logZ), static_cast<const uint8_t*>(q),
      static_cast<const uint8_t*>(t_shift), static_cast<const int*>(m_len),
      static_cast<const int*>(n_len), static_cast<const int*>(lo),
      static_cast<const float*>(em), M, B,
      Trans{mc, os, ol, es, el, wsl, wls, ms, ml},
      static_cast<float*>(scratch), static_cast<float*>(post));
  return (int)cudaGetLastError();
}

}  // extern "C"
