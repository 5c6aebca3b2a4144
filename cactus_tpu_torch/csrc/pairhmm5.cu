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
// of 64 cells a lane, past which a lane's cells no longer fit its
// registers) takes the wide route (ops/pairhmm5_cuda.py::pairhmm5_route):
// pairhmm5_fwd_cluster_kernel and pairhmm5_bwd_cluster_kernel, the same
// two Pallas kernels' counterparts for rows wider than one SM holds.  What
// bounds them is the same chain of rows; a row costs the cells each SM
// computes (~75 instructions a cell) plus a fixed exchange.  So a pair's
// row is spread over a thread-block cluster of up to 16 CTAs on
// neighbouring SMs (non-portable past 8), whose shared memories are
// readable by each other (distributed shared memory):
//  - One cluster a pair, on the live window only: cluster lane L = rank T
//    + t owns window cells k = L C .. L C + C - 1 (cluster_shape: 8 cells a
//    lane in the fewest warps that cover max_live, over as many CTAs as
//    there are warps, up to 16).  The card must schedule the cluster
//    (cudaOccupancyMaxActiveClusters, asked once a shape), or the launch
//    returns an error.
//  - The previous row's states in each CTA's own shared memory (its
//    window cells in order, one pad word in 33, as the narrow kernels),
//    up to 16 x 1024 x 8 = 131,072 cells; past that the same kernel
//    (kSmem false) keeps them, and the lanes' own cells, in the pair's
//    global scratch at c lanes + L (neighbouring lanes, neighbouring
//    words) with ceil(max_live / 16384) cells a lane, so no width is
//    refused.  A warp stores its rows' cells (fM forward, the posterior
//    backward) in order, 32 neighbouring cells a store, read back from
//    the state row (a lane's own C cells a store, 8 sectors apart, took
//    a third of a row's time on an H100 80GB HBM3 at 700 W,
//    tests/pairhmm5_cluster_report.py).
//  - The narrow kernels' multi-warp schedule, lifted to the cluster: each
//    warp scans its lanes' 2x2 chain maps by shuffles and publishes its
//    maps and edge cells; after the block barrier warp 0 scans the warps'
//    maps (one shuffle scan: each warp's carry map and the map to its
//    neighbour cell) and pushes the CTA's aggregate maps, its maximum of
//    the row before and its edge cells into the rings of the CTAs that
//    read them (DSMEM stores, double-buffered by row parity); after the
//    row's one cluster barrier warp 0 walks the maps in its own ring into
//    the carry entering its CTA, and a block barrier hands it to the
//    warps, which replay their cells from the exact carry.  Nothing is
//    loaded remotely: every push lands before the barrier.  The row
//    maximum is deferred a row, as in the narrow kernels, and the cells
//    across a CTA edge (forward: M, SX, LX of the first and last cells
//    and the previous CTA's last SY, LY from its map; backward: the next
//    CTA's first bM, formed from its pass-1 values and its map without
//    its first cell) travel in the rings.  Rescales multiply by the
//    reciprocal.
//  - The (M, B) output is zeroed once over the cluster's lanes, and the
//    backward pass forms the posterior in its row loop.
// tests/test_torch_pairhmm5_live.py models this schedule too (ncta).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kTiny = 1e-30f;   // pairhmm5.py TINY
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;
// the widest cover (lanes x cells) whose state rows live in shared memory
constexpr int kSmemMaxCells = 8192;
// the widest live row a narrow launch takes (32 warps of 64 cells a
// lane); wider launches take the cluster kernels
constexpr int kMaxCells = 32 * kMaxWarps * 64;

struct Trans {
  float mc, os, ol, es, el, wsl, wls, ms, ml;
};

// The recurrences of one cell, shared by every kernel here (the plain
// version's forward_banded5 and backward_posterior5, term for term).
// Forward, row i from row i - 1: mM from the cell at j - 1, mSX and mLX
// from the cell at j ("u": the row above).
__device__ __forceinline__ float fwd_m(const Trans& tr, float emit, float fm,
                                       float fsx, float flx, float fsy,
                                       float fly) {
  return emit * ((tr.mc * fm + tr.ms * (fsx + fsy)) + tr.ml * (flx + fly));
}

__device__ __forceinline__ float fwd_sx(const Trans& tr, float fmu,
                                        float fsxu, float flxu) {
  return (tr.os * fmu + tr.es * fsxu) + tr.wls * flxu;
}

__device__ __forceinline__ float fwd_lx(const Trans& tr, float fmu,
                                        float fsxu, float flxu) {
  return (tr.ol * fmu + tr.el * flxu) + tr.wsl * fsxu;
}

// Backward, row i - 1 from row i: mm = emit * bM at j + 1, sx and lx the
// bSX, bLX at j, r the SY/LY chain at j + 1.
__device__ __forceinline__ float bwd_m(const Trans& tr, float mm, float sx,
                                       float lx, float r1, float r2) {
  return (tr.mc * mm + tr.os * (sx + r1)) + tr.ol * (lx + r2);
}

__device__ __forceinline__ float bwd_sx(const Trans& tr, float mm, float sx,
                                        float lx) {
  return (tr.ms * mm + tr.es * sx) + tr.wsl * lx;
}

__device__ __forceinline__ float bwd_lx(const Trans& tr, float mm, float sx,
                                        float lx) {
  return (tr.ml * mm + tr.el * lx) + tr.wls * sx;
}

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

// Zeros over `cells` floats from base, coalesced: thread `first` of
// `step` threads.
__device__ void zero_cells(float* base, size_t cells, int first, int step) {
  if ((cells & 3) == 0 && (reinterpret_cast<uintptr_t>(base) & 15) == 0) {
    float4* p4 = reinterpret_cast<float4*>(base);
    for (size_t k = first; k < cells / 4; k += step)
      p4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (size_t k = first; k < cells; k += step) base[k] = 0.f;
  }
}

// Zeros over a pair's (M, B) band, by the block.
__device__ void zero_band(float* base, int M, int B) {
  zero_cells(base, (size_t)M * B, threadIdx.x, blockDim.x);
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
      rM[c] = ok ? fwd_m(tr, emit, fm, fsx, flx, fsy, fly) : 0.f;
      rSX[c] = okx ? fwd_sx(tr, fmu, fsxu, flxu) : 0.f;
      rLX[c] = okx ? fwd_lx(tr, fmu, fsxu, flxu) : 0.f;
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
        xs.edge[par][warp][3] = bwd_sx(tr, mm, sx, lx);
        xs.edge[par][warp][4] = bwd_lx(tr, mm, sx, lx);
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
      float nM = bwd_m(tr, mm, sx, lx, r1, r2);
      float nSX = bwd_sx(tr, mm, sx, lx);
      float nLX = bwd_lx(tr, mm, sx, lx);
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
        nbR = x < win.wd ? bwd_m(tr, mm, sx, lx, yn1, yn2) : 0.f;
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

// --------------------------------------------------------- cluster rows

// The cluster kernels take a launch whose widest live row passes
// kMaxCells (the header sets out the design): one thread-block cluster a
// pair, up to kClusterMax CTAs of up to kClusterThreads threads.
constexpr int kClusterMax = 16;        // CTAs a cluster (non-portable past 8)
constexpr int kClusterThreads = 1024;
constexpr int kClusterCells = 8;       // cells a lane, rows in shared memory
// rows of CTAs x threads x cells words a pair's global scratch holds (the
// state rows, then the lanes' own cells): five and five forward, three
// and three backward
constexpr int kClusterFwdRows = 10;
constexpr int kClusterBwdRows = 6;

// What the other CTAs of a pair's cluster push into this CTA's shared
// memory for a row, double-buffered by row parity.
struct Ring {
  Aff agg[2][kClusterMax];     // fwd: each earlier CTA's map followed by
                               // its next CTA's first cell; bwd: each
                               // later CTA's whole map
  Aff near[2];                 // fwd: the previous CTA's map to its last
                               // cell; bwd: the next CTA's map without its
                               // first cell
  float max[2][kClusterMax];   // every CTA's maximum of the row before
  float lo[2][3];              // the next CTA's first cell
  float hi[2][3];              // the previous CTA's last cell
};

struct ClusterSmem {
  Slots<kMaxWarps> xs;         // the exchange between this CTA's warps
  Aff pre[kMaxWarps];          // the CTA's warps before (fwd) or after
                               // (bwd) warp w, composed
  Aff near[kMaxWarps];         // fwd: the map to warp w's last cell; bwd:
                               // to its second cell
  Aff mine[2];                 // the CTA's own two maps, for the push
  Ring ring;
  float carry[5];              // the chain entering the CTA (2), at the
                               // previous CTA's last cell (fwd) or the
                               // next CTA's second cell (bwd) (2), and the
                               // cluster's maximum of the row before
  float em[36];
  float end;
};

// Warp 0, after the block barrier: composes the CTA's warps' maps (fwd:
// each warp's tot2 from the left; bwd: each warp's tot from the right)
// into each warp's exclusive map s.pre[w] and its near map s.near[w], and
// pushes the CTA's own maps and edge cells into the rings of the CTAs
// that read them.
template <bool kBwd>
__device__ void cta_publish(ClusterSmem& s, int par, int nw) {
  cg::cluster_group cl = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  const int rank = (int)cl.block_rank();
  const int ctas = (int)cl.num_blocks();
  const bool has = lane < nw;
  const Aff id = aff_identity();
  const Aff t1 = has ? s.xs.tot[par][lane] : id;
  const Aff t2 = has ? s.xs.tot2[par][lane] : id;
  Aff ex;
  const Aff inc = warp_scan<kBwd>(kBwd ? t1 : t2, &ex);
  const Aff nr = compose(kBwd ? t2 : t1, ex);
  if (has) {
    s.pre[lane] = ex;
    s.near[lane] = nr;
  }
  if (lane == (kBwd ? 0 : nw - 1)) {
    s.mine[0] = inc;
    s.mine[1] = nr;
  }
  __syncwarp();
  if (lane < ctas) {
    Ring* r = cl.map_shared_rank(&s.ring, lane);
    if (kBwd ? lane < rank : lane > rank) r->agg[par][rank] = s.mine[0];
    if (lane == (kBwd ? rank - 1 : rank + 1)) r->near[par] = s.mine[1];
    if (lane == rank - 1)
      for (int e = 0; e < 3; ++e) r->lo[par][e] = s.xs.edge[par][0][e];
    if (lane == rank + 1)
      for (int e = 0; e < 3; ++e)
        r->hi[par][e] = s.xs.edge[par][nw - 1][3 + e];
  }
}

// Warp 0: the CTA's maximum of its warps' maxima xs.max[src], pushed into
// every CTA's ring.max[par][rank].
__device__ void cta_push_max(ClusterSmem& s, int src, int par, int nw) {
  cg::cluster_group cl = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  const float v = warp_max(lane < nw ? s.xs.max[src][lane] : 0.f);
  if (lane < (int)cl.num_blocks())
    cl.map_shared_rank(&s.ring, lane)->max[par][cl.block_rank()] = v;
}

// Warp 0, after the cluster barrier: the chain value entering this CTA
// (the pushed maps of the CTAs before it, fwd, or after it, bwd, applied
// to 0 one after the other), the value at the previous CTA's last cell
// (fwd) or at the next CTA's second cell (bwd), and the cluster's maximum
// of the row before, into s.carry.
template <bool kBwd>
__device__ void cta_carry(ClusterSmem& s, int par, bool maps) {
  cg::cluster_group cl = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  const int rank = (int)cl.block_rank();
  const int ctas = (int)cl.num_blocks();
  float y1 = 0.f, y2 = 0.f, n1 = 0.f, n2 = 0.f;
  const int steps = !maps ? 0 : kBwd ? ctas - 1 - rank : rank;
  for (int k = 0; k < steps; ++k) {
    const int r = kBwd ? ctas - 1 - k : k;
    if (r == (kBwd ? rank + 1 : rank - 1)) {
      n1 = y1;
      n2 = y2;
      apply(s.ring.near[par], n1, n2);
    }
    apply(s.ring.agg[par][r], y1, y2);
  }
  const float mx = warp_max(lane < ctas ? s.ring.max[par][lane] : 0.f);
  if (lane == 0) {
    s.carry[0] = y1;
    s.carry[1] = y2;
    s.carry[2] = n1;
    s.carry[3] = n2;
    s.carry[4] = mx;
  }
}

// A row's exchange, by every thread of the cluster: the block barrier,
// warp 0 composes and pushes the CTA's maps (when `maps`) and its maximum
// of xs.max[src], the cluster barrier, warp 0 composes the carry, and a
// block barrier hands s.carry to the CTA's warps.
template <bool kBwd>
__device__ void cluster_exchange(ClusterSmem& s, int par, int src, int nw,
                                 bool maps) {
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if (warp == 0) {
    if (maps) cta_publish<kBwd>(s, par, nw);
    cta_push_max(s, src, par, nw);
  }
  cg::this_cluster().sync();
  if (warp == 0) cta_carry<kBwd>(s, par, maps);
  __syncthreads();
}

template <int C, bool kSmem>
__global__ void __launch_bounds__(kClusterThreads)
pairhmm5_fwd_cluster_kernel(const uint8_t* __restrict__ q,
                            const uint8_t* __restrict__ t_shift,
                            const int* __restrict__ m_len,
                            const int* __restrict__ n_len,
                            const int* __restrict__ lo,
                            const float* __restrict__ em, int M, int B,
                            Trans tr, int cells, float* scratch,
                            float* __restrict__ fM_out,
                            float* __restrict__ lsF_out,
                            float* __restrict__ logZ_out) {
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ float4 smem_f4[];
  __shared__ ClusterSmem s;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int T = blockDim.x;
  const int nw = T >> 5;
  const int rank = (int)cl.block_rank();
  const int ctas = (int)cl.num_blocks();
  const int nc = kSmem ? C : cells;   // window cells a lane
  const int lanes = ctas * T;
  const int L = rank * T + t;         // the lane's place in the cluster
  const int cover = lanes * nc;
  const int k0 = L * nc;              // the lane's first window cell
  // a lane 0 past the cluster's first: the warp before pushes its first
  // cell into its published map tot2
  const bool skip = lane == 0 && L > 0;
  // the state rows: the CTA's window cells in order in shared memory
  // (one pad word in 33), or cell c of the cluster's lane L at c lanes + L
  // in the pair's global scratch (five rows, then the five rows of the
  // lanes' own cells); word(dl, c): cell c of the lane dl lanes on
  const size_t RW = kSmem ? (size_t)row_words(T * nc) : (size_t)lanes * nc;
  const int p = blockIdx.x / ctas;
  float* rows = kSmem ? reinterpret_cast<float*>(smem_f4)
                      : scratch + (size_t)p * kClusterFwdRows * RW;
  auto word = [&](int dl, int c) -> size_t {
    return kSmem ? (size_t)pix((t + dl) * nc + c)
                 : (size_t)c * lanes + (L + dl);
  };
  float* sM = rows;
  float* sSX = sM + RW;
  float* sLX = sSX + RW;
  float* sSY = sLX + RW;
  float* sLY = sSY + RW;
  Cells<C, kSmem> rM, rSX, rLX;
  rM.bind(sLY + RW + L, lanes);
  rSX.bind(sLY + 2 * RW + L, lanes);
  rLX.bind(sLY + 3 * RW + L, lanes);
  // the warp's cells in order, lane after lane, for coalesced row stores:
  // its j-th of nc steps holds window cell kw0 + kl (kl = 32 j + lane),
  // cell kl % nc of the lane kl / nc - lane lanes on
  const int kw0 = (L - lane) * nc;

  const int lo_p = lo[p];
  const int m = min(m_len[p], M);
  const int n = n_len[p];
  const int end_row = m > 1 ? m : 1;
  const uint8_t* qp = q + (size_t)p * M;
  const uint8_t* tp = t_shift + (size_t)p * (M + B);
  float* fp = fM_out + (size_t)p * M * B;
  float* lp = lsF_out + (size_t)p * M;
  const float A[4] = {tr.es, tr.wls, tr.wsl, tr.el};

  for (int k = t; k < 36; k += T) s.em[k] = em[k];
  if (t == 0) s.end = 0.f;
  // the whole band first, over the cluster's lanes; the rows then store
  // their windows (after at least one cluster barrier)
  zero_cells(fp, (size_t)M * B, L, lanes);

  // the cells across the lane's warp edge: the next warp's first (M, SX,
  // LX) and the previous warp's last (M, SX, LX, SY, LY), as stored
  float nbR[3] = {0.f, 0.f, 0.f}, nbL[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  float ls = 0.f;
  float isp = 1.f;   // the reciprocal of the scale of the row before
  Window win = window(0, n, lo_p, B);
  // row 0 (M at j == 0, the SY/LY chains it seeds), then rows 1..m, each
  // computed from the row before as it stood before its rescale
  for (int i = 0; i <= m; ++i) {
    const Window prev = win;
    win = window(i, n, lo_p, B);
    const int delta = win.jlo - prev.jlo;
    const int par = i & 1;
    const int bb = win.jlo - i - lo_p;
    __syncwarp();
    if (i == 0) {
#pragma unroll
      for (int c = 0; c < nc; ++c) {
        const int k = k0 + c;
        rM[c] = k < win.wd && win.jlo + k == 0 ? 1.f : 0.f;
        rSX[c] = 0.f;
        rLX[c] = 0.f;
      }
    } else {
      const float* erow = s.em + 6 * qp[i - 1];
      // pass 1: M at k - 1 + delta, SX and LX at k + delta of the row
      // before (own cells, the neighbour lane's, or across the warp edge)
#pragma unroll
      for (int c = 0; c < nc; ++c) {
        const int k = k0 + c;
        float fm, fsx, flx, fsy, fly;
        if (delta == 1 || c > 0) {
          const size_t o = word(0, c - 1 + delta);
          fm = sM[o];
          fsx = sSX[o];
          flx = sLX[o];
          fsy = sSY[o];
          fly = sLY[o];
        } else if (k0 == 0) {
          fm = fsx = flx = fsy = fly = 0.f;
        } else if (lane == 0) {
          fm = nbL[0];
          fsx = nbL[1];
          flx = nbL[2];
          fsy = nbL[3];
          fly = nbL[4];
        } else {
          const size_t o = word(-1, nc - 1);
          fm = sM[o];
          fsx = sSX[o];
          flx = sLX[o];
          fsy = sSY[o];
          fly = sLY[o];
        }
        float fmu, fsxu, flxu;
        if (delta == 0 || c + 1 < nc) {
          const size_t o = word(0, c + delta);
          fmu = sM[o];
          fsxu = sSX[o];
          flxu = sLX[o];
        } else if (L + 1 == lanes) {
          fmu = fsxu = flxu = 0.f;
        } else if (lane == 31) {
          fmu = nbR[0];
          fsxu = nbR[1];
          flxu = nbR[2];
        } else {
          const size_t o = word(1, 0);
          fmu = sM[o];
          fsxu = sSX[o];
          flxu = sLX[o];
        }
        const bool okx = k < win.wd;
        const bool ok = okx && win.jlo + k >= 1;
        const float emit = okx ? erow[tp[i - 1 + bb + k]] : 0.f;
        rM[c] = ok ? fwd_m(tr, emit, fm, fsx, flx, fsy, fly) : 0.f;
        rSX[c] = okx ? fwd_sx(tr, fmu, fsxu, flxu) : 0.f;
        rLX[c] = okx ? fwd_lx(tr, fmu, fsxu, flxu) : 0.f;
      }
    }
    // the lane's chain map c[k] = ok(k) (os, ol) M[k - 1], the warp scan,
    // the warp's maps and edge cells
    float left = __shfl_up_sync(kFull, rM[nc - 1], 1);
    if (lane == 0) left = 0.f;
    {
      Aff a = aff_identity();
#pragma unroll
      for (int c = 0; c < nc; ++c) {
        const int k = k0 + c;
        const bool ok = k < win.wd && win.jlo + k >= 1;
        const float pm = c > 0 ? rM[c - 1] : left;
        if (!(c == 0 && skip))
          a = push_cell(a, A, ok ? tr.os * pm : 0.f, ok ? tr.ol * pm : 0.f);
      }
      Aff ex;
      const Aff x = warp_scan<false>(a, &ex);
      if (lane == 31) {
        const int kn = k0 + nc;   // the next warp's first cell
        const bool ok = kn < win.wd && win.jlo + kn >= 1 && kn < cover;
        const float last = rM[nc - 1];
        s.xs.tot[par][warp] = x;
        s.xs.tot2[par][warp] =
            push_cell(x, A, ok ? tr.os * last : 0.f, ok ? tr.ol * last : 0.f);
        s.xs.edge[par][warp][3] = last;
        s.xs.edge[par][warp][4] = rSX[nc - 1];
        s.xs.edge[par][warp][5] = rLX[nc - 1];
      }
      if (lane == 0) {
        s.xs.edge[par][warp][0] = rM[0];
        s.xs.edge[par][warp][1] = rSX[0];
        s.xs.edge[par][warp][2] = rLX[0];
      }
      cluster_exchange<false>(s, par, par ^ 1, nw, true);

      // pass 2: the carries, the deferred store of row i - 1, the chain
      // from the exact carry, the rescale by row i - 1's scale
      float y1 = s.carry[0], y2 = s.carry[1];
      float yl1 = s.carry[2], yl2 = s.carry[3];
      if (warp > 0) {
        yl1 = y1;
        yl2 = y2;
        apply(s.near[warp - 1], yl1, yl2);
      }
      apply(s.pre[warp], y1, y2);
      if (i >= 2) {
        const float sp = fmaxf(s.carry[4], kTiny);
        isp = 1.f / sp;
        const int bbp = prev.jlo - (i - 1) - lo_p;
        float* frow = fp + (size_t)(i - 2) * B;
#pragma unroll
        for (int j = 0; j < nc; ++j) {
          const int kl = 32 * j + lane;
          if (kw0 + kl < prev.wd)
            frow[bbp + kw0 + kl] = sM[word(kl / nc - lane, kl % nc)] * isp;
        }
        __syncwarp();   // the warp's cells are read before they are stored
        ls = ls + logf(sp);
        if (L == 0) lp[i - 2] = ls;
      }
      apply(ex, y1, y2);
      float lmax = 0.f;
      float pm = left;
#pragma unroll
      for (int c = 0; c < nc; ++c) {
        const int k = k0 + c;
        const bool ok = k < win.wd && win.jlo + k >= 1;
        float vM = rM[c];
        if (!(c == 0 && skip)) {
          const float c1 = ok ? tr.os * pm : 0.f;
          const float c2 = ok ? tr.ol * pm : 0.f;
          const float n1 = (A[0] * y1 + A[1] * y2) + c1;
          const float n2 = (A[2] * y1 + A[3] * y2) + c2;
          y1 = n1;
          y2 = n2;
        }
        pm = vM;
        float vSX = rSX[c], vLX = rLX[c];
        float vSY = ok ? y1 : 0.f, vLY = ok ? y2 : 0.f;
        if (i >= 2) {
          vM = vM * isp;
          vSX = vSX * isp;
          vLX = vLX * isp;
          vSY = vSY * isp;
          vLY = vLY * isp;
        }
        lmax = fmaxf(lmax, (((vM + vSX) + vLX) + vSY) + vLY);
        // the row as it stands, before its rescale
        const size_t o = word(0, c);
        sM[o] = vM;
        sSX[o] = vSX;
        sLX[o] = vLX;
        sSY[o] = vSY;
        sLY[o] = vLY;
      }
      lmax = warp_max(lmax);
      if (lane == 0) s.xs.max[par][warp] = lmax;
      const float g = i >= 2 ? isp : 1.f;
      if (lane == 31 && L + 1 < lanes) {
        const float* e = warp + 1 < nw ? s.xs.edge[par][warp + 1]
                                       : s.ring.lo[par];
        for (int e3 = 0; e3 < 3; ++e3) nbR[e3] = e[e3] * g;
      }
      if (lane == 0 && L > 0) {
        const float* e = warp > 0 ? &s.xs.edge[par][warp - 1][3]
                                  : s.ring.hi[par];
        const int kl = k0 - 1;
        const bool okl = kl < win.wd && win.jlo + kl >= 1;
        for (int e3 = 0; e3 < 3; ++e3) nbL[e3] = e[e3] * g;
        nbL[3] = (okl ? yl1 : 0.f) * g;
        nbL[4] = (okl ? yl2 : 0.f) * g;
      }
    }
  }
  if (m >= 1) {
    // row m's scale, from the cluster's maxima of the last row
    cluster_exchange<false>(s, (m + 1) & 1, m & 1, nw, false);
    const float sp = fmaxf(s.carry[4], kTiny);
    isp = 1.f / sp;
    const int bb = win.jlo - m - lo_p;
    float* frow = fp + (size_t)(m - 1) * B;
#pragma unroll
    for (int j = 0; j < nc; ++j) {
      const int kl = 32 * j + lane;
      if (kw0 + kl < win.wd)
        frow[bb + kw0 + kl] = sM[word(kl / nc - lane, kl % nc)] * isp;
    }
#pragma unroll
    for (int c = 0; c < nc; ++c) {
      const int k = k0 + c;
      if (k < win.wd) {
        const size_t o = word(0, c);
        const float nM = sM[o] * isp;
        if (win.jlo + k == n) {
          const float nSX = sSX[o] * isp;
          const float nLX = sLX[o] * isp;
          const float nSY = sSY[o] * isp;
          const float nLY = sLY[o] * isp;
          *cl.map_shared_rank(&s.end, 0) = nM + (((nSX + nLX) + nSY) + nLY);
        }
      }
    }
    ls = ls + logf(sp);
    if (L == 0) lp[m - 1] = ls;
  }
  cl.sync();   // the end cell's sum has reached CTA 0
  if (L == 0) {
    // rows past m: every state masked to 0, the row scale TINY
    float lz = logf(fmaxf(s.end, kTiny)) + ls;
    for (int i = m + 1; i <= M; ++i) {
      ls = ls + logf(kTiny);
      lp[i - 1] = ls;
      if (i == end_row) lz = logf(kTiny) + ls;
    }
    if (M < end_row) lz = logf(kTiny) + ls;
    logZ_out[p] = lz;
  }
}

template <int C, bool kSmem>
__global__ void __launch_bounds__(kClusterThreads)
pairhmm5_bwd_cluster_kernel(const float* __restrict__ fM,
                            const float* __restrict__ lsF,
                            const float* __restrict__ logZ,
                            const uint8_t* __restrict__ q,
                            const uint8_t* __restrict__ t_shift,
                            const int* __restrict__ m_len,
                            const int* __restrict__ n_len,
                            const int* __restrict__ lo,
                            const float* __restrict__ em, int M, int B,
                            Trans tr, int cells, float* scratch,
                            float* __restrict__ post) {
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ float4 smem_f4[];
  __shared__ ClusterSmem s;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int T = blockDim.x;
  const int nw = T >> 5;
  const int rank = (int)cl.block_rank();
  const int ctas = (int)cl.num_blocks();
  const int nc = kSmem ? C : cells;
  const int lanes = ctas * T;
  const int L = rank * T + t;
  const int k0 = L * nc;
  // bM, bSX, bLX of the carried row (bSY and bLY of a row feed only its
  // rescale, so they are never stored), laid out as the forward pass's;
  // global scratch: three rows, then the lanes' own three
  const size_t RW = kSmem ? (size_t)row_words(T * nc) : (size_t)lanes * nc;
  const int p = blockIdx.x / ctas;
  float* rows = kSmem ? reinterpret_cast<float*>(smem_f4)
                      : scratch + (size_t)p * kClusterBwdRows * RW;
  auto word = [&](int dl, int c) -> size_t {
    return kSmem ? (size_t)pix((t + dl) * nc + c)
                 : (size_t)c * lanes + (L + dl);
  };
  float* sM = rows;
  float* sSX = sM + RW;
  float* sLX = sSX + RW;
  Cells<C, kSmem> rMM, rSX, rLX;
  rMM.bind(sLX + RW + L, lanes);
  rSX.bind(sLX + 2 * RW + L, lanes);
  rLX.bind(sLX + 3 * RW + L, lanes);
  const int kw0 = (L - lane) * nc;   // the warp's first window cell

  const int lo_p = lo[p];
  const int m = m_len[p];
  const int n = n_len[p];
  const uint8_t* qp = q + (size_t)p * M;
  const uint8_t* tp = t_shift + (size_t)p * (M + B);
  const float* fp = fM + (size_t)p * M * B;
  const float* lp = lsF + (size_t)p * M;
  float* pp = post + (size_t)p * M * B;
  const float lz = logZ[p];
  const float At[4] = {tr.es, tr.wsl, tr.wls, tr.el};

  for (int k = t; k < 36; k += T) s.em[k] = em[k];
  // rows past the pair's end have zero posterior (every row when m_len
  // is 0, or beyond the padded row count, where no terminal row exists)
  const bool live = m >= 1 && m <= M;
  zero_cells(pp, (size_t)M * B, L, lanes);
  if (!live) return;   // the whole cluster: no shared memory is read

  // the cells across the lane's warp edge: the next warp's first bM and
  // the previous warp's last bSX, bLX, as stored
  float nbR = 0.f, nbL[2] = {0.f, 0.f};
  float ls = 0.f;
  float isp = 1.f;   // the reciprocal of the carried row's scale
  Window win = window(m, n, lo_p, B);
  // step i computes row i - 1 from row i and forms row i's posterior;
  // step m + 1 is the terminal row m (only the Y-gap chains remain,
  // ty[k] = A^T ty[k + 1] + (1, 1)[j == n], bM = opens . ty[k + 1])
  for (int i = m + 1; i >= 2; --i) {
    const bool term = i == m + 1;
    const Window cur = win;   // row i, whose posterior this step forms
    win = window(i - 1, n, lo_p, B);
    const int delta = term ? 0 : cur.jlo - win.jlo;
    const int par = (i - 1) & 1;
    const int bb = win.jlo - (i - 1) - lo_p;
    __syncwarp();
    if (term) {
#pragma unroll
      for (int c = 0; c < nc; ++c) {
        const int k = k0 + c;
        const float ce = k < win.wd && win.jlo + k == n ? 1.f : 0.f;
        rMM[c] = 0.f;
        rSX[c] = ce;
        rLX[c] = ce;
      }
    } else {
      const float* erow = s.em + 6 * qp[i - 1];
      // pass 1: mm from bM at k + 1 - delta, sx and lx from bSX, bLX at
      // k - delta of row i
#pragma unroll
      for (int c = 0; c < nc; ++c) {
        const int k = k0 + c;
        float mmv;
        if (delta == 1 || c + 1 < nc) {
          mmv = sM[word(0, c + 1 - delta)];
        } else if (L + 1 == lanes) {
          mmv = 0.f;
        } else if (lane == 31) {
          mmv = nbR;
        } else {
          mmv = sM[word(1, 0)];
        }
        float sxv, lxv;
        if (delta == 0 || c > 0) {
          const size_t o = word(0, c - delta);
          sxv = sSX[o];
          lxv = sLX[o];
        } else if (k0 == 0) {
          sxv = lxv = 0.f;
        } else if (lane == 0) {
          sxv = nbL[0];
          lxv = nbL[1];
        } else {
          const size_t o = word(-1, nc - 1);
          sxv = sSX[o];
          lxv = sLX[o];
        }
        const bool okp = k < win.wd;
        const bool okm = okp && win.jlo + k + 1 <= n;
        rMM[c] = okm ? erow[tp[i - 1 + bb + k]] * mmv : 0.f;
        rSX[c] = okp ? sxv : 0.f;
        rLX[c] = okp ? lxv : 0.f;
      }
    }
    // the lane's chain map from the right, c = (ms, ml) mm (terminal row:
    // (1, 1) at j == n), and the map without its first cell
    Aff a = aff_identity(), rest = a;
#pragma unroll
    for (int c = nc - 1; c >= 0; --c) {
      if (c == 0) rest = a;
      a = term ? push_cell(a, At, rSX[c], rSX[c])
               : push_cell(a, At, tr.ms * rMM[c], tr.ml * rMM[c]);
    }
    Aff ex;
    const Aff x = warp_scan<true>(a, &ex);
    if (lane == 0) {
      s.xs.tot[par][warp] = x;
      s.xs.tot2[par][warp] = compose(rest, ex);
      s.xs.edge[par][warp][0] = rMM[0];
      s.xs.edge[par][warp][1] = rSX[0];
      s.xs.edge[par][warp][2] = rLX[0];
    }
    if (lane == 31) {
      const float mm = rMM[nc - 1], sx = rSX[nc - 1], lx = rLX[nc - 1];
      s.xs.edge[par][warp][3] = term ? sx : bwd_sx(tr, mm, sx, lx);
      s.xs.edge[par][warp][4] = term ? lx : bwd_lx(tr, mm, sx, lx);
    }
    cluster_exchange<true>(s, par, par ^ 1, nw, true);

    // pass 2 (descending): the carries, row i's posterior, the chain from
    // the exact carry, row i - 1's values rescaled by row i's scale
    float y1 = s.carry[0], y2 = s.carry[1];
    float yn1 = s.carry[2], yn2 = s.carry[3];
    if (warp + 1 < nw) {
      yn1 = y1;
      yn2 = y2;
      apply(s.near[warp + 1], yn1, yn2);
    }
    apply(s.pre[warp], y1, y2);
    const bool scaled = i < m;
    if (scaled) {
      const float sp = fmaxf(s.carry[4], kTiny);
      isp = 1.f / sp;
      ls = ls + logf(sp);
    }
    if (!term) {
      const float g =
          expf(fminf(fmaxf((lp[i - 1] + ls) - lz, -60.f), 60.f));
      const int bbi = cur.jlo - i - lo_p;
      const float* frow = fp + (size_t)(i - 1) * B;
      float* prow = pp + (size_t)(i - 1) * B;
#pragma unroll
      for (int j = 0; j < nc; ++j) {
        const int kl = 32 * j + lane;
        const int k = kw0 + kl;
        if (k < cur.wd) {
          float bm = sM[word(kl / nc - lane, kl % nc)];
          if (scaled) bm = bm * isp;
          const float v = (frow[bbi + k] * bm) * g;
          prow[bbi + k] = fminf(fmaxf(v, 0.f), 1.5f);
        }
      }
      __syncwarp();   // the warp's cells are read before they are stored
    }
    apply(ex, y1, y2);
    float lmax = 0.f;
#pragma unroll
    for (int c = nc - 1; c >= 0; --c) {
      const int k = k0 + c;
      const float mm = rMM[c], sx = rSX[c], lx = rLX[c];
      const float r1 = y1, r2 = y2;   // the chain at k + 1 (unmasked)
      const size_t o = word(0, c);
      if (term) {
        const float n1 = (At[0] * y1 + At[1] * y2) + sx;
        const float n2 = (At[2] * y1 + At[3] * y2) + sx;
        y1 = n1;
        y2 = n2;
        const bool okr = k + 1 < win.wd;
        sM[o] = sx != 0.f ? 1.f
                          : (k < win.wd && okr ? tr.os * r1 + tr.ol * r2
                                               : 0.f);
        sSX[o] = sx;
        sLX[o] = lx;
      } else {
        const float n1 = (At[0] * y1 + At[1] * y2) + tr.ms * mm;
        const float n2 = (At[2] * y1 + At[3] * y2) + tr.ml * mm;
        y1 = n1;
        y2 = n2;
        float nM = bwd_m(tr, mm, sx, lx, r1, r2);
        float nSX = bwd_sx(tr, mm, sx, lx);
        float nLX = bwd_lx(tr, mm, sx, lx);
        float nSY = n1, nLY = n2;
        if (!(k < win.wd)) nM = nSX = nLX = nSY = nLY = 0.f;
        if (scaled) {
          nM = nM * isp;
          nSX = nSX * isp;
          nLX = nLX * isp;
          nSY = nSY * isp;
          nLY = nLY * isp;
        }
        lmax = fmaxf(lmax, (((nM + nSX) + nLX) + nSY) + nLY);
        // row i - 1 as it stands, before its rescale
        sM[o] = nM;
        sSX[o] = nSX;
        sLX[o] = nLX;
      }
    }
    lmax = warp_max(lmax);
    if (lane == 0) s.xs.max[par][warp] = lmax;
    if (lane == 31 && L + 1 < lanes) {
      // the next warp's first bM, from its pass-1 values and the chain at
      // its second cell
      const float* e = warp + 1 < nw ? s.xs.edge[par][warp + 1]
                                     : s.ring.lo[par];
      const int xk = k0 + nc;
      if (term) {
        nbR = e[1] != 0.f ? 1.f
                          : (xk < win.wd && xk + 1 < win.wd
                                 ? tr.os * yn1 + tr.ol * yn2
                                 : 0.f);
      } else {
        nbR = xk < win.wd ? bwd_m(tr, e[0], e[1], e[2], yn1, yn2) : 0.f;
        if (scaled) nbR = nbR * isp;
      }
    }
    if (lane == 0 && L > 0) {
      const float* e = warp > 0 ? &s.xs.edge[par][warp - 1][3]
                                : s.ring.hi[par];
      nbL[0] = e[0];
      nbL[1] = e[1];
      if (scaled) {
        nbL[0] = nbL[0] * isp;
        nbL[1] = nbL[1] * isp;
      }
    }
  }
  // row 1's posterior (row m's when m is 1), rescaled by its own scale
  if (m >= 2) {
    cluster_exchange<true>(s, 0, 1, nw, false);
    const float sp = fmaxf(s.carry[4], kTiny);
    isp = 1.f / sp;
    ls = ls + logf(sp);
  }
  const float g = expf(fminf(fmaxf((lp[0] + ls) - lz, -60.f), 60.f));
  const int bb1 = win.jlo - 1 - lo_p;
#pragma unroll
  for (int j = 0; j < nc; ++j) {
    const int kl = 32 * j + lane;
    const int k = kw0 + kl;
    if (k < win.wd) {
      float bm = sM[word(kl / nc - lane, kl % nc)];
      if (m >= 2) bm = bm * isp;
      const float v = (fp[bb1 + k] * bm) * g;
      pp[bb1 + k] = fminf(fmaxf(v, 0.f), 1.5f);
    }
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

// The cluster a wide launch takes for max_live W: kClusterCells cells a
// lane in the fewest warps that cover W, spread over as many CTAs as there
// are warps, up to kClusterMax (a row's time is the cells each SM computes
// plus a fixed exchange, so a row is spread over as many SMs as the
// cluster has), the state rows in each CTA's shared memory; past that
// cover (kClusterMax x kMaxWarps warps of kClusterCells cells, 131,072)
// kClusterMax CTAs of kClusterThreads threads with ceil(W / 16384) cells a
// lane, the rows in global scratch.
ClusterShape cluster_shape(int W) {
  const long long per_warp = 32 * kClusterCells;
  const long long warps = (W + per_warp - 1) / per_warp;
  if (warps <= (long long)kClusterMax * kMaxWarps) {
    const int ctas = (int)(warps < kClusterMax ? warps : kClusterMax);
    return ClusterShape{ctas, 32 * (int)((warps + ctas - 1) / ctas),
                        kClusterCells, 1};
  }
  const long long lanes = (long long)kClusterMax * kClusterThreads;
  return ClusterShape{kClusterMax, kClusterThreads,
                      (int)((W + lanes - 1) / lanes), 0};
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

// The cluster a wide launch takes for max_live W (cluster_shape): out[0..5]
// = CTAs, threads a CTA, cells a lane, 1 where the state rows live in the
// CTAs' shared memory, and the float32 words of global scratch a pair
// needs forward and backward (0 with shared-memory rows).
int pairhmm5_cluster_shape(int W, void* out) {
  if (W < 1) return (int)cudaErrorInvalidValue;
  const ClusterShape sh = cluster_shape(W);
  const long long words = sh.smem ? 0 : (long long)sh.ctas * sh.threads *
                                            sh.cells;
  long long* o = static_cast<long long*>(out);
  o[0] = sh.ctas;
  o[1] = sh.threads;
  o[2] = sh.cells;
  o[3] = sh.smem;
  o[4] = kClusterFwdRows * words;
  o[5] = kClusterBwdRows * words;
  return 0;
}

// The wide route (max_live past kMaxCells, or any max_live a caller
// forces): one cluster a pair.  `scratch` is needed where cluster_shape
// puts the rows in global scratch.
int pairhmm5_fwd_wide_launch(const void* q, const void* t_shift,
                             const void* m_len, const void* n_len,
                             const void* lo, const void* em, int P, int M,
                             int B, int W, float mc, float os, float ol,
                             float es, float el, float wsl, float wls,
                             float ms, float ml, void* scratch, void* fM,
                             void* lsF, void* logZ, void* stream) {
  if (P <= 0) return 0;
  if (W < 1 || W > B) return (int)cudaErrorInvalidValue;
  const ClusterShape sh = cluster_shape(W);
  if (!sh.smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const Trans tr{mc, os, ol, es, el, wsl, wls, ms, ml};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const uint8_t*>(q);
  const auto* tt = static_cast<const uint8_t*>(t_shift);
  const auto* mm = static_cast<const int*>(m_len);
  const auto* nn = static_cast<const int*>(n_len);
  const auto* ll = static_cast<const int*>(lo);
  const auto* ee = static_cast<const float*>(em);
  auto* sc = static_cast<float*>(scratch);
  auto* f = static_cast<float*>(fM);
  auto* l = static_cast<float*>(lsF);
  auto* z = static_cast<float*>(logZ);
  if (sh.smem) {
    static size_t allowed = 48 * 1024;
    const size_t smem = 5 * (size_t)row_words(sh.threads * sh.cells) * 4;
    return (int)launch_cluster(
        pairhmm5_fwd_cluster_kernel<kClusterCells, true>, sh, P, smem,
        &allowed, st, qq, tt, mm, nn, ll, ee, M, B, tr, sh.cells, sc, f, l,
        z);
  }
  static size_t allowed = 48 * 1024;
  return (int)launch_cluster(pairhmm5_fwd_cluster_kernel<kClusterCells, false>,
                             sh, P, 0, &allowed, st, qq, tt, mm, nn, ll, ee, M,
                             B, tr, sh.cells, sc, f, l, z);
}

int pairhmm5_bwd_wide_launch(const void* fM, const void* lsF,
                             const void* logZ, const void* q,
                             const void* t_shift, const void* m_len,
                             const void* n_len, const void* lo,
                             const void* em, int P, int M, int B, int W,
                             float mc, float os, float ol, float es,
                             float el, float wsl, float wls, float ms,
                             float ml, void* scratch, void* post,
                             void* stream) {
  if (P <= 0) return 0;
  if (W < 1 || W > B) return (int)cudaErrorInvalidValue;
  const ClusterShape sh = cluster_shape(W);
  if (!sh.smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const Trans tr{mc, os, ol, es, el, wsl, wls, ms, ml};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const float*>(fM);
  const auto* l = static_cast<const float*>(lsF);
  const auto* z = static_cast<const float*>(logZ);
  const auto* qq = static_cast<const uint8_t*>(q);
  const auto* tt = static_cast<const uint8_t*>(t_shift);
  const auto* mm = static_cast<const int*>(m_len);
  const auto* nn = static_cast<const int*>(n_len);
  const auto* ll = static_cast<const int*>(lo);
  const auto* ee = static_cast<const float*>(em);
  auto* sc = static_cast<float*>(scratch);
  auto* out = static_cast<float*>(post);
  if (sh.smem) {
    static size_t allowed = 48 * 1024;
    const size_t smem = 3 * (size_t)row_words(sh.threads * sh.cells) * 4;
    return (int)launch_cluster(
        pairhmm5_bwd_cluster_kernel<kClusterCells, true>, sh, P, smem,
        &allowed, st, f, l, z, qq, tt, mm, nn, ll, ee, M, B, tr, sh.cells,
        sc, out);
  }
  static size_t allowed = 48 * 1024;
  return (int)launch_cluster(pairhmm5_bwd_cluster_kernel<kClusterCells, false>,
                             sh, P, 0, &allowed, st, f, l, z, qq, tt, mm, nn,
                             ll, ee, M, B, tr, sh.cells, sc, out);
}

}  // extern "C"
