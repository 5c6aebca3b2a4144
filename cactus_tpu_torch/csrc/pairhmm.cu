// 3-state (match M / insert X / delete Y) banded pair-HMM forward and
// backward passes in scaled linear float32, for NVIDIA Hopper (built for
// sm_90a, bound with ctypes).
//
// pairhmm_fwd replaces the Pallas TPU kernel
// cactus_tpu/ops/pairhmm_pallas.py::_fwd_kernel and pairhmm_bwd replaces
// ::_bwd_kernel (entry posterior_banded_batch_pallas).  Their contract is
// cactus_tpu/ops/pairhmm.py::posterior_banded_batch, split in two:
//   fwd:  q, t_shift, m_len, n_len, lo, em -> fM (P, M, B) f32, lsF (P, M)
//         f32, logZ (P,) f32, such that fM * exp(lsF) is the forward
//         match value of every cell, as in the plain version
//         (cactus_tpu_torch/ops/pairhmm.py::forward_banded)
//   bwd:  fM, lsF, logZ and the same inputs -> post (P, M, B) f32, the
//         match posterior fM*bM*exp(clip(lsF+lsB-logZ, -60, 60)) clipped
//         to [0, 1.5] and zero past each pair's m_len; the combine is
//         fused into the backward pass, so bM never reaches device memory.
//
// What bounds them on an H100: the chain of work from one row to the next.
// A row needs the whole previous row, so a pair's rows run one after
// another, and a launch holds a few pairs (the default path: two pieces
// of up to 2048 rows).  Bytes (4 a cell out; 4 in and 4 out backward) and
// float32 operations (~20 a cell) are far below the card's rates.  So the
// design shortens each row:
//  - One block per pair; each lane owns C contiguous band cells and keeps
//    their states in registers (launch_shape: 4 warps of 4 cells a lane at
//    band 512, 8 warps of 8 at band 2048).
//  - The in-row chain y[b] = s[b] + e*y[b-1] (reversed backward) is an
//    affine scan whose multiplier is always e: each lane folds its cells
//    as a tree, a warp-shuffle Kogge-Stone scan with the constant
//    multipliers e^(C 2^l) combines the lanes, and where a pair has several
//    warps each warp adds the earlier warps' totals itself after one
//    exchange through shared memory (double-buffered by row parity: one
//    block barrier a row, none with one warp).  Each cell's carry-free
//    prefix is formed while the shuffles are in flight, so the replay is
//    one multiply-add a cell.  The neighbour cells across lanes and warps
//    travel with the same shuffle and exchange.
//  - The band is rescaled once per kStepRows = 8 rows, by the reciprocal of
//    the step's last row maximum, as the TPU kernel does; float32 has ~1e38
//    of headroom and odds-ratio emissions are <= 16, so 8 unscaled rows stay
//    finite (pairhmm_pallas.py:15-20).  Each row's band maximum is still
//    taken, but off the chain: a lane keeps its partial for each row of the
//    step, and one batched warp reduction (and one exchange between warps)
//    ends the step.  From the maxima the step's bookkeeping forms the
//    per-row scales the plain version uses (the ratio of two consecutive
//    row maxima) and sums their logs row by row, as the plain version does:
//    a running float32 sum over thousands of rows carries a rounding error
//    of ~1e-2 at 4096 rows, and summing once per step instead would move
//    the posterior that far from the plain version's.  The step's rows wait
//    in shared memory (each thread its own cells); when the step ends each
//    is stored divided by its own maximum, with that running sum as its
//    lsF, as the plain version stores it.  The backward pass scales its
//    rows alike before the combine: on diffuse pieces (unrelated, where a
//    row's forward and backward masses lie apart) the exponent
//    lsF + lsB - logZ passes 60 and the contract's clip binds, so it must
//    see the plain version's exponent, not one shifted by the rows' drift.
//  - Rows whose band lies inside the matrix (most of them) skip the edge
//    masks: the row body is compiled with and without them.
//  - q codes and the t_shift bytes are staged into shared memory by tiles
//    of kTileRows rows with cp.async, one tile ahead, and each row's
//    emissions are read while the previous row's shuffles are in flight,
//    so nothing on a row's chain reads device memory.  The backward pass
//    loads the next row's fM cells while the current row runs.
//  - The row loop is not unrolled: eight copies of a row overflow the
//    instruction cache (2.5x slower at 16 cells a lane).
//  - Bands past 16384 cells (16 warps of 32 cells a lane) take the
//    cluster kernels below (the wrapper routes by band,
//    ops/pairhmm_cuda.py::pairhmm_route).
// The cluster kernels (pairhmm_fwd_cluster_kernel, pairhmm_bwd_cluster_kernel)
// are the same two Pallas kernels' counterparts for wide bands, where a
// pair's band outgrows one SM.  What bounds them is the same chain of rows.
// The design shortens a row by computing only its live cells and spreading
// them over a thread-block cluster:
//  - Only the live window.  Row i has live columns j = jlo(i) .. jhi(i),
//    jlo = max(0, i + lo), jhi = min(n, i + lo + B - 1); every other cell
//    of the contract is exactly 0 (tests/test_torch_pairhmm_schedule.py).
//    A row is indexed by its window cell k = j - jlo(i).  From row i - 1 to
//    row i the window moves by delta = jlo(i) - jlo(i - 1) in {0, 1}: M at
//    k reads the row before at k - 1 + delta, X at k + delta (backward, mm
//    reads bM at k + 1 - delta and x reads bX at k - delta).  The pair's
//    (M, B) output outside the windows and past m is zeroed once, over the
//    cluster's lanes; each row then stores its window.
//  - One cluster a pair, sized by the launch's widest live row max_live
//    (cluster_shape): 8 cells a lane in the fewest warps that cover it,
//    over up to 16 CTAs (non-portable past 8).  The card must schedule the
//    cluster (cudaOccupancyMaxActiveClusters, csrc/cluster.cuh), or the
//    launch returns an error.
//  - Each CTA keeps its window cells of the row before (M, X, Y forward;
//    bM, bX backward) and the step's up to 8 rows of M (fM x bM backward)
//    in its shared memory, one pad word in 33, up to 21 warps a CTA
//    (86,016 cells a cluster); past that the same kernel (kSmem false)
//    keeps them, and the lanes' own cells, in the pair's global scratch.
//    A step's rows are stored when it ends, each divided by its own
//    maximum (backward: its posterior), a warp's 32 neighbouring cells a
//    store.  A lane's target codes (and backward its fM cells) are loaded
//    a row ahead, so that no load sits on a row's chain (the backward
//    pass's fM loads at the step's end took a third of its time on an
//    H100 80GB HBM3 at 700 W, tests/pairhmm_sweep_report.py).  CTAs of up
//    to 8 warps take an instance bounded at 256 threads: at the 672-thread
//    bound a thread has 80 registers, and its cells spill.
//  - The in-row chain Y[k] = d M[k - 1] + e Y[k - 1] has the constant
//    multiplier e, so what the cells before a CTA add to its first cell is
//    one float, Horner's rule in e^(cells a CTA) over the CTAs' totals.
//    Each warp folds and scans its lanes as the narrow kernels do and
//    publishes its total, its near value (its chain at its last cell, from
//    its own cells; backward at its second cell) and its edge cells (M and
//    X of its first and last cells from pass 1; backward mm and x of its
//    first cell and bX of its last).  After the block barrier warp 0 folds
//    them into the CTA's and pushes these into the rings of the CTAs that
//    read them (DSMEM stores, double-buffered by row parity; nothing is
//    loaded remotely); after the row's one cluster barrier every thread
//    forms the carry entering its warp from the totals before it (after
//    it, backward) and replays its cells.  The cells across a warp or CTA
//    edge that the next row reads come from the pushed pass-1 values; the
//    Y (backward: the chain in bM) they need from the near value and the
//    carry entering that warp or CTA.
//  - The step's row maxima are needed only when it ends: each CTA pushes
//    its 8 maxima once a step, in the exchange of the next step's first
//    row (or one last exchange), no extra barrier.  That row is computed
//    from the unscaled row before it and rescaled by the step's last
//    maximum after the barrier, so its values are the narrow kernels' to
//    rounding.
// Float results follow the plain PyTorch version to rounding: the in-row
// chains are summed in another order than its Kogge-Stone scan, multiplies
// and adds may contract into FMAs, the rows of a step are not renormalised
// one by one, and expf/logf/powf differ from the host's by an ulp.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kTiny = 1e-30f;    // pairhmm.py TINY
constexpr int kStepRows = 8;       // rows between two rescales
constexpr int kTileRows = 128;     // rows of codes staged at a time
constexpr int kMaxWarps = 16;      // warps a pair at most (band 16384)
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr unsigned kFull = 0xffffffffu;


__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copies src[begin & ~3, end) (end clipped to limit) into dst[0, ...) with
// the whole block, by 4-byte cp.async where src is 4-byte aligned, else by
// plain loads.  The copies are visible to the block after
// cp_async_wait_all and a barrier.
__device__ void stage_bytes(uint8_t* dst, const uint8_t* src, int begin,
                            int end, int limit) {
  begin &= ~3;
  end = min(end, limit);
  const int T = blockDim.x;
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 3) == 0;
  const int n = end - begin;
  if (n <= 0) return;
  const int words = aligned ? n >> 2 : 0;
  for (int k = threadIdx.x; k < words; k += T)
    cp_async4(dst + 4 * k, src + begin + 4 * k);
  for (int k = 4 * words + threadIdx.x; k < n; k += T)
    dst[k] = src[begin + k];
}

// e^(C * 2^l) for l = 0..4 and the lane's multiplier e^(C * lane)
// (forward) or e^(C * (31 - lane)) (backward), by repeated products.
template <int C>
__device__ __forceinline__ void chain_constants(float e, int lane_pos, float* lev,
                                float* lane_mult) {
  float eC = 1.f;
#pragma unroll
  for (int c = 0; c < C; ++c) eC = eC * e;
  lev[0] = eC;
#pragma unroll
  for (int l = 1; l < 6; ++l) lev[l] = lev[l - 1] * lev[l - 1];
  float a = 1.f;
  for (int k = 0; k < lane_pos; ++k) a = a * eC;
  *lane_mult = a;
}

// Inclusive Kogge-Stone scan over the warp of the lane maps w -> E*w + v
// (E = e^(C * span)): forward combines lower lanes, reverse higher ones.
template <bool kReverse>
__device__ __forceinline__ float warp_chain_scan(float v, const float* lev,
                                                 int lane) {
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    const int off = 1 << l;
    const float o = kReverse ? __shfl_down_sync(kFull, v, off)
                             : __shfl_up_sync(kFull, v, off);
    if (kReverse ? lane + off < 32 : lane >= off) v = v + lev[l] * o;
  }
  return v;
}

// The step's R band maxima, reduced over the block: a butterfly in each
// warp, then (several warps) one exchange through buf[warp][r].
template <int R>
__device__ __forceinline__ void block_step_max(float* pmax, float (*buf)[R],
                                               int lane, int warp,
                                               int nwarps) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      pmax[r] = fmaxf(pmax[r], __shfl_xor_sync(kFull, pmax[r], off));
  }
  if (nwarps == 1) {
    __syncwarp();
    return;
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) buf[warp][r] = pmax[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float v = buf[0][r];
    for (int w = 1; w < nwarps; ++w) v = fmaxf(v, buf[w][r]);
    pmax[r] = v;
  }
}

// The emissions of one row's C cells: em[q][t] for the row's query code
// and the cells' target codes (codes are below 6, as em is 6 x 6; the code
// tiles are filled with 5 before any is staged, so that the bytes a
// masked cell reads past the staged ones are codes too).
template <int C>
__device__ __forceinline__ void row_emissions(const float* em, int qcode,
                                              const uint8_t* tcodes,
                                              float* out) {
  const float* erow = em + 6 * qcode;
#pragma unroll
  for (int c = 0; c < C; ++c) out[c] = erow[tcodes[c]];
}

// The largest of C values (all >= 0), as a tree.
template <int C>
__device__ __forceinline__ float tree_max(float* v) {
#pragma unroll
  for (int st = 1; st < C; st *= 2) {
#pragma unroll
    for (int c = 0; c + st < C; c += 2 * st) v[c] = fmaxf(v[c], v[c + st]);
  }
  return v[0];
}

// A thread's C cells into its slot of a step's ring (16-byte stores).
template <int C>
__device__ __forceinline__ void store_cells(float* slot, const float* v) {
  if (C % 4 == 0) {
#pragma unroll
    for (int c = 0; c < C; c += 4)
      *reinterpret_cast<float4*>(slot + c) =
          make_float4(v[c], v[c + 1 < C ? c + 1 : c],
                      v[c + 2 < C ? c + 2 : c], v[c + 3 < C ? c + 3 : c]);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) slot[c] = v[c];
  }
}

// dst[c] = slot[c] * k for the nb cells of the thread inside the band.
template <int C>
__device__ __forceinline__ void scale_cells(const float* slot, float* dst,
                                            float k, int nb, bool vec) {
  if (vec) {
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      float4 v = *reinterpret_cast<const float4*>(slot + c);
      v.x = v.x * k;
      v.y = v.y * k;
      v.z = v.z * k;
      v.w = v.w * k;
      *reinterpret_cast<float4*>(dst + c) = v;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (c < nb) dst[c] = slot[c] * k;
  }
}

// dst[c] = clip((slot[c] * k) * g, 0, 1.5) for the thread's nb cells.
template <int C>
__device__ __forceinline__ void posterior_cells(const float* slot, float* dst,
                                                float k, float g, int nb,
                                                bool vec) {
  if (vec) {
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      float4 v = *reinterpret_cast<const float4*>(slot + c);
      v.x = fminf(fmaxf((v.x * k) * g, 0.f), 1.5f);
      v.y = fminf(fmaxf((v.y * k) * g, 0.f), 1.5f);
      v.z = fminf(fmaxf((v.z * k) * g, 0.f), 1.5f);
      v.w = fminf(fmaxf((v.w * k) * g, 0.f), 1.5f);
      *reinterpret_cast<float4*>(dst + c) = v;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (c < nb) dst[c] = fminf(fmaxf((slot[c] * k) * g, 0.f), 1.5f);
  }
}

// Fills the block's code tiles with code 5 (then a barrier).
__device__ __forceinline__ void fill_codes(uint8_t* codes, int bytes) {
  uint32_t* w = reinterpret_cast<uint32_t*>(codes);
  for (int k = threadIdx.x; k < bytes / 4; k += blockDim.x) w[k] = 0x05050505u;
  __syncthreads();
}

struct Shared {
  float em[36];
  float tot[2][kMaxWarps];          // warp chain totals, by row parity
  float edge[2][kMaxWarps][2];      // boundary cells, by row parity
  float max[2][kMaxWarps][kStepRows];   // step maxima, by step parity
  float end[3];                     // the end cell's M, X, Y (forward)
};

// Bytes of one tile buffer of t_shift codes (the tile's rows + the band,
// padded lanes included) and of q codes.
__host__ __device__ inline int t_tile_bytes(int Bp) {
  return ((kTileRows + Bp + 8) + 15) & ~15;
}
constexpr int kQTileBytes = ((kTileRows + 8) + 15) & ~15;
// Both passes keep a step's rows (unscaled fM forward, fM x bM backward)
// in shared memory, at most kRingBytes: 8 rows up to band 2048, fewer
// above (a power of two, so that steps tile the kTileRows rows of a code
// tile).
constexpr int kRingBytes = 64 * 1024;
__host__ __device__ inline int step_rows(int Bp) {
  int r = kStepRows;
  while (r > 1 && r * Bp * 4 > kRingBytes) r /= 2;
  return r;
}

template <int C, int kBound>
__global__ void __launch_bounds__(kBound)
pairhmm_fwd_kernel(const uint8_t* __restrict__ q,
                   const uint8_t* __restrict__ t_shift,
                   const int* __restrict__ m_len,
                   const int* __restrict__ n_len,
                   const int* __restrict__ lo,
                   const float* __restrict__ em, int M, int B, float d,
                   float e, float tMM, float omE,
                   float* __restrict__ fM_out, float* __restrict__ lsF_out,
                   float* __restrict__ logZ_out) {
  constexpr int R = kStepRows;
  extern __shared__ float4 smem_f4[];
  __shared__ Shared sh;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const int Bp = blockDim.x * C;
  // two tile buffers of t_shift codes, then two of q codes
  uint8_t* const codes = reinterpret_cast<uint8_t*>(smem_f4);
  const int t_bytes = t_tile_bytes(Bp);

  const int p = blockIdx.x;
  const int b0 = t * C;
  const int lo_p = lo[p];
  const int m = min(m_len[p], M);
  const int n = n_len[p];
  const int b_end = n - m - lo_p;
  const int end_row = m > 1 ? m : 1;
  const uint8_t* qp = q + (size_t)p * M;
  const uint8_t* tp = t_shift + (size_t)p * (M + B);
  float* fp = fM_out + (size_t)p * M * B;
  float* lp = lsF_out + (size_t)p * M;

  for (int k = t; k < 36; k += blockDim.x) sh.em[k] = em[k];
  if (t < 3) sh.end[t] = 0.f;
  float lev[6], lane_mult;
  chain_constants<C>(e, lane, lev, &lane_mult);
  const float warp_mult = lev[5];      // e^(32 C)
  // e^c, and the weight d e^(C-1-c) of cell c in the lane's fold
  float epow[C], wgt[C];
  epow[0] = 1.f;
#pragma unroll
  for (int c = 1; c < C; ++c) epow[c] = epow[c - 1] * e;
#pragma unroll
  for (int c = 0; c < C; ++c) wgt[c] = d * epow[C - 1 - c];
  const int nb = min(C, B - b0);       // the lane's cells inside the band
  // the step's unscaled fM rows, each thread's own cells
  float* const ring = reinterpret_cast<float*>(codes + 2 * t_bytes +
                                               2 * kQTileBytes);
  const int Rs = step_rows(Bp);

  float fm[C], fx[C], fy[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int b = b0 + c;
    const int j0 = lo_p + b;
    fm[c] = (j0 == 0 && b < B) ? 1.f : 0.f;
    fx[c] = 0.f;
    fy[c] = (j0 >= 1 && j0 <= n && b < B)
                ? d * powf(e, (float)(j0 - 1 > 0 ? j0 - 1 : 0))
                : 0.f;
  }
  if (lane == 0) {
    sh.edge[0][warp][0] = fm[0];
    sh.edge[0][warp][1] = fx[0];
  }
  fill_codes(codes, 2 * t_bytes + 2 * kQTileBytes);
  stage_bytes(codes + 2 * t_bytes, qp, 0, kTileRows, M);
  stage_bytes(codes, tp, 0, kTileRows - 1 + B, M + B);
  const bool vec = (C % 4) == 0 && (B % 4) == 0 && b0 + C <= B;
  const bool in_row = b0 < B;

  float S = 0.f;   // the plain version's running log-scale, row by row
  int step = 0;
  for (int i0 = 1; i0 <= m; i0 += Rs, ++step) {
    const int tile = (i0 - 1) / kTileRows;
    if ((i0 - 1) % kTileRows == 0) {
      cp_async_wait_all();
      __syncthreads();
      const int nb = (tile + 1) * kTileRows;
      if (nb < m) {
        const int k = (tile + 1) & 1;
        stage_bytes(codes + 2 * t_bytes + k * kQTileBytes, qp, nb,
                    nb + kTileRows, M);
        stage_bytes(codes + k * t_bytes, tp, nb, nb + kTileRows - 1 + B,
                    M + B);
      }
    }
    // the tile's codes, indexed by row and band cell
    const uint8_t* tb = codes + (tile & 1) * t_bytes - tile * kTileRows;
    const uint8_t* qb = codes + 2 * t_bytes + (tile & 1) * kQTileBytes -
                        tile * kTileRows;
    const int rows = min(Rs, m - i0 + 1);
    float pmax[R];
#pragma unroll
    for (int r = 0; r < R; ++r) pmax[r] = 0.f;
    // rows one at a time: unrolling them would multiply the code past
    // the instruction cache
    float emit[C];
    row_emissions<C>(sh.em, qb[i0 - 1], tb + i0 - 1 + b0, emit);
#pragma unroll 1
    for (int r = 0; r < rows; ++r) {
      const int i = i0 + r;
      const int par = i & 1;
      // the previous row's cells b0 + C (next lane or warp) for mX
      float upM = __shfl_down_sync(kFull, fm[0], 1);
      float upX = __shfl_down_sync(kFull, fx[0], 1);
      if (lane == 31) {
        const bool has = warp + 1 < nwarps;
        upM = has ? sh.edge[par ^ 1][warp + 1][0] : 0.f;
        upX = has ? sh.edge[par ^ 1][warp + 1][1] : 0.f;
      }
      const int jb = i + lo_p + b0;     // j of cell c is jb + c
      // cells c in [okM0, okM1) have 1 <= j <= n inside the band, and
      // those in [okM0 - 1, okM1) have 0 <= j <= n
      const int okM1 = min(n + 1 - jb, nb);
      const int okM0 = 1 - jb;
      // the row, with or without the masks at the matrix's edges
      auto row = [&](auto masked) {
        constexpr bool kMasked = decltype(masked)::value;
        float mM[C], mX[C], fold[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float fmu = c + 1 < C ? fm[c + 1] : upM;
          const float fxu = c + 1 < C ? fx[c + 1] : upX;
          const float vM = emit[c] * (tMM * fm[c] + omE * (fx[c] + fy[c]));
          mM[c] = !kMasked || (c >= okM0 && c < okM1) ? vM : 0.f;
          const float vX = d * fmu + e * fxu;
          mX[c] = !kMasked || (c >= okM0 - 1 && c < okM1) ? vX : 0.f;
          fold[c] = wgt[c] * mM[c];
        }
        // the lane's map w -> e^C w + a, summed as a tree
#pragma unroll
        for (int st = 1; st < C; st *= 2) {
#pragma unroll
          for (int c = 0; c + st < C; c += 2 * st)
            fold[c] = fold[c] + fold[c + st];
        }
        // exclusive carry into the lane: y at cell b0 - 1
        const float inc = warp_chain_scan<false>(fold[0], lev, lane);
        // the next row's emissions while the scan's shuffles are in flight
        if (r + 1 < rows) row_emissions<C>(sh.em, qb[i], tb + i + b0, emit);
        // the carry-free prefix y0[c] of each cell, off the chain
        float y0[C];
        y0[0] = 0.f;
#pragma unroll
        for (int c = 1; c < C; ++c) y0[c] = d * mM[c - 1] + e * y0[c - 1];
        float w = __shfl_up_sync(kFull, inc, 1);
        if (lane == 0) w = 0.f;
        if (nwarps > 1) {
          if (lane == 31) sh.tot[par][warp] = inc;
          if (lane == 0) {
            sh.edge[par][warp][0] = mM[0];
            sh.edge[par][warp][1] = mX[0];
          }
          __syncthreads();
          float cw = 0.f;
          for (int v = 0; v < warp; ++v) cw = warp_mult * cw + sh.tot[par][v];
          w = w + lane_mult * cw;
        }
        float tot[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float vY = y0[c] + epow[c] * w;
          const float mY = !kMasked || (c >= okM0 && c < okM1) ? vY : 0.f;
          fm[c] = mM[c];
          fx[c] = mX[c];
          fy[c] = mY;
          tot[c] = (mM[c] + mX[c]) + mY;
        }
        return tree_max<C>(tot);
      };
      // every cell of the band lies inside the matrix on most rows
      const bool inside = Bp == B && i + lo_p >= 1 && i + lo_p + B - 1 <= n;
      const float lmax = inside ? row(std::false_type{}) : row(std::true_type{});
      if (i == end_row && b_end >= b0 && b_end < b0 + C) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (b0 + c == b_end) {
            sh.end[0] = fm[c];
            sh.end[1] = fx[c];
            sh.end[2] = fy[c];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < R; ++k)
        if (k == r) pmax[k] = lmax;
      store_cells<C>(ring + r * Bp + b0, fm);
    }
    block_step_max<R>(pmax, sh.max[step & 1], lane, warp, nwarps);
    // the plain version's per-row scales: each row maximum over the one
    // before it (the step's carry has maximum 1)
    float prev = 1.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= rows) continue;
      const float mk = pmax[r];
      const float s = prev > 0.f ? fmaxf(mk / prev, kTiny) : kTiny;
      S = S + logf(s);
      if (t == r) lp[i0 + r - 1] = S;
      if (t == 0 && i0 + r == end_row) {
        const float mc = fmaxf(mk, kTiny);
        const float tot = sh.end[0] / mc + (sh.end[1] / mc + sh.end[2] / mc);
        logZ_out[p] = logf(fmaxf(tot, kTiny)) + S;
      }
      prev = mk;
    }
    // each row scaled by its own maximum, as the plain version stores it
    if (in_row) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= rows) continue;
        scale_cells<C>(ring + r * Bp + b0, fp + (size_t)(i0 + r - 1) * B + b0,
                       1.f / fmaxf(pmax[r], kTiny), nb, vec);
      }
    }
    const float inv = 1.f / fmaxf(pmax[rows - 1], kTiny);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      fm[c] = fm[c] * inv;
      fx[c] = fx[c] * inv;
      fy[c] = fy[c] * inv;
    }
    if (nwarps > 1 && lane == 0) {
      // the rescaled carry's boundary cells, for the next row's mX
      const int par = (i0 + rows - 1) & 1;
      sh.edge[par][warp][0] = fm[0];
      sh.edge[par][warp][1] = fx[0];
    }
    if (nwarps > 1) __syncthreads();
  }
  cp_async_wait_all();

  // past the pair's end every state is masked to exactly 0 and the row
  // scale is TINY
  const size_t done = (size_t)(m > 0 ? m : 0) * B;
  if ((B % 4) == 0) {
    float4* dst = reinterpret_cast<float4*>(fp + done);
    const size_t n4 = ((size_t)M * B - done) / 4;
    for (size_t k = t; k < n4; k += blockDim.x)
      dst[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (size_t k = done + t; k < (size_t)M * B; k += blockDim.x) fp[k] = 0.f;
  }
  if (t == 0) {
    const float ltiny = logf(kTiny);
    for (int i = (m > 0 ? m : 0) + 1; i <= M; ++i) {
      S = S + ltiny;
      lp[i - 1] = S;
      if (i == end_row) logZ_out[p] = ltiny + S;
    }
    if (M < end_row) logZ_out[p] = ltiny + S;
  }
}

template <int C, int kBound>
__global__ void __launch_bounds__(kBound)
pairhmm_bwd_kernel(const float* __restrict__ fM,
                   const float* __restrict__ lsF,
                   const float* __restrict__ logZ,
                   const uint8_t* __restrict__ q,
                   const uint8_t* __restrict__ t_shift,
                   const int* __restrict__ m_len,
                   const int* __restrict__ n_len,
                   const int* __restrict__ lo,
                   const float* __restrict__ em, int M, int B, float d,
                   float e, float tMM, float omE,
                   float* __restrict__ post) {
  constexpr int R = kStepRows;
  extern __shared__ float4 smem_f4[];
  __shared__ Shared sh;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const int Bp = blockDim.x * C;
  // two tile buffers of t_shift codes, then two of q codes
  uint8_t* const codes = reinterpret_cast<uint8_t*>(smem_f4);
  const int t_bytes = t_tile_bytes(Bp);

  const int p = blockIdx.x;
  const int b0 = t * C;
  const int lo_p = lo[p];
  const int m = m_len[p];
  const int n = n_len[p];
  const uint8_t* qp = q + (size_t)p * M;
  const uint8_t* tp = t_shift + (size_t)p * (M + B);
  const float* fp = fM + (size_t)p * M * B;
  const float* lsp = lsF + (size_t)p * M;
  float* pp = post + (size_t)p * M * B;
  const float lz = logZ[p];

  for (int k = t; k < 36; k += blockDim.x) sh.em[k] = em[k];
  // rows past the pair's end have zero posterior (every row when m_len
  // is 0, or beyond the padded row count, where no terminal row exists)
  const bool live = m >= 1 && m <= M;
  for (size_t k = (size_t)(live ? m : 0) * B + t; k < (size_t)M * B;
       k += blockDim.x)
    pp[k] = 0.f;
  if (!live) return;
  float lev[6], lane_mult;
  chain_constants<C>(e, 31 - lane, lev, &lane_mult);
  const float warp_mult = lev[5];
  // e^c, and the weight (1 - e) e^c of cell c in the lane's fold
  float epow[C], wgt[C];
  epow[0] = 1.f;
#pragma unroll
  for (int c = 1; c < C; ++c) epow[c] = epow[c - 1] * e;
#pragma unroll
  for (int c = 0; c < C; ++c) wgt[c] = omE * epow[c];
  const int nb = min(C, B - b0);       // the lane's cells inside the band
  const bool in_row = b0 < B;
  const bool vec = (C % 4) == 0 && (B % 4) == 0 && b0 + C <= B;
  // the step's rows of unscaled posteriors, each thread's own cells
  float* const ring = reinterpret_cast<float*>(codes + 2 * t_bytes +
                                               2 * kQTileBytes);
  const int Rb = step_rows(Bp);

  // terminal row i = m (the backward closed form at the pair's end) and
  // its posterior
  float bm[C], bx[C];
  {
    const float g = expf(fminf(fmaxf(lsp[m - 1] - lz, -60.f), 60.f));
    const float* frow = fp + (size_t)(m - 1) * B + b0;
    float* prow = pp + (size_t)(m - 1) * B + b0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int b = b0 + c;
      const int jn = n - (m + lo_p + b);
      bm[c] = b >= B ? 0.f
              : jn == 0
                  ? 1.f
                  : (jn > 0 ? d * powf(e, (float)(jn - 1 > 0 ? jn - 1 : 0))
                            : 0.f);
      bx[c] = (b < B && jn == 0) ? 1.f : 0.f;
      if (b < B) prow[c] = fminf(fmaxf((frow[c] * bm[c]) * g, 0.f), 1.5f);
    }
  }
  if (lane == 31) sh.edge[m & 1][warp][0] = bx[C - 1];
  // new rows r = m-1 .. 1 in tiles of kTileRows from the top
  fill_codes(codes, 2 * t_bytes + 2 * kQTileBytes);
  if (m > 1) {
    const int r_lo = max(1, m - kTileRows);
    stage_bytes(codes + 2 * t_bytes, qp, r_lo, m, M);
    stage_bytes(codes, tp, r_lo, m - 1 + B, M + B);
  }
  float fnext[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    fnext[c] = (m > 1 && b0 + c < B) ? fp[(size_t)(m - 2) * B + b0 + c] : 0.f;

  float S = 0.f;   // the plain version's running log-scale lsB
  int step = 0;
  for (int r0 = m - 1; r0 >= 1; r0 -= Rb, ++step) {
    const int tile = (m - 1 - r0) / kTileRows;
    if ((m - 1 - r0) % kTileRows == 0) {
      cp_async_wait_all();
      __syncthreads();
      const int nhi = r0 - kTileRows;       // the next tile's top row
      if (nhi >= 1) {
        const int nlo = max(1, nhi - kTileRows + 1);
        const int k = (tile + 1) & 1;
        stage_bytes(codes + 2 * t_bytes + k * kQTileBytes, qp, nlo, nhi + 1,
                    M);
        stage_bytes(codes + k * t_bytes, tp, nlo, nhi + B, M + B);
      }
    }
    // the tile's lowest row r_lo, staged from r_lo & ~3
    const int begin = max(1, m - (tile + 1) * kTileRows) & ~3;
    const uint8_t* qb = codes + 2 * t_bytes + (tile & 1) * kQTileBytes -
                        begin;
    const uint8_t* tb = codes + (tile & 1) * t_bytes - begin;
    const int rows = min(Rb, r0);
    // the step's rows' lsF, for their posterior factors at the step's end
    float lsf_r[R];
#pragma unroll
    for (int r = 0; r < R; ++r) lsf_r[r] = r < rows ? lsp[r0 - r - 1] : 0.f;
    float pmax[R];
#pragma unroll
    for (int r = 0; r < R; ++r) pmax[r] = 0.f;
    float emit[C];
    row_emissions<C>(sh.em, qb[r0], tb + r0 + b0, emit);
#pragma unroll 1
    for (int r = 0; r < rows; ++r) {
      const int i = r0 - r;           // the new row, from the carry row i+1
      const int par = i & 1;
      float fcur[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        fcur[c] = fnext[c];
        fnext[c] = (i > 1 && b0 + c < B) ? fp[(size_t)(i - 2) * B + b0 + c]
                                         : 0.f;
      }
      // the carry's cell b0 - 1 (previous lane or warp) for x
      float dnX = __shfl_up_sync(kFull, bx[C - 1], 1);
      if (lane == 0) dnX = warp > 0 ? sh.edge[par ^ 1][warp - 1][0] : 0.f;
      const int jb = i + lo_p + b0;     // jprev of cell c is jb + c
      // cells c < mm1 have jprev + 1 <= n inside the band; those in
      // [ok0, x1) have 0 <= jprev <= n, and in [ok0, ok1) inside the band
      const int mm1 = min(n - jb, nb);
      const int ok0 = -jb;
      const int x1 = n + 1 - jb;
      const int ok1 = min(x1, nb);
      // the row, with or without the masks at the matrix's edges
      auto row = [&](auto masked) {
        constexpr bool kMasked = decltype(masked)::value;
        float mm[C], xs[C], fold[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          mm[c] = !kMasked || c < mm1 ? emit[c] * bm[c] : 0.f;
          const float xv = c > 0 ? bx[c - 1] : dnX;
          xs[c] = !kMasked || (c >= ok0 && c < x1) ? xv : 0.f;
          fold[c] = wgt[c] * mm[c];
        }
        // the lane's map y -> e^C y + a (from above), summed as a tree
#pragma unroll
        for (int st = 1; st < C; st *= 2) {
#pragma unroll
          for (int c = 0; c + st < C; c += 2 * st)
            fold[c] = fold[c] + fold[c + st];
        }
        // exclusive carry into the lane from above: y at cell b0 + C
        const float inc = warp_chain_scan<true>(fold[0], lev, lane);
        if (r + 1 < rows)
          row_emissions<C>(sh.em, qb[i - 1], tb + i - 1 + b0, emit);
        // the carry-free y at cell c + 1, off the chain
        float y0[C];
        y0[C - 1] = 0.f;
#pragma unroll
        for (int c = C - 2; c >= 0; --c)
          y0[c] = omE * mm[c + 1] + e * y0[c + 1];
        float yn = __shfl_down_sync(kFull, inc, 1);
        if (lane == 31) yn = 0.f;
        if (nwarps > 1) {
          if (lane == 0) sh.tot[par][warp] = inc;
          if (lane == 31) {
            const bool ok = !kMasked || (C - 1 >= ok0 && C - 1 < ok1);
            sh.edge[par][warp][0] = ok ? omE * mm[C - 1] + e * xs[C - 1] : 0.f;
          }
          __syncthreads();
          float cw = 0.f;
          for (int v = nwarps - 1; v > warp; --v)
            cw = warp_mult * cw + sh.tot[par][v];
          yn = yn + lane_mult * cw;
        }
        float tot[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float ync = y0[c] + epow[C - 1 - c] * yn;  // y at cell c + 1
          const float y = omE * mm[c] + e * ync;
          const float nM = (tMM * mm[c] + d * xs[c]) + d * ync;
          const float nX = omE * mm[c] + e * xs[c];
          const bool ok = !kMasked || (c >= ok0 && c < ok1);
          bm[c] = ok ? nM : 0.f;
          bx[c] = ok ? nX : 0.f;
          tot[c] = (bm[c] + bx[c]) + (ok ? y : 0.f);
          fcur[c] = fcur[c] * bm[c];
        }
        return tree_max<C>(tot);
      };
      // every cell of the band lies inside the matrix on most rows
      const bool inside = Bp == B && i + lo_p >= 0 && i + lo_p + B <= n;
      const float lmax = inside ? row(std::false_type{}) : row(std::true_type{});
#pragma unroll
      for (int k = 0; k < R; ++k)
        if (k == r) pmax[k] = lmax;
      // fM x bM of the row, before its scale, in the thread's own cells
      // of the step's ring
      store_cells<C>(ring + r * Bp + b0, fcur);
    }
    block_step_max<R>(pmax, sh.max[step & 1], lane, warp, nwarps);
    // each row's posterior: fM x (bM over the row's maximum, as the plain
    // version scales it) x exp(clip(lsF + lsB - logZ)) with lsB the plain
    // version's running log-scale, so that the clip sees its exponent
    float g[R], inv_r[R];
    float prev = 1.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      g[r] = 0.f;
      inv_r[r] = 0.f;
      if (r >= rows) continue;
      const float mk = pmax[r];
      const float s = prev > 0.f ? fmaxf(mk / prev, kTiny) : kTiny;
      S = S + logf(s);
      g[r] = expf(fminf(fmaxf((lsf_r[r] + S) - lz, -60.f), 60.f));
      inv_r[r] = 1.f / fmaxf(mk, kTiny);
      prev = mk;
    }
    if (in_row) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= rows) continue;
        posterior_cells<C>(ring + r * Bp + b0,
                           pp + (size_t)(r0 - r - 1) * B + b0, inv_r[r], g[r],
                           nb, vec);
      }
    }
    const float inv = 1.f / fmaxf(pmax[rows - 1], kTiny);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      bm[c] = bm[c] * inv;
      bx[c] = bx[c] * inv;
    }
    if (nwarps > 1) {
      if (lane == 31) sh.edge[(r0 - rows + 1) & 1][warp][0] = bx[C - 1];
      __syncthreads();
    }
  }
  cp_async_wait_all();
}

// ---------------------------------------------------------- cluster rows

// Bands wider than the narrow kernels' kMaxWarps warps of 32 cells (16384)
// take the cluster kernels (the header sets out the design): one
// thread-block cluster a pair of up to kClusterMax CTAs on the pair's live
// windows, kClusterCells cells a lane.
constexpr int kClusterMax = 16;            // CTAs a cluster (non-portable past 8)
constexpr int kClusterCells = 8;           // cells a lane, rows in shared memory
constexpr int kClusterSmemWarps = 21;      // warps a CTA, rows in shared memory
constexpr int kClusterSmemThreads = 32 * kClusterSmemWarps;
// CTAs of up to 8 warps (windows up to 32,768 cells) take an instance
// bounded at 256 threads, whose lanes keep their cells in registers; the
// 672-thread bound leaves 80 registers a thread, and they spill
constexpr int kClusterSmallThreads = 256;
constexpr int kClusterThreads = 1024;      // threads a CTA, rows in global scratch
constexpr int kClusterWarps = kClusterThreads / 32;
// state rows a pair keeps: forward the step's kStepRows M rows, X and Y;
// backward the step's kStepRows rows of fM x bM, bM and bX; in global
// scratch two more rows hold the lanes' own cells of the row being
// computed (forward M and X, backward mm and x)
constexpr int kClusterFwdSmemRows = kStepRows + 2;
constexpr int kClusterBwdSmemRows = kStepRows + 2;
constexpr int kClusterFwdRows = kClusterFwdSmemRows + 2;
constexpr int kClusterBwdRows = kClusterBwdSmemRows + 2;

// What the other CTAs of a pair's cluster push into this CTA's shared
// memory for a row, double-buffered by row parity.
struct Ring {
  float tot[2][kClusterMax];   // each earlier (fwd) or later (bwd) CTA's
                               // chain total: the chain entering the CTA
                               // after (before) it from its own cells
  float near[2];               // fwd: the previous CTA's chain at its last
                               // cell; bwd: the next CTA's chain at its
                               // second cell (from its own cells)
  float lo[2][2];              // the next CTA's first cell: fwd M, X; bwd
                               // mm, x
  float hi[2][2];              // the previous CTA's last cell: fwd M, X;
                               // bwd bX
  float max[2][kStepRows][kClusterMax];  // every CTA's maxima of a step
};

struct ClusterSmem {
  float tot[2][kClusterWarps];       // each warp's chain total (as Ring)
  float near[2][kClusterWarps];      // and its near value (as Ring)
  float edge[2][kClusterWarps][4];   // fwd: first M, X, last M, X; bwd:
                                     // first mm, x, last bX
  float smax[kClusterWarps][kStepRows];   // each warp's step maxima
  Ring ring;
  float em[36];
  float end[3];                      // the end cell's M, X, Y (forward)
};

// The chain's constants for lanes of nc cells, warps of 32 lanes and CTAs
// of nw warps, by repeated products: e^(nc 2^l) (the warp scan), the
// lane's multiplier e^(nc lane_pos), e^(nc - 1), a warp's and a CTA's
// multipliers e^(32 nc) and e^(32 nc nw), and e^(32 nc - 1),
// e^(32 nc nw - 1) (a warp's and a CTA's cells but one).
struct Chain {
  float lev[6], lane_mult, enc1, E32, Ecta, e32m1, ectam1;
};

__device__ __forceinline__ float power(float x, int k) {
  float a = 1.f;
  for (int i = 0; i < k; ++i) a = a * x;
  return a;
}

__device__ Chain chain(float e, int nc, int nw, int lane_pos) {
  Chain K;
  K.enc1 = power(e, nc - 1);
  K.lev[0] = K.enc1 * e;
#pragma unroll
  for (int l = 1; l < 6; ++l) K.lev[l] = K.lev[l - 1] * K.lev[l - 1];
  K.E32 = K.lev[5];
  K.lane_mult = power(K.lev[0], lane_pos);
  K.e32m1 = power(K.lev[0], 31) * K.enc1;
  K.Ecta = power(K.E32, nw);
  K.ectam1 = K.e32m1 * power(K.E32, nw - 1);
  return K;
}

// Zeros the pair's (M, B) output outside the live windows of rows
// 1..live and over every row past it, coalesced over the cluster's lanes
// (thread `first` of `step`); the rows then store their windows.
__device__ void zero_outside(float* base, int M, int B, int live, int n,
                             int lo, int first, int step) {
  const int rows = max(0, min(live, M));
  for (int i = 1; i <= rows; ++i) {
    float* row = base + (size_t)(i - 1) * B;
    const Window w = window(i, n, lo, B);
    const int a = w.wd > 0 ? w.jlo - i - lo : B;
    const int b = w.wd > 0 ? a + w.wd : B;
    for (int x = first; x < a; x += step) row[x] = 0.f;
    for (int x = b + first; x < B; x += step) row[x] = 0.f;
  }
  float* rest = base + (size_t)rows * B;
  const size_t cells = (size_t)(M - rows) * B;
  if ((cells & 3) == 0 && (reinterpret_cast<uintptr_t>(rest) & 15) == 0) {
    float4* r4 = reinterpret_cast<float4*>(rest);
    for (size_t k = first; k < cells / 4; k += step)
      r4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (size_t k = first; k < cells; k += step) rest[k] = 0.f;
  }
}

// Warp 0, after the block barrier: the CTA's chain total (Horner's rule in
// e^(32 nc) over its warps' totals, from the first warp forward and from
// the last backward) and near value, pushed with the CTA's edge cells into
// the rings of the CTAs that read them.
template <bool kBwd>
__device__ void cta_push(ClusterSmem& s, int par, int nw, const Chain& K) {
  cg::cluster_group cl = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  const int rank = (int)cl.block_rank();
  const int ctas = (int)cl.num_blocks();
  float T = 0.f, Tb = 0.f;
  for (int k = 0; k < nw; ++k) {
    const int v = kBwd ? nw - 1 - k : k;
    if (k == nw - 1) Tb = T;
    T = K.E32 * T + s.tot[par][v];
  }
  const int edge_w = kBwd ? 0 : nw - 1;
  const float nearC = s.near[par][edge_w] + K.e32m1 * Tb;
  if (lane < ctas) {
    Ring* r = cl.map_shared_rank(&s.ring, lane);
    if (kBwd ? lane < rank : lane > rank) r->tot[par][rank] = T;
    if (lane == (kBwd ? rank - 1 : rank + 1)) r->near[par] = nearC;
    if (lane == rank - 1) {
      r->lo[par][0] = s.edge[par][0][0];
      r->lo[par][1] = s.edge[par][0][1];
    }
    if (lane == rank + 1) {
      r->hi[par][0] = s.edge[par][nw - 1][2];
      r->hi[par][1] = s.edge[par][nw - 1][3];
    }
  }
}

// Warp 0: the CTA's maxima of the step's rows (lane l: row l % 8), pushed
// into every CTA's ring.max[par][row][rank].
__device__ void cta_push_max(ClusterSmem& s, int par, int nw) {
  cg::cluster_group cl = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  const int r = lane & (kStepRows - 1);
  float v = 0.f;
  for (int w = 0; w < nw; ++w) v = fmaxf(v, s.smax[w][r]);
  const int rank = (int)cl.block_rank();
  for (int dst = lane / kStepRows; dst < (int)cl.num_blocks();
       dst += 32 / kStepRows)
    cl.map_shared_rank(&s.ring, dst)->max[par][r][rank] = v;
}

// Every warp, after the cluster barrier: the cluster's maxima of the
// step's rows from the ring, into every lane's mx.
__device__ __forceinline__ void step_maxima(const ClusterSmem& s, int par,
                                            int ctas, float (&mx)[kStepRows]) {
  const int lane = threadIdx.x & 31;
  float v = 0.f;
  for (int src = lane / kStepRows; src < ctas; src += 32 / kStepRows)
    v = fmaxf(v, s.ring.max[par][lane & (kStepRows - 1)][src]);
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 8));
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 16));
#pragma unroll
  for (int r = 0; r < kStepRows; ++r) mx[r] = __shfl_sync(kFull, v, r);
}

// The lanes' step maxima, a butterfly per row, into s.smax[warp]; resets
// them.
__device__ __forceinline__ void warp_step_max(ClusterSmem& s,
                                              float (&pmax)[kStepRows]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kStepRows; ++r) {
    float v = pmax[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
    if (lane == 0) s.smax[threadIdx.x >> 5][r] = v;
    pmax[r] = 0.f;
  }
}

// The carry entering this thread's CTA and warp: Horner's rule over the
// chain totals of the CTAs before it (kBwd: after it) in its ring and of
// the warps before (after) it in its CTA.  *nb_cta and *nb_warp get the
// carry entering the neighbouring CTA and warp before (after) it.
template <bool kBwd>
__device__ __forceinline__ float carry_in(const ClusterSmem& s, int par,
                                          int rank, int ctas, int warp,
                                          int nw, const Chain& K,
                                          float* nb_cta, float* nb_warp) {
  float c = 0.f, cn = 0.f;
  const int cs = kBwd ? ctas - 1 - rank : rank;
  for (int k = 0; k < cs; ++k) {
    if (k == cs - 1) cn = c;
    c = K.Ecta * c + s.ring.tot[par][kBwd ? ctas - 1 - k : k];
  }
  float wn = 0.f;
  const int ws = kBwd ? nw - 1 - warp : warp;
  for (int k = 0; k < ws; ++k) {
    if (k == ws - 1) wn = c;
    c = K.E32 * c + s.tot[par][kBwd ? nw - 1 - k : k];
  }
  *nb_cta = cn;
  *nb_warp = wn;
  return c;
}

// A row's exchange, by every thread of the cluster: the block barrier,
// warp 0 pushes the CTA's total, near value and edge cells (when `chain`)
// and the step's maxima (when `maxima`), and the cluster barrier.
template <bool kBwd>
__device__ __forceinline__ void exchange(ClusterSmem& s, int par, int nw,
                                         const Chain& K, bool chain,
                                         bool maxima) {
  __syncthreads();
  if ((threadIdx.x >> 5) == 0) {
    if (chain) cta_push<kBwd>(s, par, nw, K);
    if (maxima) cta_push_max(s, par, nw);
  }
  cg::this_cluster().sync();
}

template <int C, bool kSmem, int kThreads>
__global__ void __launch_bounds__(kThreads)
pairhmm_fwd_cluster_kernel(const uint8_t* __restrict__ q,
                           const uint8_t* __restrict__ t_shift,
                           const int* __restrict__ m_len,
                           const int* __restrict__ n_len,
                           const int* __restrict__ lo,
                           const float* __restrict__ em, int M, int B,
                           float d, float e, float tMM, float omE, int cells,
                           float* scratch, float* __restrict__ fM_out,
                           float* __restrict__ lsF_out,
                           float* __restrict__ logZ_out) {
  constexpr int R = kStepRows;
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
  const int k0 = L * nc;              // the lane's first window cell
  const int kw0 = (L - lane) * nc;    // its warp's first
  // the state rows: the CTA's window cells in order in shared memory
  // (one pad word in 33), or cell c of the cluster's lane L at c lanes + L
  // in the pair's global scratch; word(dl, c): cell c of the lane dl lanes
  // on
  const size_t RW = kSmem ? (size_t)row_words(T * nc) : (size_t)lanes * nc;
  const int p = blockIdx.x / ctas;
  float* rows = kSmem ? reinterpret_cast<float*>(smem_f4)
                      : scratch + (size_t)p * kClusterFwdRows * RW;
  auto word = [&](int dl, int c) -> size_t {
    return kSmem ? (size_t)pix((t + dl) * nc + c)
                 : (size_t)c * lanes + (L + dl);
  };
  // the step's M rows (row i in rows + (i % R) RW), then X and Y of the
  // row before
  float* const sX = rows + R * RW;
  float* const sY = sX + RW;
  Cells<C, kSmem> rM, rX;
  rM.bind(sY + RW + L, lanes);
  rX.bind(sY + 2 * RW + L, lanes);

  const int lo_p = lo[p];
  const int m = min(m_len[p], M);
  const int n = n_len[p];
  const int end_row = m > 1 ? m : 1;
  const uint8_t* qp = q + (size_t)p * M;
  const uint8_t* tp = t_shift + (size_t)p * (M + B);
  float* fp = fM_out + (size_t)p * M * B;
  float* lp = lsF_out + (size_t)p * M;

  for (int k = t; k < 36; k += T) s.em[k] = em[k];
  if (t < 3) s.end[t] = 0.f;
  const Chain K = chain(e, nc, nw, lane);
  zero_outside(fp, M, B, m, n, lo_p, L, lanes);

  // row 0: M at j == 0, the Y chain it seeds; the cells across the lane's
  // warp edge by the same closed form
  Window win = window(0, n, lo_p, B);
  auto row0 = [&](int k, float* v) {
    const int j = win.jlo + k;
    const bool ok = k >= 0 && k < win.wd;
    v[0] = ok && j == 0 ? 1.f : 0.f;
    v[1] = 0.f;
    v[2] = ok && j >= 1 ? d * powf(e, (float)(j - 1)) : 0.f;
  };
#pragma unroll
  for (int c = 0; c < nc; ++c) {
    float v[3];
    row0(k0 + c, v);
    const size_t o = word(0, c);
    rows[o] = v[0];
    sX[o] = v[1];
    sY[o] = v[2];
  }
  // the previous warp's last (M, X, Y) and the next warp's first (M, X)
  float nbL[3] = {0.f, 0.f, 0.f}, nbR[3] = {0.f, 0.f, 0.f};
  if (lane == 0 && L > 0) row0(k0 - 1, nbL);
  if (lane == 31 && L + 1 < lanes) row0(k0 + nc, nbR);
  float S = 0.f;   // the plain version's running log-scale (lane L == 0)
  float pmax[R];
#pragma unroll
  for (int r = 0; r < R; ++r) pmax[r] = 0.f;
  // row i's query code and its target codes at the lane's cells, loaded a
  // row ahead (the global-scratch instance loads the target codes when it
  // uses them)
  int qcode = m >= 1 ? qp[0] : 0;
  int tcode[kSmem ? C : 1];
  if constexpr (kSmem) {
    const Window w = window(1, n, lo_p, B);
    const uint8_t* trow = tp + (w.jlo - 1 - lo_p);
#pragma unroll
    for (int c = 0; c < C; ++c)
      tcode[c] = m >= 1 && k0 + c < w.wd ? trow[k0 + c] : 5;
  }

  // the step's rows first .. first + nrows - 1 (their M rows as computed,
  // mx their maxima) divided by their maxima into fM; lane L == 0 keeps
  // the plain version's log-scale (and logZ at the end row)
  auto store_step = [&](int first, int nrows, const float(&mx)[R]) {
    float prev = 1.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= nrows) continue;
      const int row = first + r;
      const Window wr = window(row, n, lo_p, B);
      const float inv = 1.f / fmaxf(mx[r], kTiny);
      const float* src = rows + (row % R) * RW;
      float* dst = fp + (size_t)(row - 1) * B + (wr.jlo - row - lo_p);
#pragma unroll
      for (int j = 0; j < nc; ++j) {
        const int kl = 32 * j + lane;
        if (kw0 + kl < wr.wd)
          dst[kw0 + kl] = src[word(kl / nc - lane, kl % nc)] * inv;
      }
      if (L == 0) {
        const float mk = mx[r];
        const float sc = prev > 0.f ? fmaxf(mk / prev, kTiny) : kTiny;
        S = S + logf(sc);
        lp[row - 1] = S;
        if (row == end_row) {
          const float mc = fmaxf(mk, kTiny);
          const float tot = s.end[0] / mc + (s.end[1] / mc + s.end[2] / mc);
          logZ_out[p] = logf(fmaxf(tot, kTiny)) + S;
        }
        prev = mk;
      }
    }
    __syncwarp();   // the warp's cells are read before they are stored
  };

  __syncwarp();
  for (int i = 1; i <= m; ++i) {
    const Window prev = win;
    win = window(i, n, lo_p, B);
    const int dl = win.jlo - prev.jlo;
    const int par = i & 1;
    const int bb = win.jlo - i - lo_p;
    const int r = (i - 1) % R;
    const float* pM = rows + ((i - 1) % R) * RW;
    const float* erow = s.em + 6 * qcode;
    // pass 1: M from the row before at k - 1 + dl, X at k + dl (own
    // cells, the neighbour lane's, or across the warp edge)
#pragma unroll
    for (int c = 0; c < nc; ++c) {
      const int k = k0 + c;
      float fm, fx, fy;
      if (dl == 1 || c > 0) {
        const size_t o = word(0, c - 1 + dl);
        fm = pM[o];
        fx = sX[o];
        fy = sY[o];
      } else if (k0 == 0) {
        fm = fx = fy = 0.f;
      } else if (lane == 0) {
        fm = nbL[0];
        fx = nbL[1];
        fy = nbL[2];
      } else {
        const size_t o = word(-1, nc - 1);
        fm = pM[o];
        fx = sX[o];
        fy = sY[o];
      }
      float fmu, fxu;
      if (dl == 0 || c + 1 < nc) {
        const size_t o = word(0, c + dl);
        fmu = pM[o];
        fxu = sX[o];
      } else if (L + 1 == lanes) {
        fmu = fxu = 0.f;
      } else if (lane == 31) {
        fmu = nbR[0];
        fxu = nbR[1];
      } else {
        const size_t o = word(1, 0);
        fmu = pM[o];
        fxu = sX[o];
      }
      const bool okx = k < win.wd;
      const bool ok = okx && win.jlo + k >= 1;
      int code;
      if constexpr (kSmem) {
        code = tcode[c];
      } else {
        code = okx ? tp[i - 1 + bb + k] : 5;
      }
      const float emit = okx ? erow[code] : 0.f;
      rM[c] = ok ? emit * (tMM * fm + omE * (fx + fy)) : 0.f;
      rX[c] = okx ? d * fmu + e * fxu : 0.f;
    }
    if (i < m) {   // the next row's codes
      const Window w = window(i + 1, n, lo_p, B);
      const uint8_t* trow = tp + (w.jlo - 1 - lo_p);
      qcode = qp[i];
      if constexpr (kSmem) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          tcode[c] = k0 + c < w.wd ? trow[k0 + c] : 5;
      }
    }
    // the lane's map w -> e^nc w + sum_c d e^(nc-1-c) M[c] of the chain
    // Y[k] = d M[k - 1] + e Y[k - 1], the warp's scan, the warp's total
    // and near value (its chain at its last cell from its own cells)
    float fold = 0.f;
#pragma unroll
    for (int c = 0; c < nc; ++c) fold = e * fold + d * rM[c];
    const float inc = warp_chain_scan<false>(fold, K.lev, lane);
    float w = __shfl_up_sync(kFull, inc, 1);
    if (lane == 0) w = 0.f;
    if (lane == 31) {
      float y0 = 0.f;
#pragma unroll
      for (int c = 1; c < nc; ++c) y0 = d * rM[c - 1] + e * y0;
      s.tot[par][warp] = inc;
      s.near[par][warp] = y0 + K.enc1 * w;
      s.edge[par][warp][2] = rM[nc - 1];
      s.edge[par][warp][3] = rX[nc - 1];
    }
    if (lane == 0) {
      s.edge[par][warp][0] = rM[0];
      s.edge[par][warp][1] = rX[0];
    }
    // the step before ends here: its maxima travel in this exchange
    const bool scaled = r == 0 && i > 1;
    exchange<false>(s, par, nw, K, true, scaled);

    // pass 2: the carry, the step before stored, the chain from the exact
    // carry, the row rescaled by the step before's last maximum
    float c_nb, w_nb;
    const float cw =
        carry_in<false>(s, par, rank, ctas, warp, nw, K, &c_nb, &w_nb);
    w = w + K.lane_mult * cw;
    float g = 1.f;
    if (scaled) {
      float mx[R];
      step_maxima(s, par, ctas, mx);
      g = 1.f / fmaxf(mx[R - 1], kTiny);
      store_step(i - R, R, mx);
    }
    float* const cM = rows + (i % R) * RW;
    float pm = 0.f, y0 = 0.f, ep = 1.f;
#pragma unroll
    for (int c = 0; c < nc; ++c) {
      const int k = k0 + c;
      const bool ok = k < win.wd && win.jlo + k >= 1;
      const float vY = (ok ? y0 + ep * w : 0.f) * g;
      const float vM = rM[c] * g;
      const float vX = rX[c] * g;
      y0 = d * rM[c] + e * y0;
      ep = ep * e;
      pm = fmaxf(pm, (vM + vX) + vY);
      const size_t o = word(0, c);
      cM[o] = vM;
      sX[o] = vX;
      sY[o] = vY;
      if (i == end_row && k < win.wd && win.jlo + k == n) {
        float* en = cl.map_shared_rank(s.end, 0);
        en[0] = vM;
        en[1] = vX;
        en[2] = vY;
      }
    }
#pragma unroll
    for (int q2 = 0; q2 < R; ++q2)
      if (q2 == r) pmax[q2] = pm;
    // the cells across the warp edges for the next row: the pass-1 M and
    // X of the next warp's first cell, and of the previous warp's last
    // cell with its Y from its near value and the carry entering it
    if (lane == 31 && L + 1 < lanes) {
      const float* ed = warp + 1 < nw ? s.edge[par][warp + 1]
                                      : s.ring.lo[par];
      nbR[0] = ed[0] * g;
      nbR[1] = ed[1] * g;
    }
    if (lane == 0 && L > 0) {
      const float* ed = warp > 0 ? &s.edge[par][warp - 1][2]
                                 : s.ring.hi[par];
      const int kl = k0 - 1;
      const bool okl = kl < win.wd && win.jlo + kl >= 1;
      const float yl = warp > 0 ? s.near[par][warp - 1] + K.e32m1 * w_nb
                                : s.ring.near[par] + K.ectam1 * c_nb;
      nbL[0] = ed[0] * g;
      nbL[1] = ed[1] * g;
      nbL[2] = (okl ? yl : 0.f) * g;
    }
    if (r == R - 1 || i == m) warp_step_max(s, pmax);
    __syncwarp();
  }
  if (m >= 1) {
    // the last step's maxima, then its rows (the end cell's sum has
    // reached CTA 0 with them)
    const int par = (m + 1) & 1;
    exchange<false>(s, par, nw, K, false, true);
    float mx[R];
    step_maxima(s, par, ctas, mx);
    const int first = (m - 1) / R * R + 1;
    store_step(first, m - first + 1, mx);
  }
  if (L == 0) {
    // rows past m: every state masked to 0, the row scale TINY
    const float ltiny = logf(kTiny);
    for (int i = (m > 0 ? m : 0) + 1; i <= M; ++i) {
      S = S + ltiny;
      lp[i - 1] = S;
      if (i == end_row) logZ_out[p] = ltiny + S;
    }
    if (M < end_row) logZ_out[p] = ltiny + S;
  }
}

template <int C, bool kSmem, int kThreads>
__global__ void __launch_bounds__(kThreads)
pairhmm_bwd_cluster_kernel(const float* __restrict__ fM,
                           const float* __restrict__ lsF,
                           const float* __restrict__ logZ,
                           const uint8_t* __restrict__ q,
                           const uint8_t* __restrict__ t_shift,
                           const int* __restrict__ m_len,
                           const int* __restrict__ n_len,
                           const int* __restrict__ lo,
                           const float* __restrict__ em, int M, int B,
                           float d, float e, float tMM, float omE, int cells,
                           float* scratch, float* __restrict__ post) {
  constexpr int R = kStepRows;
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
  const int kw0 = (L - lane) * nc;
  const size_t RW = kSmem ? (size_t)row_words(T * nc) : (size_t)lanes * nc;
  const int p = blockIdx.x / ctas;
  float* rows = kSmem ? reinterpret_cast<float*>(smem_f4)
                      : scratch + (size_t)p * kClusterBwdRows * RW;
  auto word = [&](int dl, int c) -> size_t {
    return kSmem ? (size_t)pix((t + dl) * nc + c)
                 : (size_t)c * lanes + (L + dl);
  };
  // the step's rows of fM x bM (row i in rows + (i % R) RW), then bM and
  // bX of the row after (bY of a row feeds only its maximum)
  float* const sM = rows + R * RW;
  float* const sX = sM + RW;
  Cells<C, kSmem> rMM, rX;
  rMM.bind(sX + RW + L, lanes);
  rX.bind(sX + 2 * RW + L, lanes);

  const int lo_p = lo[p];
  const int m = m_len[p];
  const int n = n_len[p];
  const uint8_t* qp = q + (size_t)p * M;
  const uint8_t* tp = t_shift + (size_t)p * (M + B);
  const float* fp = fM + (size_t)p * M * B;
  const float* lsp = lsF + (size_t)p * M;
  float* pp = post + (size_t)p * M * B;

  for (int k = t; k < 36; k += T) s.em[k] = em[k];
  // rows past the pair's end have zero posterior (every row when m_len
  // is 0, or beyond the padded row count, where no terminal row exists)
  const bool live = m >= 1 && m <= M;
  zero_outside(pp, M, B, live ? m : 0, n, lo_p, L, lanes);
  if (!live) return;   // the whole cluster: no shared memory is read
  const float lz = logZ[p];
  const Chain K = chain(e, nc, nw, 31 - lane);

  // terminal row i = m (the backward closed form at the pair's end); the
  // cells across the lane's warp edge by the same closed form
  Window win = window(m, n, lo_p, B);
  auto term = [&](int k, float* v) {
    const int jn = n - (win.jlo + k);
    const bool ok = k >= 0 && k < win.wd;
    v[0] = !ok ? 0.f : jn == 0 ? 1.f : d * powf(e, (float)(jn - 1));
    v[1] = ok && jn == 0 ? 1.f : 0.f;
  };
#pragma unroll
  for (int c = 0; c < nc; ++c) {
    float v[2];
    term(k0 + c, v);
    const size_t o = word(0, c);
    sM[o] = v[0];
    sX[o] = v[1];
  }
  // the next warp's first bM and the previous warp's last bX
  float nbR = 0.f, nbL = 0.f;
  if (lane == 31 && L + 1 < lanes) {
    float v[2];
    term(k0 + nc, v);
    nbR = v[0];
  }
  if (lane == 0 && L > 0) {
    float v[2];
    term(k0 - 1, v);
    nbL = v[1];
  }
  __syncwarp();
  // the terminal row's posterior (its log-scale is 0)
  {
    const float g = expf(fminf(fmaxf(lsp[m - 1] - lz, -60.f), 60.f));
    const int bb = win.jlo - m - lo_p;
    const float* src = sM;
    const float* frow = fp + (size_t)(m - 1) * B + bb;
    float* prow = pp + (size_t)(m - 1) * B + bb;
#pragma unroll
    for (int j = 0; j < nc; ++j) {
      const int kl = 32 * j + lane;
      if (kw0 + kl < win.wd)
        prow[kw0 + kl] = fminf(
            fmaxf((frow[kw0 + kl] * src[word(kl / nc - lane, kl % nc)]) * g,
                  0.f),
            1.5f);
    }
  }
  float S = 0.f;   // the plain version's running log-scale lsB
  float pmax[R];
#pragma unroll
  for (int r = 0; r < R; ++r) pmax[r] = 0.f;
  // the new row's query code and target codes, and fM, at the lane's
  // cells, loaded a row ahead (the global-scratch instance loads the
  // target codes and fM when it uses them)
  int qcode = m >= 2 ? qp[m - 1] : 0;
  int tcode[kSmem ? C : 1];
  float fcur[kSmem ? C : 1];
  if constexpr (kSmem) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      tcode[c] = 5;
      fcur[c] = 0.f;
    }
    if (m >= 2) {
      const Window w = window(m - 1, n, lo_p, B);
      const int bbr = w.jlo - (m - 1) - lo_p;
      const uint8_t* trow = tp + (m - 1) + bbr;
      const float* frow = fp + (size_t)(m - 2) * B + bbr;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (k0 + c < w.wd) {
          tcode[c] = trow[k0 + c];
          fcur[c] = frow[k0 + c];
        }
      }
    }
  }

  // the step's rows r0, r0 - 1, .. (nrows of them; their fM x bM rows as
  // computed, mx their maxima): each row's posterior fM x (bM over the
  // row's maximum) x exp(clip(lsF + lsB - logZ)) with lsB the plain
  // version's running log-scale, so that the clip sees its exponent
  auto store_step = [&](int r0, int nrows, const float(&mx)[R]) {
    float lsf[R];
#pragma unroll
    for (int r = 0; r < R; ++r) lsf[r] = r < nrows ? lsp[r0 - r - 1] : 0.f;
    float prev = 1.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= nrows) continue;
      const int row = r0 - r;
      const float mk = mx[r];
      const float sc = prev > 0.f ? fmaxf(mk / prev, kTiny) : kTiny;
      S = S + logf(sc);
      prev = mk;
      const float g = expf(fminf(fmaxf((lsf[r] + S) - lz, -60.f), 60.f));
      const float inv = 1.f / fmaxf(mk, kTiny);
      const Window wr = window(row, n, lo_p, B);
      const int bb = wr.jlo - row - lo_p;
      const float* src = rows + (row % R) * RW;
      float* prow = pp + (size_t)(row - 1) * B + bb;
#pragma unroll
      for (int j = 0; j < nc; ++j) {
        const int kl = 32 * j + lane;
        if (kw0 + kl < wr.wd)
          prow[kw0 + kl] = fminf(
              fmaxf((src[word(kl / nc - lane, kl % nc)] * inv) * g, 0.f),
              1.5f);
      }
    }
    __syncwarp();   // the warp's cells are read before they are stored
  };

  for (int i = m - 1; i >= 1; --i) {   // row i from the carry row i + 1
    const Window cur = win;
    win = window(i, n, lo_p, B);
    const int dl = cur.jlo - win.jlo;
    const int par = i & 1;
    const int bb = win.jlo - i - lo_p;
    const int r = (m - 1 - i) % R;
    const float* erow = s.em + 6 * qcode;
    // pass 1: mm from bM at k + 1 - dl, x from bX at k - dl of row i + 1
#pragma unroll
    for (int c = 0; c < nc; ++c) {
      const int k = k0 + c;
      float bmv;
      if (dl == 1 || c + 1 < nc) {
        bmv = sM[word(0, c + 1 - dl)];
      } else if (L + 1 == lanes) {
        bmv = 0.f;
      } else if (lane == 31) {
        bmv = nbR;
      } else {
        bmv = sM[word(1, 0)];
      }
      float xv;
      if (dl == 0 || c > 0) {
        xv = sX[word(0, c - dl)];
      } else if (k0 == 0) {
        xv = 0.f;
      } else if (lane == 0) {
        xv = nbL;
      } else {
        xv = sX[word(-1, nc - 1)];
      }
      const bool okp = k < win.wd;
      const bool okm = okp && win.jlo + k + 1 <= n;
      int code;
      if constexpr (kSmem) {
        code = tcode[c];
      } else {
        code = okp ? tp[i + bb + k] : 5;
      }
      rMM[c] = okm ? erow[code] * bmv : 0.f;
      rX[c] = okp ? xv : 0.f;
    }
    if (i > 1) {   // the next row's codes
      const Window w = window(i - 1, n, lo_p, B);
      const uint8_t* trow = tp + (w.jlo - lo_p);
      qcode = qp[i - 1];
      if constexpr (kSmem) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          tcode[c] = k0 + c < w.wd ? trow[k0 + c] : 5;
      }
    }
    // the lane's map y -> e^nc y + sum_c (1 - e) e^c mm[c] (from the
    // right) of the chain y[k] = (1 - e) mm[k] + e y[k + 1], the warp's
    // reverse scan, the warp's total and near value (its chain at its
    // second cell from its own cells)
    float fold = 0.f;
#pragma unroll
    for (int c = nc - 1; c >= 0; --c) fold = e * fold + omE * rMM[c];
    const float inc = warp_chain_scan<true>(fold, K.lev, lane);
    float yn = __shfl_down_sync(kFull, inc, 1);
    if (lane == 31) yn = 0.f;
    if (lane == 0) {
      float y0 = 0.f;
#pragma unroll
      for (int c = nc - 2; c >= 0; --c) y0 = omE * rMM[c + 1] + e * y0;
      s.tot[par][warp] = inc;
      s.near[par][warp] = y0 + K.enc1 * yn;
      s.edge[par][warp][0] = rMM[0];
      s.edge[par][warp][1] = rX[0];
    }
    if (lane == 31)
      s.edge[par][warp][2] =
          k0 + nc - 1 < win.wd ? omE * rMM[nc - 1] + e * rX[nc - 1] : 0.f;
    const bool scaled = r == 0 && i < m - 1;
    exchange<true>(s, par, nw, K, true, scaled);

    // pass 2 (descending): the carry, the step before stored, the chain
    // from the exact carry, the row rescaled by the step before's last
    // maximum
    float c_nb, w_nb;
    const float cw =
        carry_in<true>(s, par, rank, ctas, warp, nw, K, &c_nb, &w_nb);
    yn = yn + K.lane_mult * cw;
    float g = 1.f;
    if (scaled) {
      float mx[R];
      step_maxima(s, par, ctas, mx);
      g = 1.f / fmaxf(mx[R - 1], kTiny);
      store_step(i + R, R, mx);
    }
    float* const cB = rows + (i % R) * RW;
    const float* frow = fp + (size_t)(i - 1) * B + bb;
    float pm = 0.f, y0 = 0.f, ep = 1.f;
#pragma unroll
    for (int c = nc - 1; c >= 0; --c) {
      const int k = k0 + c;
      const float mm = rMM[c], xs = rX[c];
      float f;
      if constexpr (kSmem) {
        f = fcur[c];
      } else {
        f = k < win.wd ? frow[k] : 0.f;
      }
      const float ync = y0 + ep * yn;   // the chain at cell c + 1
      const float y = omE * mm + e * ync;
      const bool ok = k < win.wd;
      const float vM = (ok ? (tMM * mm + d * xs) + d * ync : 0.f) * g;
      const float vX = (ok ? omE * mm + e * xs : 0.f) * g;
      const float vY = (ok ? y : 0.f) * g;
      y0 = omE * mm + e * y0;
      ep = ep * e;
      pm = fmaxf(pm, (vM + vX) + vY);
      const size_t o = word(0, c);
      cB[o] = f * vM;
      sM[o] = vM;
      sX[o] = vX;
    }
    if constexpr (kSmem) {   // the next row's fM
      if (i > 1) {
        const Window w = window(i - 1, n, lo_p, B);
        const float* frow =
            fp + (size_t)(i - 2) * B + (w.jlo - (i - 1) - lo_p);
#pragma unroll
        for (int c = 0; c < C; ++c)
          fcur[c] = k0 + c < w.wd ? frow[k0 + c] : 0.f;
      }
    }
#pragma unroll
    for (int q2 = 0; q2 < R; ++q2)
      if (q2 == r) pmax[q2] = pm;
    // the cells across the warp edges for the next row: the next warp's
    // first bM from its pass-1 mm and x and its chain at its second cell
    // (its near value and the carry entering it), the previous warp's
    // last bX
    if (lane == 31 && L + 1 < lanes) {
      const bool in_cta = warp + 1 < nw;
      const float* ed = in_cta ? s.edge[par][warp + 1] : s.ring.lo[par];
      const float y2 = in_cta ? s.near[par][warp + 1] + K.e32m1 * w_nb
                              : s.ring.near[par] + K.ectam1 * c_nb;
      nbR = k0 + nc < win.wd ? ((tMM * ed[0] + d * ed[1]) + d * y2) * g
                             : 0.f;
    }
    if (lane == 0 && L > 0)
      nbL = (warp > 0 ? s.edge[par][warp - 1][2] : s.ring.hi[par][0]) * g;
    if (r == R - 1 || i == 1) warp_step_max(s, pmax);
    __syncwarp();
  }
  if (m >= 2) {
    // the last step's maxima, then its rows
    exchange<true>(s, 0, nw, K, false, true);
    float mx[R];
    step_maxima(s, 0, ctas, mx);
    const int r0 = (m - 2) % R + 1;
    store_step(r0, r0, mx);
  }
}

// Cells a lane and threads a block for band B: C = B / 256 rounded up to
// a power of two, within 4..16 (at most 8 warps a pair up to band 4096;
// measured on the H100, 4 warps at band 512 and 8 at band 2048 beat
// both fewer and more), 32 where 16 would need more than kMaxWarps warps.
void launch_shape(int B, int* C, int* threads) {
  int c = 4;
  while (c < 16 && 256 * c < B) c *= 2;
  if (32 * kMaxWarps * c < B) c = 32;
  *C = c;
  *threads = 32 * ((B + 32 * c - 1) / (32 * c));
}

size_t smem_bytes(int C, int threads) {
  return 2 * (size_t)t_tile_bytes(C * threads) + 2 * (size_t)kQTileBytes;
}

size_t step_smem_bytes(int C, int threads) {
  const int Bp = C * threads;
  return smem_bytes(C, threads) + (size_t)step_rows(Bp) * Bp * 4;
}

struct Args {
  const uint8_t* q;
  const uint8_t* t;
  const int* m;
  const int* n;
  const int* lo;
  const float* em;
  int P, M, B;
  float d, e, tMM, omE;
  cudaStream_t stream;
};

template <int C, int kBound>
cudaError_t fwd_launch(const Args& a, int threads, float* fM, float* lsF,
                       float* logZ) {
  static size_t allowed = 48 * 1024;
  const size_t smem = step_smem_bytes(C, threads);
  const cudaError_t err =
      allow_smem(pairhmm_fwd_kernel<C, kBound>, smem, &allowed);
  if (err != cudaSuccess) return err;
  pairhmm_fwd_kernel<C, kBound><<<a.P, threads, smem, a.stream>>>(
          a.q, a.t, a.m, a.n, a.lo, a.em, a.M, a.B, a.d, a.e, a.tMM, a.omE,
          fM, lsF, logZ);
  return cudaGetLastError();
}

template <int C, int kBound>
cudaError_t bwd_launch(const Args& a, int threads, const float* fM,
                       const float* lsF, const float* logZ, float* post) {
  static size_t allowed = 48 * 1024;
  const size_t smem = step_smem_bytes(C, threads);
  const cudaError_t err =
      allow_smem(pairhmm_bwd_kernel<C, kBound>, smem, &allowed);
  if (err != cudaSuccess) return err;
  pairhmm_bwd_kernel<C, kBound><<<a.P, threads, smem, a.stream>>>(
          fM, lsF, logZ, a.q, a.t, a.m, a.n, a.lo, a.em, a.M, a.B, a.d, a.e,
          a.tMM, a.omE, post);
  return cudaGetLastError();
}

// The instance of FN<C, bound> for the band's shape: up to 256 threads a
// block (bands up to 4096) take the 255-register bound, wider bands 512
// threads.
#define PAIRHMM_DISPATCH(FN, ...)                                         \
  do {                                                                    \
    int C_, threads_;                                                     \
    launch_shape(a.B, &C_, &threads_);                                    \
    if (threads_ <= 256) {                                                \
      switch (C_) {                                                       \
        case 4: return (int)FN<4, 256>(a, threads_, __VA_ARGS__);         \
        case 8: return (int)FN<8, 256>(a, threads_, __VA_ARGS__);         \
        case 16: return (int)FN<16, 256>(a, threads_, __VA_ARGS__);       \
      }                                                                   \
    } else {                                                              \
      switch (C_) {                                                       \
        case 16:                                                          \
          return (int)FN<16, kMaxThreads>(a, threads_, __VA_ARGS__);      \
        case 32:                                                          \
          return (int)FN<32, kMaxThreads>(a, threads_, __VA_ARGS__);      \
      }                                                                   \
    }                                                                     \
    return (int)cudaErrorInvalidValue;                                    \
  } while (0)

// The cluster a wide launch takes for max_live W: kClusterCells cells a
// lane in the fewest warps that cover W, spread over as many CTAs as there
// are warps, up to kClusterMax (or max_ctas, when it is set); the state
// rows in each CTA's shared memory up to kClusterSmemWarps warps a CTA
// (kClusterMax x 21 warps of 8 cells: 86,016); past that kClusterMax
// (max_ctas) CTAs of kClusterThreads threads with as many cells a lane as
// W needs, the rows in global scratch.
ClusterShape cluster_shape(int W, int max_ctas) {
  const int cap = max_ctas > 0 && max_ctas < kClusterMax ? max_ctas
                                                          : kClusterMax;
  const long long per_warp = 32 * kClusterCells;
  const long long warps = (W + per_warp - 1) / per_warp;
  if (warps <= (long long)cap * kClusterSmemWarps) {
    const int ctas = (int)(warps < cap ? warps : cap);
    return ClusterShape{ctas, 32 * (int)((warps + ctas - 1) / ctas),
                        kClusterCells, 1};
  }
  const long long lanes = (long long)cap * kClusterThreads;
  return ClusterShape{cap, kClusterThreads, (int)((W + lanes - 1) / lanes),
                      0};
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int pairhmm_fwd_launch(const void* q, const void* t_shift, const void* m_len,
                       const void* n_len, const void* lo, const void* em,
                       int P, int M, int B, float d, float e, float tMM,
                       float omE, void* fM, void* lsF, void* logZ,
                       void* stream) {
  if (P <= 0) return 0;
  const Args a{static_cast<const uint8_t*>(q),
               static_cast<const uint8_t*>(t_shift),
               static_cast<const int*>(m_len), static_cast<const int*>(n_len),
               static_cast<const int*>(lo), static_cast<const float*>(em),
               P, M, B, d, e, tMM, omE, static_cast<cudaStream_t>(stream)};
  PAIRHMM_DISPATCH(fwd_launch, static_cast<float*>(fM),
                   static_cast<float*>(lsF), static_cast<float*>(logZ));
}

int pairhmm_bwd_launch(const void* fM, const void* lsF, const void* logZ,
                       const void* q, const void* t_shift, const void* m_len,
                       const void* n_len, const void* lo, const void* em,
                       int P, int M, int B, float d, float e, float tMM,
                       float omE, void* post, void* stream) {
  if (P <= 0) return 0;
  const Args a{static_cast<const uint8_t*>(q),
               static_cast<const uint8_t*>(t_shift),
               static_cast<const int*>(m_len), static_cast<const int*>(n_len),
               static_cast<const int*>(lo), static_cast<const float*>(em),
               P, M, B, d, e, tMM, omE, static_cast<cudaStream_t>(stream)};
  PAIRHMM_DISPATCH(bwd_launch, static_cast<const float*>(fM),
                   static_cast<const float*>(lsF),
                   static_cast<const float*>(logZ),
                   static_cast<float*>(post));
}

// The cluster a wide launch takes for max_live W (cluster_shape, at most
// max_ctas CTAs when it is above 0): out[0..5] = CTAs, threads a CTA,
// cells a lane, 1 where the state rows live in the CTAs' shared memory,
// and the float32 words of global scratch a pair needs forward and
// backward (0 with shared-memory rows).
int pairhmm_cluster_shape(int W, int max_ctas, void* out) {
  if (W < 1) return (int)cudaErrorInvalidValue;
  const ClusterShape sh = cluster_shape(W, max_ctas);
  const long long words =
      sh.smem ? 0 : (long long)sh.ctas * sh.threads * sh.cells;
  long long* o = static_cast<long long*>(out);
  o[0] = sh.ctas;
  o[1] = sh.threads;
  o[2] = sh.cells;
  o[3] = sh.smem;
  o[4] = kClusterFwdRows * words;
  o[5] = kClusterBwdRows * words;
  return 0;
}

// The wide route (bands past kMaxWarps warps of 32 cells, or any band a
// caller forces): one cluster a pair on the live windows, whose widest is
// W = max_live.  `scratch` is needed where cluster_shape puts the rows in
// global scratch.
int pairhmm_fwd_wide_launch(const void* q, const void* t_shift,
                            const void* m_len, const void* n_len,
                            const void* lo, const void* em, int P, int M,
                            int B, int W, int max_ctas, float d, float e,
                            float tMM, float omE, void* scratch, void* fM,
                            void* lsF, void* logZ, void* stream) {
  if (P <= 0) return 0;
  if (W < 1 || W > B) return (int)cudaErrorInvalidValue;
  const ClusterShape sh = cluster_shape(W, max_ctas);
  if (!sh.smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
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
    // the dynamic rows and the static ClusterSmem pass 48 KB together
    // before the rows alone do: allow every size
    const size_t smem = (size_t)kClusterFwdSmemRows *
                        row_words(sh.threads * sh.cells) * 4;
    if (sh.threads <= kClusterSmallThreads) {
      static size_t allowed = 0;
      return (int)launch_cluster(
          pairhmm_fwd_cluster_kernel<kClusterCells, true,
                                     kClusterSmallThreads>,
          sh, P, smem, &allowed, st, qq, tt, mm, nn, ll, ee, M, B, d, e, tMM,
          omE, sh.cells, sc, f, l, z);
    }
    static size_t allowed = 0;
    return (int)launch_cluster(
        pairhmm_fwd_cluster_kernel<kClusterCells, true, kClusterSmemThreads>,
        sh, P, smem, &allowed, st, qq, tt, mm, nn, ll, ee, M, B, d, e, tMM,
        omE, sh.cells, sc, f, l, z);
  }
  static size_t allowed = 48 * 1024;
  return (int)launch_cluster(
      pairhmm_fwd_cluster_kernel<kClusterCells, false, kClusterThreads>, sh,
      P, 0, &allowed, st, qq, tt, mm, nn, ll, ee, M, B, d, e, tMM, omE,
      sh.cells, sc, f, l, z);
}

int pairhmm_bwd_wide_launch(const void* fM, const void* lsF,
                            const void* logZ, const void* q,
                            const void* t_shift, const void* m_len,
                            const void* n_len, const void* lo,
                            const void* em, int P, int M, int B, int W,
                            int max_ctas, float d, float e, float tMM,
                            float omE, void* scratch, void* post,
                            void* stream) {
  if (P <= 0) return 0;
  if (W < 1 || W > B) return (int)cudaErrorInvalidValue;
  const ClusterShape sh = cluster_shape(W, max_ctas);
  if (!sh.smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
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
    const size_t smem = (size_t)kClusterBwdSmemRows *
                        row_words(sh.threads * sh.cells) * 4;
    if (sh.threads <= kClusterSmallThreads) {
      static size_t allowed = 0;
      return (int)launch_cluster(
          pairhmm_bwd_cluster_kernel<kClusterCells, true,
                                     kClusterSmallThreads>,
          sh, P, smem, &allowed, st, f, l, z, qq, tt, mm, nn, ll, ee, M, B,
          d, e, tMM, omE, sh.cells, sc, out);
    }
    static size_t allowed = 0;
    return (int)launch_cluster(
        pairhmm_bwd_cluster_kernel<kClusterCells, true, kClusterSmemThreads>,
        sh, P, smem, &allowed, st, f, l, z, qq, tt, mm, nn, ll, ee, M, B, d,
        e, tMM, omE, sh.cells, sc, out);
  }
  static size_t allowed = 48 * 1024;
  return (int)launch_cluster(
      pairhmm_bwd_cluster_kernel<kClusterCells, false, kClusterThreads>, sh,
      P, 0, &allowed, st, f, l, z, qq, tt, mm, nn, ll, ee, M, B, d, e, tMM,
      omE, sh.cells, sc, out);
}

}  // extern "C"
