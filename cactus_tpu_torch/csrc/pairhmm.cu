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
//  - Bands past 16384 cells (16 warps of 32 cells a lane) take the wide
//    kernels below, which loop a block over tiles of the band with the
//    state rows in global scratch (the wrapper routes by band,
//    ops/pairhmm_cuda.py::pairhmm_route).
// Float results follow the plain PyTorch version to rounding: the in-row
// chains are summed in another order than its Kogge-Stone scan, multiplies
// and adds may contract into FMAs, the rows of a step are not renormalised
// one by one, and expf/logf/powf differ from the host's by an ulp.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

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

// ------------------------------------------------------------ wide bands

// Bands wider than the narrow kernels' kMaxWarps warps of 32 cells (16384)
// take the wide kernels.  One block of kWideThreads threads a pair walks
// each row's band in tiles of kWideTile cells (lane t owns the kWideC
// cells t kWideC .. of each tile, so a warp's loads and stores are
// contiguous runs), with the state rows in a per-pair global scratch row
// (pairhmm_wide_scratch_floats) that L2 keeps.  A row's Y chain is the
// narrow kernels' scan (the lane's fold, the warp's Kogge-Stone scan,
// the warps' totals through shared memory at one barrier a tile) with
// the chain's value at the tile's first cell carried from tile to tile.
// Rescaling and the row-maximum bookkeeping are the narrow kernels':
// the state is scaled once per kStepRows rows by the reciprocal of the
// step's last row maximum (applied as the next step's first row reads
// the state), each row's maximum is reduced when its step ends, and each
// row is stored divided by its own maximum (forward; the backward pass
// scales its posterior alike) with the plain version's running
// log-scale.  A step's rows wait in the output, unscaled, until the step
// ends; each thread then rescales its own cells in place.  Every row
// ends at a barrier, so the next row reads the state whole.
constexpr int kWideC = 8;
constexpr int kWideThreads = kMaxThreads;
constexpr int kWideTile = kWideC * kWideThreads;

__host__ __device__ inline int wide_cover(int B) {
  return (B + kWideTile - 1) / kWideTile * kWideTile;
}

__global__ void __launch_bounds__(kWideThreads)
pairhmm_fwd_wide_kernel(const uint8_t* __restrict__ q,
                        const uint8_t* __restrict__ t_shift,
                        const int* __restrict__ m_len,
                        const int* __restrict__ n_len,
                        const int* __restrict__ lo,
                        const float* __restrict__ em, int M, int B, float d,
                        float e, float tMM, float omE,
                        float* __restrict__ scratch,
                        float* __restrict__ fM_out,
                        float* __restrict__ lsF_out,
                        float* __restrict__ logZ_out) {
  constexpr int C = kWideC;
  constexpr int R = kStepRows;
  __shared__ Shared sh;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const int Bp = wide_cover(B);
  const int ntiles = Bp / kWideTile;

  const int p = blockIdx.x;
  const int lo_p = lo[p];
  const int m = min(m_len[p], M);
  const int n = n_len[p];
  const int b_end = n - m - lo_p;
  const int end_row = m > 1 ? m : 1;
  const uint8_t* qp = q + (size_t)p * M;
  const uint8_t* tp = t_shift + (size_t)p * (M + B);
  float* fp = fM_out + (size_t)p * M * B;
  float* lp = lsF_out + (size_t)p * M;
  float* sM = scratch + (size_t)p * 3 * Bp;
  float* sX = sM + Bp;
  float* sY = sX + Bp;

  for (int k = t; k < 36; k += blockDim.x) sh.em[k] = em[k];
  if (t < 3) sh.end[t] = 0.f;
  float lev[6], lane_mult;
  chain_constants<C>(e, lane, lev, &lane_mult);
  const float warp_mult = lev[5];      // e^(32 C)
  float epow[C], wgt[C];
  epow[0] = 1.f;
#pragma unroll
  for (int c = 1; c < C; ++c) epow[c] = epow[c - 1] * e;
#pragma unroll
  for (int c = 0; c < C; ++c) wgt[c] = d * epow[C - 1 - c];
  // row 0: M at j == 0, Y from that cell; zero past the band
  for (int b = t; b < Bp; b += blockDim.x) {
    const int j0 = lo_p + b;
    sM[b] = (j0 == 0 && b < B) ? 1.f : 0.f;
    sX[b] = 0.f;
    sY[b] = (j0 >= 1 && j0 <= n && b < B)
                ? d * powf(e, (float)(j0 - 1 > 0 ? j0 - 1 : 0))
                : 0.f;
  }
  __syncthreads();

  float S = 0.f;    // the plain version's running log-scale, row by row
  float rs = 1.f;   // the scale the state waits for (a step's last row)
  int step = 0;
  for (int i0 = 1; i0 <= m; i0 += R, ++step) {
    const int rows = min(R, m - i0 + 1);
    float pmax[R];
#pragma unroll
    for (int r = 0; r < R; ++r) pmax[r] = 0.f;
#pragma unroll 1
    for (int r = 0; r < rows; ++r) {
      const int i = i0 + r;
      const float k_in = r == 0 ? rs : 1.f;
      const float* erow = sh.em + 6 * qp[i - 1];
      float* frow = fp + (size_t)(i - 1) * B;
      float Y = 0.f;      // the chain at the tile's first cell
      float lmax = 0.f;
#pragma unroll 1
      for (int tile = 0; tile < ntiles; ++tile) {
        const int b0 = tile * kWideTile + t * C;
        // the previous row's cells b0 .. b0 + C (mX reads b + 1)
        float fm[C + 1], fx[C + 1], fy[C], emit[C];
#pragma unroll
        for (int c = 0; c <= C; ++c) {
          const int b = b0 + c;
          fm[c] = b < B ? sM[b] * k_in : 0.f;
          fx[c] = b < B ? sX[b] * k_in : 0.f;
          if (c < C) {
            fy[c] = b < B ? sY[b] * k_in : 0.f;
            emit[c] = b < B ? erow[tp[i - 1 + b]] : 0.f;
          }
        }
        const int jb = i + lo_p + b0;   // j of cell c is jb + c
        const int okM1 = min(n + 1 - jb, B - b0);
        const int okM0 = 1 - jb;
        float mM[C], mX[C], fold[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float vM = emit[c] * (tMM * fm[c] + omE * (fx[c] + fy[c]));
          mM[c] = c >= okM0 && c < okM1 ? vM : 0.f;
          const float vX = d * fm[c + 1] + e * fx[c + 1];
          mX[c] = c >= okM0 - 1 && c < okM1 ? vX : 0.f;
          fold[c] = wgt[c] * mM[c];
        }
#pragma unroll
        for (int st = 1; st < C; st *= 2) {
#pragma unroll
          for (int c = 0; c + st < C; c += 2 * st)
            fold[c] = fold[c] + fold[c + st];
        }
        const float inc = warp_chain_scan<false>(fold[0], lev, lane);
        float y0[C];
        y0[0] = 0.f;
#pragma unroll
        for (int c = 1; c < C; ++c) y0[c] = d * mM[c - 1] + e * y0[c - 1];
        float w = __shfl_up_sync(kFull, inc, 1);
        if (lane == 0) w = 0.f;
        if (lane == 31) sh.tot[tile & 1][warp] = inc;
        __syncthreads();
        // the chain at the warp's first cell, from the tile's carry and
        // the warps before; the next tile's carry from all of them
        float cw = Y;
        for (int v = 0; v < nwarps; ++v) {
          if (v == warp) w = w + lane_mult * cw;
          cw = warp_mult * cw + sh.tot[tile & 1][v];
        }
        Y = cw;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int b = b0 + c;
          const float vY = y0[c] + epow[c] * w;
          const float mY = c >= okM0 && c < okM1 ? vY : 0.f;
          lmax = fmaxf(lmax, (mM[c] + mX[c]) + mY);
          sM[b] = mM[c];
          sX[b] = mX[c];
          sY[b] = mY;
          if (b < B) frow[b] = mM[c];
          if (i == end_row && b == b_end) {
            sh.end[0] = mM[c];
            sh.end[1] = mX[c];
            sh.end[2] = mY;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < R; ++k)
        if (k == r) pmax[k] = lmax;
      __syncthreads();   // the row is whole before the next one reads it
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
    // each row divided by its own maximum, as the plain version stores it
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= rows) continue;
      const float k = 1.f / fmaxf(pmax[r], kTiny);
      float* frow = fp + (size_t)(i0 + r - 1) * B;
      for (int tile = 0; tile < ntiles; ++tile) {
        const int b0 = tile * kWideTile + t * C;
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (b0 + c < B) frow[b0 + c] = frow[b0 + c] * k;
      }
    }
    rs = 1.f / fmaxf(pmax[rows - 1], kTiny);
  }

  // past the pair's end every state is masked to exactly 0 and the row
  // scale is TINY
  const size_t done = (size_t)(m > 0 ? m : 0) * B;
  for (size_t k = done + t; k < (size_t)M * B; k += blockDim.x) fp[k] = 0.f;
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

__global__ void __launch_bounds__(kWideThreads)
pairhmm_bwd_wide_kernel(const float* __restrict__ fM,
                        const float* __restrict__ lsF,
                        const float* __restrict__ logZ,
                        const uint8_t* __restrict__ q,
                        const uint8_t* __restrict__ t_shift,
                        const int* __restrict__ m_len,
                        const int* __restrict__ n_len,
                        const int* __restrict__ lo,
                        const float* __restrict__ em, int M, int B, float d,
                        float e, float tMM, float omE,
                        float* __restrict__ scratch,
                        float* __restrict__ post) {
  constexpr int C = kWideC;
  constexpr int R = kStepRows;
  __shared__ Shared sh;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const int Bp = wide_cover(B);
  const int ntiles = Bp / kWideTile;

  const int p = blockIdx.x;
  const int lo_p = lo[p];
  const int m = m_len[p];
  const int n = n_len[p];
  const uint8_t* qp = q + (size_t)p * M;
  const uint8_t* tp = t_shift + (size_t)p * (M + B);
  const float* fp = fM + (size_t)p * M * B;
  const float* lsp = lsF + (size_t)p * M;
  float* pp = post + (size_t)p * M * B;
  const float lz = logZ[p];
  // bM and bX of the carried row (bY of a row feeds only its maximum)
  float* sM = scratch + (size_t)p * 3 * Bp;
  float* sX = sM + Bp;

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
  float epow[C], wgt[C];
  epow[0] = 1.f;
#pragma unroll
  for (int c = 1; c < C; ++c) epow[c] = epow[c - 1] * e;
#pragma unroll
  for (int c = 0; c < C; ++c) wgt[c] = omE * epow[c];

  // terminal row i = m (the backward closed form at the pair's end) and
  // its posterior
  {
    const float g = expf(fminf(fmaxf(lsp[m - 1] - lz, -60.f), 60.f));
    const float* frow = fp + (size_t)(m - 1) * B;
    float* prow = pp + (size_t)(m - 1) * B;
    for (int b = t; b < Bp; b += blockDim.x) {
      const int jn = n - (m + lo_p + b);
      const float bm = b >= B ? 0.f
                       : jn == 0
                           ? 1.f
                           : (jn > 0 ? d * powf(e, (float)(jn - 1 > 0 ? jn - 1
                                                                     : 0))
                                     : 0.f);
      sM[b] = bm;
      sX[b] = (b < B && jn == 0) ? 1.f : 0.f;
      if (b < B) prow[b] = fminf(fmaxf((frow[b] * bm) * g, 0.f), 1.5f);
    }
  }
  __syncthreads();

  float S = 0.f;    // the plain version's running log-scale lsB
  float rs = 1.f;   // the scale the state waits for (a step's last row)
  int step = 0;
  for (int r0 = m - 1; r0 >= 1; r0 -= R, ++step) {
    const int rows = min(R, r0);
    float lsf_r[R], pmax[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      lsf_r[r] = r < rows ? lsp[r0 - r - 1] : 0.f;
      pmax[r] = 0.f;
    }
#pragma unroll 1
    for (int r = 0; r < rows; ++r) {
      const int i = r0 - r;        // the new row, from the carry row i + 1
      const float k_in = r == 0 ? rs : 1.f;
      const float* erow = sh.em + 6 * qp[i];
      const float* frow = fp + (size_t)(i - 1) * B;
      float* prow = pp + (size_t)(i - 1) * B;
      float Y = 0.f;      // the chain past the tile's last cell
      float lmax = 0.f;
#pragma unroll 1
      for (int tile = ntiles - 1; tile >= 0; --tile) {
        const int b0 = tile * kWideTile + t * C;
        // the carry row's bM at b0 .. b0 + C - 1, bX at b0 - 1 .. (x
        // reads b - 1)
        float bm[C], bx[C + 1], emit[C];
#pragma unroll
        for (int c = 0; c <= C; ++c) {
          const int b = b0 - 1 + c;
          bx[c] = b >= 0 && b < B ? sX[b] * k_in : 0.f;
          if (c < C) {
            const int bc = b0 + c;
            bm[c] = bc < B ? sM[bc] * k_in : 0.f;
            emit[c] = bc < B ? erow[tp[i + bc]] : 0.f;
          }
        }
        const int jb = i + lo_p + b0;   // jprev of cell c is jb + c
        const int nb = B - b0;
        const int mm1 = min(n - jb, nb);
        const int ok0 = -jb;
        const int x1 = n + 1 - jb;
        const int ok1 = min(x1, nb);
        float mm[C], xs[C], fold[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          mm[c] = c < mm1 ? emit[c] * bm[c] : 0.f;
          xs[c] = c >= ok0 && c < x1 ? bx[c] : 0.f;
          fold[c] = wgt[c] * mm[c];
        }
#pragma unroll
        for (int st = 1; st < C; st *= 2) {
#pragma unroll
          for (int c = 0; c + st < C; c += 2 * st)
            fold[c] = fold[c] + fold[c + st];
        }
        const float inc = warp_chain_scan<true>(fold[0], lev, lane);
        float y0[C];
        y0[C - 1] = 0.f;
#pragma unroll
        for (int c = C - 2; c >= 0; --c)
          y0[c] = omE * mm[c + 1] + e * y0[c + 1];
        float yn = __shfl_down_sync(kFull, inc, 1);
        if (lane == 31) yn = 0.f;
        if (lane == 0) sh.tot[tile & 1][warp] = inc;
        __syncthreads();
        // the chain past the warp's last cell, from the tile's carry and
        // the warps after; the next (lower) tile's carry from all of them
        float cw = Y;
        for (int v = nwarps - 1; v >= 0; --v) {
          if (v == warp) yn = yn + lane_mult * cw;
          cw = warp_mult * cw + sh.tot[tile & 1][v];
        }
        Y = cw;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int b = b0 + c;
          const float ync = y0[c] + epow[C - 1 - c] * yn;  // y at cell c + 1
          const float y = omE * mm[c] + e * ync;
          const float nM = (tMM * mm[c] + d * xs[c]) + d * ync;
          const float nX = omE * mm[c] + e * xs[c];
          const bool ok = c >= ok0 && c < ok1;
          const float vm = ok ? nM : 0.f;
          const float vx = ok ? nX : 0.f;
          lmax = fmaxf(lmax, (vm + vx) + (ok ? y : 0.f));
          sM[b] = vm;
          sX[b] = vx;
          // fM x bM of the row, before its scale
          if (b < B) prow[b] = frow[b] * vm;
        }
      }
#pragma unroll
      for (int k = 0; k < R; ++k)
        if (k == r) pmax[k] = lmax;
      __syncthreads();   // the row is whole before the next one reads it
    }
    block_step_max<R>(pmax, sh.max[step & 1], lane, warp, nwarps);
    // each row's posterior: fM x (bM over the row's maximum, as the plain
    // version scales it) x exp(clip(lsF + lsB - logZ)) with lsB the plain
    // version's running log-scale, so that the clip sees its exponent
    float prev = 1.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= rows) continue;
      const float mk = pmax[r];
      const float s = prev > 0.f ? fmaxf(mk / prev, kTiny) : kTiny;
      S = S + logf(s);
      const float g = expf(fminf(fmaxf((lsf_r[r] + S) - lz, -60.f), 60.f));
      const float k = 1.f / fmaxf(mk, kTiny);
      prev = mk;
      float* prow = pp + (size_t)(r0 - r - 1) * B;
      for (int tile = 0; tile < ntiles; ++tile) {
        const int b0 = tile * kWideTile + t * C;
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (b0 + c < B)
            prow[b0 + c] = fminf(fmaxf((prow[b0 + c] * k) * g, 0.f), 1.5f);
      }
    }
    rs = 1.f / fmaxf(pmax[rows - 1], kTiny);
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

// The wide route (bands past kMaxWarps warps of 32 cells): float32 words
// of global scratch a pair, and the two launches.
int pairhmm_wide_scratch_floats(int B) { return 3 * wide_cover(B); }

int pairhmm_fwd_wide_launch(const void* q, const void* t_shift,
                            const void* m_len, const void* n_len,
                            const void* lo, const void* em, int P, int M,
                            int B, float d, float e, float tMM, float omE,
                            void* scratch, void* fM, void* lsF, void* logZ,
                            void* stream) {
  if (P <= 0) return 0;
  if (B < 1 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  pairhmm_fwd_wide_kernel<<<P, kWideThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(t_shift),
      static_cast<const int*>(m_len), static_cast<const int*>(n_len),
      static_cast<const int*>(lo), static_cast<const float*>(em), M, B, d, e,
      tMM, omE, static_cast<float*>(scratch), static_cast<float*>(fM),
      static_cast<float*>(lsF), static_cast<float*>(logZ));
  return (int)cudaGetLastError();
}

int pairhmm_bwd_wide_launch(const void* fM, const void* lsF,
                            const void* logZ, const void* q,
                            const void* t_shift, const void* m_len,
                            const void* n_len, const void* lo,
                            const void* em, int P, int M, int B, float d,
                            float e, float tMM, float omE, void* scratch,
                            void* post, void* stream) {
  if (P <= 0) return 0;
  if (B < 1 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  pairhmm_bwd_wide_kernel<<<P, kWideThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fM), static_cast<const float*>(lsF),
      static_cast<const float*>(logZ), static_cast<const uint8_t*>(q),
      static_cast<const uint8_t*>(t_shift), static_cast<const int*>(m_len),
      static_cast<const int*>(n_len), static_cast<const int*>(lo),
      static_cast<const float*>(em), M, B, d, e, tMM, omE,
      static_cast<float*>(scratch), static_cast<float*>(post));
  return (int)cudaGetLastError();
}

}  // extern "C"
