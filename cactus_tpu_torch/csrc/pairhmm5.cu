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
// does.  The backward pass starts at each pair's own terminal row m_len
// and evaluates the terminal closed form (pairhmm5.py:278-292) once there.
// The transitions are kernel arguments, so one build serves every
// divergence-trained p_match and parameter set.  Float results follow the
// plain PyTorch version (cactus_tpu_torch/ops/pairhmm5.py) to rounding:
// the in-row chains are summed in another order (sequential + block scan
// instead of Kogge-Stone), and expf/logf differ from the host's by an ulp.
//
// What bounds them on an H100: bytes.  The recurrence needs 38 (fwd) and
// 40 (bwd) float32 operations a cell (ops/pairhmm5_cuda.py) against 4
// bytes written (fwd) or 4 read + 4 written (bwd), below the FP32 units'
// balance of 20 operations per byte (67 TFLOP/s over 3.35 TB/s).  The
// design keeps all recurrence state on chip -- one thread block per pair,
// the band across the threads, each thread owning a contiguous run of
// cells, the previous row's states in shared memory -- and moves only the
// one f32 band row per row each way.  Five float32
// states take 20 B a cell: up to band 8192 they live in shared memory
// (padded one word in 33 so the threads' contiguous runs fall on distinct
// banks); wider bands keep them in a per-pair global-memory scratch row
// (L1/L2 resident) that the wrapper allocates, so every band the pecan
// path produces runs, 16384 and beyond included.
// The coupled in-row chain [SY,LY][b] = A [SY,LY][b-1] + c[b], with
// A = [[e_s, w_ls], [w_sl, e_l]] forward and A^T reversed backward, is an
// affine scan of 2x2 maps: each thread solves its run with zero carry-in
// and keeps the run's composed map (A^len, v_end), a warp-shuffle /
// shared-memory exclusive scan combines the per-thread maps with
// (M2,v2)o(M1,v1) = (M2 M1, M2 v1 + v2), and each thread then replays its
// cells from the exact carry.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kTiny = 1e-30f;   // pairhmm5.py TINY
constexpr int kMaxThreads = 256;
// the widest band whose five state rows fit the 227 KB of shared memory a
// block may have; wider bands keep them in global scratch
constexpr int kSmemMaxBand = 8192;

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
__device__ __forceinline__ Aff push_cell(const Aff& a, float m11, float m12,
                                         float m21, float m22, float c1,
                                         float c2) {
  return Aff{m11 * a.a11 + m12 * a.a21, m11 * a.a12 + m12 * a.a22,
             m21 * a.a11 + m22 * a.a21, m21 * a.a12 + m22 * a.a22,
             (m11 * a.v1 + m12 * a.v2) + c1, (m21 * a.v1 + m22 * a.v2) + c2};
}

template <bool kDown>
__device__ __forceinline__ Aff shfl_aff(const Aff& x, int off) {
  Aff o;
  if (kDown) {
    o.a11 = __shfl_down_sync(0xffffffffu, x.a11, off);
    o.a12 = __shfl_down_sync(0xffffffffu, x.a12, off);
    o.a21 = __shfl_down_sync(0xffffffffu, x.a21, off);
    o.a22 = __shfl_down_sync(0xffffffffu, x.a22, off);
    o.v1 = __shfl_down_sync(0xffffffffu, x.v1, off);
    o.v2 = __shfl_down_sync(0xffffffffu, x.v2, off);
  } else {
    o.a11 = __shfl_up_sync(0xffffffffu, x.a11, off);
    o.a12 = __shfl_up_sync(0xffffffffu, x.a12, off);
    o.a21 = __shfl_up_sync(0xffffffffu, x.a21, off);
    o.a22 = __shfl_up_sync(0xffffffffu, x.a22, off);
    o.v1 = __shfl_up_sync(0xffffffffu, x.v1, off);
    o.v2 = __shfl_up_sync(0xffffffffu, x.v2, off);
  }
  return o;
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

// band cell b -> word of a state row: one pad word every 32 cells
__device__ __forceinline__ int pix(int b) { return b + (b >> 5); }

__host__ __device__ inline int row_words(int B) { return B + (B >> 5) + 1; }

template <bool kSmem>
__device__ __forceinline__ float* state_rows(float4* smem, float* scratch,
                                             int B) {
  return kSmem ? reinterpret_cast<float*>(smem)
               : scratch + (size_t)blockIdx.x * 5 * row_words(B);
}

template <bool kSmem>
__global__ void __launch_bounds__(kMaxThreads)
pairhmm5_fwd_kernel(const uint8_t* __restrict__ q,
                    const uint8_t* __restrict__ t_shift,
                    const int* __restrict__ m_len,
                    const int* __restrict__ n_len,
                    const int* __restrict__ lo,
                    const float* __restrict__ em, int M, int B, Trans tr,
                    float* scratch, float* __restrict__ fM_out,
                    float* __restrict__ lsF_out,
                    float* __restrict__ logZ_out) {
  extern __shared__ float4 smem_f4[];
  __shared__ Aff aff_buf[32];
  __shared__ float max_buf[33];
  __shared__ float s_em[36];
  __shared__ float s_end;
  const int W = row_words(B);
  float* sM = state_rows<kSmem>(smem_f4, scratch, B);
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
      a = push_cell(a, a11, a12, a21, a22, ok ? tr.os * prev : 0.f,
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
      a = push_cell(a, a11, a12, a21, a22, ok ? tr.os * prev : 0.f,
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

template <bool kSmem>
__global__ void __launch_bounds__(kMaxThreads)
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
  extern __shared__ float4 smem_f4[];
  __shared__ Aff aff_buf[32];
  __shared__ float max_buf[33];
  __shared__ float s_em[36];
  const int W = row_words(B);
  // bM, bSX, bLX of the carried row; sx and lx (bSX, bLX of the cell to
  // the left, masked) between the two passes of a row.  bSY and bLY of a
  // row feed only its rescale, so they are never stored.
  float* sM = state_rows<kSmem>(smem_f4, scratch, B);
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
      a = push_cell(a, a11, a12, a21, a22, c, c);
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
      a = push_cell(a, a11, a12, a21, a22, tr.ms * mm, tr.ml * mm);
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

int threads_for(int B) {
  return B >= kMaxThreads ? kMaxThreads : ((B + 31) / 32) * 32;
}

size_t smem_bytes(int B) {
  return B <= kSmemMaxBand ? (size_t)5 * row_words(B) * sizeof(float) : 0;
}

// the launch of one pass: shared-memory rows up to kSmemMaxBand, global
// scratch rows above it
template <typename KSmem, typename KGlobal, typename Launch>
int launch_pass(KSmem k_smem, KGlobal k_global, int B, const void* scratch,
                Launch launch) {
  const size_t smem = smem_bytes(B);
  if (smem > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        k_smem, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    launch(k_smem, smem);
  } else {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    launch(k_global, (size_t)0);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// float32 words of global scratch a launch needs per pair (0 when the
// state rows fit shared memory)
int pairhmm5_scratch_floats(int B) {
  return B <= kSmemMaxBand ? 0 : 5 * row_words(B);
}

int pairhmm5_fwd_launch(const void* q, const void* t_shift, const void* m_len,
                        const void* n_len, const void* lo, const void* em,
                        int P, int M, int B, float mc, float os, float ol,
                        float es, float el, float wsl, float wls, float ms,
                        float ml, void* scratch, void* fM, void* lsF,
                        void* logZ, void* stream) {
  if (P <= 0) return 0;
  const Trans tr{mc, os, ol, es, el, wsl, wls, ms, ml};
  auto launch = [&](auto kernel, size_t smem) {
    kernel<<<P, threads_for(B), smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(t_shift),
        static_cast<const int*>(m_len), static_cast<const int*>(n_len),
        static_cast<const int*>(lo), static_cast<const float*>(em), M, B, tr,
        static_cast<float*>(scratch), static_cast<float*>(fM),
        static_cast<float*>(lsF), static_cast<float*>(logZ));
  };
  return launch_pass(pairhmm5_fwd_kernel<true>, pairhmm5_fwd_kernel<false>,
                     B, scratch, launch);
}

int pairhmm5_bwd_launch(const void* fM, const void* lsF, const void* logZ,
                        const void* q, const void* t_shift, const void* m_len,
                        const void* n_len, const void* lo, const void* em,
                        int P, int M, int B, float mc, float os, float ol,
                        float es, float el, float wsl, float wls, float ms,
                        float ml, void* scratch, void* post, void* stream) {
  if (P <= 0) return 0;
  const Trans tr{mc, os, ol, es, el, wsl, wls, ms, ml};
  auto launch = [&](auto kernel, size_t smem) {
    kernel<<<P, threads_for(B), smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(fM), static_cast<const float*>(lsF),
        static_cast<const float*>(logZ), static_cast<const uint8_t*>(q),
        static_cast<const uint8_t*>(t_shift), static_cast<const int*>(m_len),
        static_cast<const int*>(n_len), static_cast<const int*>(lo),
        static_cast<const float*>(em), M, B, tr, static_cast<float*>(scratch),
        static_cast<float*>(post));
  };
  return launch_pass(pairhmm5_bwd_kernel<true>, pairhmm5_bwd_kernel<false>,
                     B, scratch, launch);
}

}  // extern "C"
