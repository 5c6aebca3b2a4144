// 3-state (match M / insert X / delete Y) banded pair-HMM forward and
// backward passes in scaled linear float32, for NVIDIA Hopper (built for
// sm_90a with -fmad=false, bound with ctypes).
//
// pairhmm_fwd replaces the Pallas TPU kernel
// cactus_tpu/ops/pairhmm_pallas.py::_fwd_kernel and pairhmm_bwd replaces
// ::_bwd_kernel (entry posterior_banded_batch_pallas).  Their contract is
// cactus_tpu/ops/pairhmm.py::posterior_banded_batch, split in two:
//   fwd:  q, t_shift, m_len, n_len, lo, em -> fM (P, M, B) f32 (match
//         band of every row after rescaling), lsF (P, M) f32 (running
//         log-scale after each row), logZ (P,) f32
//   bwd:  fM, lsF, logZ and the same inputs -> post (P, M, B) f32, the
//         match posterior fM*bM*exp(clip(lsF+lsB-logZ, -60, 60)) clipped
//         to [0, 1.5] and zero past each pair's m_len; the combine is
//         fused into the backward row loop, so bM never reaches device
//         memory.
// Every row is rescaled by its band maximum, as the contract does
// (pairhmm.py:180-183, :244-246) -- not every 8 rows as the Pallas kernel
// does.  Float results follow the plain PyTorch version
// (cactus_tpu_torch/ops/pairhmm.py) to rounding: the in-row chains are
// summed in another order (sequential + block scan instead of
// Kogge-Stone), and expf/logf/powf differ from the host's by an ulp.
//
// What bounds them on an H100: bytes.  Each cell costs ~20 float32
// operations against 4 bytes written (fwd) or 4 read + 4 written (bwd),
// so the 3.35 TB/s of device memory sets the floor long before the
// 67 TFLOP/s of the FP32 units.  The design keeps all recurrence state on
// chip -- one thread block per pair, the band across the threads, each
// thread owning a contiguous run of cells, the previous row's three
// states in shared memory -- and moves only the one f32 band row per row
// each way, staged through shared memory into coalesced stores.  The
// linear in-row chain y[b] = s[b] + e*y[b-1] (forward; reversed in the
// backward pass) is an affine scan: each thread composes the
// (multiplier, addend) maps of its cells, a warp-shuffle / shared-memory
// exclusive scan combines the per-thread maps, and each thread then
// replays its cells sequentially from the exact carry.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kTiny = 1e-30f;   // pairhmm.py TINY
constexpr int kMaxThreads = 256;

// Exclusive scan of affine maps y -> a*y + b over the block, applied to
// y = 0.  Forward: threads below t are applied first (lowest first).
// Reverse: threads above t (highest first).  Returns the additive part.
template <bool kReverse>
__device__ float block_affine_carry(float a, float b, float2* buf) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float A = a, Bv = b;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float oA = kReverse ? __shfl_down_sync(0xffffffffu, A, off)
                              : __shfl_up_sync(0xffffffffu, A, off);
    const float oB = kReverse ? __shfl_down_sync(0xffffffffu, Bv, off)
                              : __shfl_up_sync(0xffffffffu, Bv, off);
    const bool has = kReverse ? (lane + off < 32) : (lane >= off);
    if (has) {   // the other map is applied first
      Bv = A * oB + Bv;
      A = oA * A;
    }
  }
  // lane-exclusive map: the neighbour's inclusive map
  float lA = kReverse ? __shfl_down_sync(0xffffffffu, A, 1)
                      : __shfl_up_sync(0xffffffffu, A, 1);
  float lB = kReverse ? __shfl_down_sync(0xffffffffu, Bv, 1)
                      : __shfl_up_sync(0xffffffffu, Bv, 1);
  if (lane == (kReverse ? 31 : 0)) {
    lA = 1.f;
    lB = 0.f;
  }
  if (lane == (kReverse ? 0 : 31)) buf[warp] = make_float2(A, Bv);
  __syncthreads();
  if (threadIdx.x == 0) {
    float2 acc = make_float2(1.f, 0.f);
    for (int k = 0; k < nwarps; ++k) {
      const int w = kReverse ? nwarps - 1 - k : k;
      const float2 tot = buf[w];
      buf[w] = acc;
      acc = make_float2(acc.x * tot.x, tot.x * acc.y + tot.y);
    }
  }
  __syncthreads();
  const float2 wx = buf[warp];
  return lA * wx.y + lB;
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

__global__ void __launch_bounds__(kMaxThreads)
pairhmm_fwd_kernel(const uint8_t* __restrict__ q,
                   const uint8_t* __restrict__ t_shift,
                   const int* __restrict__ m_len,
                   const int* __restrict__ n_len,
                   const int* __restrict__ lo,
                   const float* __restrict__ em, int M, int B, float d,
                   float e, float tMM, float omE,
                   float* __restrict__ fM_out, float* __restrict__ lsF_out,
                   float* __restrict__ logZ_out) {
  extern __shared__ float4 smem_f4[];
  float* sM = reinterpret_cast<float*>(smem_f4);
  float* sX = sM + B;
  float* sY = sX + B;
  __shared__ float2 aff_buf[32];
  __shared__ float max_buf[33];
  __shared__ float s_em[36];
  __shared__ float s_end;

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

  for (int k = t; k < 36; k += T) s_em[k] = em[k];
  if (t == 0) s_end = 0.f;
  for (int b = b0; b < b1; ++b) {
    const int j0 = lo_p + b;
    sM[b] = j0 == 0 ? 1.f : 0.f;
    sX[b] = 0.f;
    sY[b] = (j0 >= 1 && j0 <= n)
                ? d * powf(e, (float)(j0 - 1 > 0 ? j0 - 1 : 0))
                : 0.f;
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
    float nbM = 0.f, nbX = 0.f;
    if (b1 < B && b0 < b1) {
      nbM = sM[b1];
      nbX = sX[b1];
    }
    __syncthreads();

    // pass 1: mM, mX; compose this thread's chain maps w -> e*w + d*mM
    float aA = 1.f, aB = 0.f;
    for (int b = b0; b < b1; ++b) {
      const float fm = sM[b], fx = sX[b], fy = sY[b];
      const float fmu = b + 1 < b1 ? sM[b + 1] : nbM;
      const float fxu = b + 1 < b1 ? sX[b + 1] : nbX;
      const float emit = erow[tp[i - 1 + b]];
      const int j = i + lo_p + b;
      float mM = emit * (tMM * fm + omE * (fx + fy));
      if (!(j >= 1 && j <= n)) mM = 0.f;
      float mX = d * fmu + e * fxu;
      if (!(j >= 0 && j <= n)) mX = 0.f;
      sM[b] = mM;
      sX[b] = mX;
      aB = e * aB + d * mM;
      aA = aA * e;
    }
    // y[b0] = composite of every earlier cell's map applied to y[0] = 0
    float y = block_affine_carry<false>(aA, aB, aff_buf);

    // pass 2: mY, and the band maximum of mM + mX + mY
    float lmax = -INFINITY;
    for (int b = b0; b < b1; ++b) {
      const float mM = sM[b], mX = sX[b];
      const int j = i + lo_p + b;
      const float mY = (j >= 1 && j <= n) ? y : 0.f;
      sY[b] = mY;
      lmax = fmaxf(lmax, (mM + mX) + mY);
      y = d * mM + e * y;
    }
    const float scale = fmaxf(block_max(lmax, max_buf), kTiny);

    // pass 3: rescale
    for (int b = b0; b < b1; ++b) {
      const float nM = sM[b] / scale;
      const float nX = sX[b] / scale;
      const float nY = sY[b] / scale;
      sM[b] = nM;
      sX[b] = nX;
      sY[b] = nY;
      if (i == end_row && b == b_end) s_end = nM + (nX + nY);
    }
    ls = ls + logf(scale);
    __syncthreads();
    if (vec_ok) {
      const float4* src = reinterpret_cast<const float4*>(sM);
      float4* dst = reinterpret_cast<float4*>(frow);
      for (int k = t; k < B / 4; k += T) dst[k] = src[k];
    } else {
      for (int k = t; k < B; k += T) frow[k] = sM[k];
    }
    if (t == 0) {
      lsF_out[(size_t)p * M + i - 1] = ls;
      if (i == end_row) logZ_out[p] = logf(fmaxf(s_end, kTiny)) + ls;
    }
  }
  if (M < end_row && t == 0) logZ_out[p] = logf(kTiny) + ls;
}

__global__ void __launch_bounds__(kMaxThreads)
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
  extern __shared__ float4 smem_f4[];
  float* sM = reinterpret_cast<float*>(smem_f4);   // bM of the row
  float* sX = sM + B;                              // bX of the row
  float* sT = sX + B;                              // x = bX[b-1], masked
  __shared__ float2 aff_buf[32];
  __shared__ float max_buf[33];
  __shared__ float s_em[36];

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

  for (int k = t; k < 36; k += T) s_em[k] = em[k];
  // rows past the pair's end have zero posterior (every row when m_len
  // is 0, or beyond the padded row count, where no terminal row exists)
  const bool live = m >= 1 && m <= M;
  for (size_t k = (size_t)(live ? m : 0) * B + t; k < (size_t)M * B; k += T)
    pp[k] = 0.f;
  if (!live) return;

  // terminal row i = m (the backward closed form at the pair's end)
  for (int b = b0; b < b1; ++b) {
    const int jn = n - (m + lo_p + b);
    sM[b] = jn == 0 ? 1.f
                    : (jn > 0 ? d * powf(e, (float)(jn - 1 > 0 ? jn - 1 : 0))
                              : 0.f);
    sX[b] = jn == 0 ? 1.f : 0.f;
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
        const float v = (frow[k] * sM[k]) * g;
        prow[k] = fminf(fmaxf(v, 0.f), 1.5f);
      }
    }
    if (i == 1) break;
    const float* erow = s_em + 6 * qp[i - 1];
    const float nbX = (b0 > 0 && b0 < b1) ? sX[b0 - 1] : 0.f;
    __syncthreads();

    // pass 1 (descending): mm, x, nX; compose the reverse chain maps
    // y -> e*y + (1-e)*mm
    float aA = 1.f, aB = 0.f;
    for (int b = b1 - 1; b >= b0; --b) {
      const int jprev = i - 1 + lo_p + b;
      float mm = erow[tp[i - 1 + b]] * sM[b];
      if (!(jprev + 1 <= n)) mm = 0.f;
      float x = b > b0 ? sX[b - 1] : nbX;
      if (!(jprev >= 0 && jprev <= n)) x = 0.f;
      sM[b] = mm;
      sX[b] = omE * mm + e * x;
      sT[b] = x;
      aB = e * aB + omE * mm;
      aA = aA * e;
    }
    // y[b1] = composite of every later cell's map applied to y[B] = 0
    float ynext = block_affine_carry<true>(aA, aB, aff_buf);

    // pass 2 (descending): y, nM, masks, band maximum
    float lmax = -INFINITY;
    for (int b = b1 - 1; b >= b0; --b) {
      const int jprev = i - 1 + lo_p + b;
      const float mm = sM[b], x = sT[b];
      const float y = omE * mm + e * ynext;
      float nM = (tMM * mm + d * x) + d * ynext;
      float nX = sX[b];
      float nY = y;
      if (!(jprev >= 0 && jprev <= n)) {
        nM = 0.f;
        nX = 0.f;
        nY = 0.f;
      }
      lmax = fmaxf(lmax, (nM + nX) + nY);
      sM[b] = nM;
      sX[b] = nX;
      ynext = y;
    }
    const float scale = fmaxf(block_max(lmax, max_buf), kTiny);
    for (int b = b0; b < b1; ++b) {
      sM[b] = sM[b] / scale;
      sX[b] = sX[b] / scale;
    }
    ls = ls + logf(scale);
    __syncthreads();
  }
}

int threads_for(int B) {
  return B >= kMaxThreads ? kMaxThreads : ((B + 31) / 32) * 32;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

size_t pairhmm_smem_bytes(int B) { return (size_t)3 * B * sizeof(float); }

int pairhmm_fwd_launch(const void* q, const void* t_shift, const void* m_len,
                       const void* n_len, const void* lo, const void* em,
                       int P, int M, int B, float d, float e, float tMM,
                       float omE, void* fM, void* lsF, void* logZ,
                       void* stream) {
  if (P <= 0) return 0;
  const size_t smem = pairhmm_smem_bytes(B);
  cudaError_t err = cudaFuncSetAttribute(
      pairhmm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  pairhmm_fwd_kernel<<<P, threads_for(B), smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(t_shift),
      static_cast<const int*>(m_len), static_cast<const int*>(n_len),
      static_cast<const int*>(lo), static_cast<const float*>(em), M, B, d, e,
      tMM, omE, static_cast<float*>(fM), static_cast<float*>(lsF),
      static_cast<float*>(logZ));
  return (int)cudaGetLastError();
}

int pairhmm_bwd_launch(const void* fM, const void* lsF, const void* logZ,
                       const void* q, const void* t_shift, const void* m_len,
                       const void* n_len, const void* lo, const void* em,
                       int P, int M, int B, float d, float e, float tMM,
                       float omE, void* post, void* stream) {
  if (P <= 0) return 0;
  const size_t smem = pairhmm_smem_bytes(B);
  cudaError_t err = cudaFuncSetAttribute(
      pairhmm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  pairhmm_bwd_kernel<<<P, threads_for(B), smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fM), static_cast<const float*>(lsF),
      static_cast<const float*>(logZ), static_cast<const uint8_t*>(q),
      static_cast<const uint8_t*>(t_shift), static_cast<const int*>(m_len),
      static_cast<const int*>(n_len), static_cast<const int*>(lo),
      static_cast<const float*>(em), M, B, d, e, tMM, omE,
      static_cast<float*>(post));
  return (int)cudaGetLastError();
}

}  // extern "C"
