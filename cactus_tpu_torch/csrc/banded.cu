// Banded global affine-gap DP (Gotoh H/I/D) and its traceback, for
// NVIDIA Hopper (built for sm_90a, bound with ctypes).
//
// banded_dp replaces the Pallas TPU kernel
// cactus_tpu/ops/banded_pallas.py::_kernel (entry
// banded_align_batch_pallas).  Its contract is
// cactus_tpu/ops/banded.py::banded_align_batch, and its outputs match the
// plain PyTorch version, cactus_tpu_torch/ops/banded.py::banded_align_batch:
//   dirs (P, M, B) uint8   bits 0-1 H source {H,I,D}, bit 2 I opened
//                          fresh, bit 3 D opened fresh
//   end_scores (P, 3) int32  H, I, D at each pair's end cell
//   end_mat (P,) int32       first argmax of end_scores
//
// Live cells.  A pair's live cells are the band cells (i, b) with
// 1 <= i <= m and 0 <= j = i + lo + b <= n: the cells inside its DP
// matrix.  The kernel computes only those.  end_scores, end_mat and the
// dirs byte of every live cell are bit-equal to the plain version; the
// other dirs bytes are unspecified (the wrapper allocates dirs with
// torch.empty).  That is sound because
//   - banded_traceback, the only reader of dirs on the card, reads only
//     cells with 1 <= i <= m and 1 <= j <= n;
//   - a live cell reads only live cells and the band cells left of its
//     row's j = 0 column: H and I read the previous row at j - 1 and j,
//     and the D chain reads the cells to its left.  A cell left of j = 0
//     (j < 0) is never written after the row-0 init, where H, I and D are
//     NEG, which is what the plain version holds there on every row;
//   - cells with j > n and rows past m feed no live cell.
// Row i's live window is b_lo(i) = max(0, -i - lo) .. b_hi(i) =
// min(B - 1, n - i - lo); it slides one band cell left a row.  The D chain
// of the skipped cells left of b_lo, all H = NEG, contributes
// max_{c < b_lo} (NEG + extend * (c + 1)) = NEG + extend * b_lo to the
// scan's seed: with NEG alone, bit 3 of the j = 0 cell would differ from
// the plain version.  Row 0 is initialised only on the band cells a live
// cell reads: from b_lo(m) (the j = -1 cell read by row m's j = 0 cell)
// up to b_hi(1) + 1 (the I predecessor of row 1's last live cell).
//
// What bounds it on an H100: integer operations.  The recurrence needs
// 22 int32 operations a live cell (max/compare/select/add/clamp), 15
// where Hopper's DPX instructions fuse them (see
// ops/banded_cuda.py::BANDED_OPS_PER_CELL), and writes one byte a live
// cell, so the ALUs, not the 3.35 TB/s of device memory, set the floor.
// This kernel does more than that per cell (two passes and a scan of the
// D chain) and uses no DPX instruction.  The design keeps all DP state on
// chip: one thread block per pair, each row's live window split across
// the block's threads into contiguous runs of C = ceil(min(B, n + 1) /
// threads) cells from the window's left end (C is fixed per pair, so a
// row needs no division).  The previous row's H/I/D live in shared
// memory with band indexing (12 bytes a band cell, 192 KB at
// B = 16384); only the direction bytes of the live window go to device
// memory, staged in shared memory and stored with 16-byte vector writes
// (the 16-byte chunks that hold the window, so a few dead bytes at its
// ends are written too).
// The D chain (an inclusive max-scan along the band on the TPU) is a
// sequential max inside each thread plus one warp-shuffle / shared-memory
// exclusive max-scan of the per-thread maxima; max is exact in int32, so
// any scan order gives the same bits.  The block's width follows the
// widest live row of the launch (max_live): about four live cells a
// thread when the launch has enough pairs to fill the card, one a thread
// (up to 256 threads) when it has few, so a short-pair launch runs one
// warp a pair and a wide one keeps 256 threads.
//
// banded_traceback is device code with no Pallas counterpart: it replaces
// the vmapped lax.while_loop of
// cactus_tpu/ops/banded.py::traceback_band_batch_device.  One thread per
// pair walks the direction bytes in device memory with the HOST semantics
// of traceback_band (a walk that leaves the band reports count -1), so
// only O(m + n) move codes come back to the host.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kNeg = -(1 << 28);   // banded.py NEG
constexpr int kMaxThreads = 256;

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// Exclusive max-scan over the block of one int per thread, seeded with
// `seed` (thread 0 gets `seed`).  blockDim.x is a multiple of 32.
__device__ int block_exclusive_max(int v, int seed, int* warp_buf) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl = imax(incl, o);
  }
  int excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = INT_MIN;
  if (lane == 31) warp_buf[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = INT_MIN;
    for (int w = 0; w < nwarps; ++w) {
      const int tot = warp_buf[w];
      warp_buf[w] = acc;
      acc = imax(acc, tot);
    }
  }
  __syncthreads();
  return imax(seed, imax(warp_buf[warp], excl));
}

__device__ __forceinline__ void write_end(int* end_scores, int* end_mat,
                                          int p, int h, int i, int d) {
  end_scores[3 * p + 0] = h;
  end_scores[3 * p + 1] = i;
  end_scores[3 * p + 2] = d;
  end_mat[p] = (h >= i && h >= d) ? 0 : (i >= d ? 1 : 2);
}

__global__ void __launch_bounds__(kMaxThreads)
banded_dp_kernel(const uint8_t* __restrict__ q,
                 const uint8_t* __restrict__ t_shift,
                 const int* __restrict__ m_len,
                 const int* __restrict__ n_len,
                 const int* __restrict__ lo,
                 const int* __restrict__ submat,
                 int M, int B, int gap_open, int gap_extend,
                 uint8_t* __restrict__ dirs,
                 int* __restrict__ end_scores,
                 int* __restrict__ end_mat) {
  extern __shared__ int4 smem_raw[];
  int* sH = reinterpret_cast<int*>(smem_raw);
  int* sI = sH + B;
  int* sD = sI + B;
  int* sLastH = sD + B;                                   // [blockDim.x]
  uint8_t* sDir = reinterpret_cast<uint8_t*>(sLastH + blockDim.x);  // [B]
  __shared__ int warp_buf[32];
  __shared__ int s_sub[36];

  const int p = blockIdx.x;
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int lo_p = lo[p];
  const int m = m_len[p];
  const int n = n_len[p];
  const int b_end = n - m - lo_p;
  // no cell holds the end (malformed input): report NEG, as an unreached
  // end would be, and compute nothing
  if (b_end < 0 || b_end >= B || m < 0 || m > M) {
    if (t == 0) write_end(end_scores, end_mat, p, kNeg, kNeg, kNeg);
    return;
  }
  const uint8_t* qp = q + (size_t)p * M;
  const uint8_t* tp = t_shift + (size_t)p * (M + B);
  uint8_t* dp = dirs + (size_t)p * M * B;

  for (int k = t; k < 36; k += T) s_sub[k] = submat[k];
  // row 0 (j = lo + b) on the band cells live cells read
  const int r0_lo = max(0, -m - lo_p);
  const int r0_hi = min(B - 1, n - lo_p);
  for (int b = r0_lo + t; b <= r0_hi; b += T) {
    const int j0 = lo_p + b;
    const int h = j0 == 0 ? 0 : kNeg;
    const int d = j0 > 0 ? -(gap_open + j0 * gap_extend) : kNeg;
    sH[b] = h;
    sI[b] = kNeg;
    sD[b] = d;
    if (m == 0 && b == b_end) write_end(end_scores, end_mat, p, h, kNeg, d);
  }
  __syncthreads();

  const bool vec_ok = (B % 16) == 0;
  // each thread's share of a row: C cells from b_lo + t * C, C covering
  // the widest live row (at most min(B, n + 1) cells)
  const int C = (min(B, n + 1) + T - 1) / T;
  for (int i = 1; i <= m; ++i) {
    const int jz = -i - lo_p;          // the band index of j = 0
    const int b_lo = max(0, jz);
    const int b_hi = min(B - 1, n + jz);
    const int b0 = min(b_lo + t * C, b_hi + 1);
    const int b1 = min(b0 + C, b_hi + 1);
    const int* srow = s_sub + 6 * qp[i - 1];
    // the previous row's cell b1 belongs to the next thread: read it
    // before anyone overwrites the row
    int nbH = kNeg, nbI = kNeg;
    if (b1 < B && b0 < b1) {
      nbH = sH[b1];
      nbI = sI[b1];
    }
    __syncthreads();

    // pass 1: H (unclamped), I, the H-source and I-fresh bits, and this
    // thread's max of Z[c] = H[c] + extend * (c + 1) (the D-chain terms)
    int agg = INT_MIN;
    int hn = kNeg;
    for (int b = b0; b < b1; ++b) {
      const int Hp = sH[b], Ip = sI[b], Dp = sD[b];
      const int Hu = b + 1 < b1 ? sH[b + 1] : nbH;
      const int Iu = b + 1 < b1 ? sI[b + 1] : nbI;
      const int hi = imax(Hp, Ip);
      const int prev_best = imax(hi, Dp);
      int h_src = Hp >= Ip ? 0 : 1;
      if (Dp > hi) h_src = 2;
      hn = prev_best + srow[tp[i - 1 + b]];
      const bool i_fresh = (Hu - gap_open) >= Iu;
      int In = imax(Hu - gap_open, Iu) - gap_extend;
      if (b == jz) {                   // the left DP boundary
        In = -(gap_open + i * gap_extend);
        hn = kNeg;
      }
      sH[b] = hn;
      sI[b] = imax(In, kNeg);
      sDir[b] = (uint8_t)(h_src | (i_fresh ? 4 : 0));
      agg = imax(agg, hn + gap_extend * (b + 1));
    }
    if (b0 < b1) sLastH[t] = hn;
    // run = max(Z[c] for every c < b0), seeded with the chain of the
    // skipped cells left of b_lo (H = NEG there) and of Hl[0] = NEG
    int run = block_exclusive_max(agg, kNeg + imax(0, gap_extend * b_lo),
                                  warp_buf);

    // pass 2: D from the max-scan, the D-fresh bit, clamps, end capture
    int hl = t == 0 ? kNeg : sLastH[t - 1];
    for (int b = b0; b < b1; ++b) {
      const int hn_unc = sH[b];
      int Dn = run - gap_open - gap_extend * (b + 1);
      const bool d_fresh = Dn == (hl - gap_open - gap_extend);
      if (b == jz) Dn = kNeg;
      Dn = imax(Dn, kNeg);
      const int Hc = imax(hn_unc, kNeg);
      sH[b] = Hc;
      sD[b] = Dn;
      sDir[b] = (uint8_t)(sDir[b] | (d_fresh ? 8 : 0));
      if (i == m && b == b_end)
        write_end(end_scores, end_mat, p, Hc, sI[b], Dn);
      run = imax(run, hn_unc + gap_extend * (b + 1));
      hl = hn_unc;
    }
    __syncthreads();
    // coalesced store of the row's live direction bytes
    uint8_t* drow = dp + (size_t)(i - 1) * B;
    if (b_lo <= b_hi) {
      if (vec_ok) {
        const int4* src = reinterpret_cast<const int4*>(sDir);
        int4* dst = reinterpret_cast<int4*>(drow);
        for (int k = (b_lo >> 4) + t; k <= (b_hi >> 4); k += T)
          dst[k] = src[k];
      } else {
        for (int b = b_lo + t; b <= b_hi; b += T) drow[b] = sDir[b];
      }
    }
  }
}

__global__ void banded_traceback_kernel(const uint8_t* __restrict__ dirs,
                                        const int* __restrict__ m_len,
                                        const int* __restrict__ n_len,
                                        const int* __restrict__ lo,
                                        const int* __restrict__ end_mat,
                                        int P, int M, int B, int S,
                                        uint8_t* __restrict__ moves,
                                        int* __restrict__ counts) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const uint8_t* d = dirs + (size_t)p * M * B;
  uint8_t* mv = moves + (size_t)p * S;
  int i = m_len[p], j = n_len[p], cur = end_mat[p], k = 0;
  const int lo_p = lo[p];
  if (i > M) k = -1;
  while (k >= 0 && (i > 0 || j > 0)) {
    if (k >= S) {
      k = -1;
      break;
    }
    if (i == 0) {
      mv[k++] = 3;
      --j;
      continue;
    }
    if (j == 0) {
      mv[k++] = 2;
      --i;
      continue;
    }
    const int b = j - i - lo_p;
    if (b < 0 || b >= B) {   // the walk left the band
      k = -1;
      break;
    }
    const uint8_t byte = d[(size_t)(i - 1) * B + b];
    if (cur == 0) {
      mv[k++] = 1;
      cur = byte & 3;
      --i;
      --j;
    } else if (cur == 1) {
      mv[k++] = 2;
      cur = ((byte >> 2) & 1) ? 0 : 1;
      --i;
    } else {
      mv[k++] = 3;
      cur = ((byte >> 3) & 1) ? 0 : 2;
      --j;
    }
  }
  counts[p] = k;
}

size_t banded_dp_smem_bytes(int B, int T) {
  return ((size_t)3 * B + T) * sizeof(int) + ((B + 15) / 16) * 16;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Threads a block for P pairs of band B whose widest live row is W
// (max_live): about four live cells a thread when the launch fills the
// card (P >= 4 blocks an SM), else one, in warps, 32 to 256.
int banded_dp_threads(int B, int W, int P) {
  W = W < 1 ? 1 : (W > B ? B : W);
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int per_warp = 32 * (P >= 4 * sms ? 4 : 1);
  const int T = 32 * ((W + per_warp - 1) / per_warp);
  return T < 32 ? 32 : (T > kMaxThreads ? kMaxThreads : T);
}

// Resident blocks an SM for that launch (the occupancy the launcher
// gets), or minus the CUDA error code.
int banded_dp_occupancy(int B, int W, int P) {
  const int T = banded_dp_threads(B, W, P);
  const size_t smem = banded_dp_smem_bytes(B, T);
  cudaError_t err = cudaFuncSetAttribute(
      banded_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks,
                                                      banded_dp_kernel, T,
                                                      smem);
  return err != cudaSuccess ? -(int)err : blocks;
}

int banded_dp_launch(const void* q, const void* t_shift, const void* m_len,
                     const void* n_len, const void* lo, const void* submat,
                     int P, int M, int B, int W, int gap_open, int gap_extend,
                     void* dirs, void* end_scores, void* end_mat,
                     void* stream) {
  if (P <= 0) return 0;
  const int T = banded_dp_threads(B, W, P);
  const size_t smem = banded_dp_smem_bytes(B, T);
  cudaError_t err = cudaFuncSetAttribute(
      banded_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  banded_dp_kernel<<<P, T, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(t_shift),
      static_cast<const int*>(m_len), static_cast<const int*>(n_len),
      static_cast<const int*>(lo), static_cast<const int*>(submat), M, B,
      gap_open, gap_extend, static_cast<uint8_t*>(dirs),
      static_cast<int*>(end_scores), static_cast<int*>(end_mat));
  return (int)cudaGetLastError();
}

int banded_traceback_launch(const void* dirs, const void* m_len,
                            const void* n_len, const void* lo,
                            const void* end_mat, int P, int M, int B, int S,
                            void* moves, void* counts, void* stream) {
  if (P <= 0) return 0;
  const int T = 128;
  banded_traceback_kernel<<<(P + T - 1) / T, T, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(dirs), static_cast<const int*>(m_len),
      static_cast<const int*>(n_len), static_cast<const int*>(lo),
      static_cast<const int*>(end_mat), P, M, B, S,
      static_cast<uint8_t*>(moves), static_cast<int*>(counts));
  return (int)cudaGetLastError();
}

}  // extern "C"
