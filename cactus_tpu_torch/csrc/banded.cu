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
// min(B - 1, n - i - lo); it slides one band cell left a row while
// -i - lo > 0.  In banded_dp_kernel's max-scan form the D chain
// of the skipped cells left of b_lo, all H = NEG, contributes
// max_{c < b_lo} (NEG + extend * (c + 1)) = NEG + extend * b_lo to the
// scan's seed: with NEG alone, bit 3 of the j = 0 cell would differ from
// the plain version.  banded_dp_kernel initialises row 0 only on the
// band cells a live cell reads: from b_lo(m) (the j = -1 cell read by
// row m's j = 0 cell) up to b_hi(1) + 1 (the I predecessor of row 1's
// last live cell).
//
// What bounds it on an H100: integer operations.  The recurrence needs
// 22 int32 operations a live cell (max/compare/select/add/clamp), 15
// where Hopper's DPX instructions fuse them (see
// ops/banded_cuda.py::BANDED_OPS_PER_CELL), and writes one byte a live
// cell, so the ALUs, not the 3.35 TB/s of device memory, set the floor.
// A launch of a few long pairs is bound instead by one pair's chain of
// rows: each row's D chain runs through the whole live window.
//
// Two kernels, by the launch's widest live row W = max_live
// (banded_dp_launch): banded_dp_warp_kernel for W <= kWarpMaxLive (256;
// the band-128 gap fills and the BAR short ends), banded_dp_kernel for
// wider rows.  Both keep all DP state on chip and store only the live
// direction bytes.
//
// banded_dp_warp_kernel: one warp a pair, a block each, and no block
// barrier.  Lane L holds C = max(2, ceil(W / 32)) <= 8 consecutive cells
// k = L*C .. L*C + C - 1 of each row's live window (band index
// b = b_lo(i) + k) in registers, with its previous row's H, I and D.
// Between rows the window moves by delta(i) = b_lo(i - 1) - b_lo(i) in
// {0, 1}, the same for every lane: cell k's H predecessor is the previous
// row's window index k - delta, its I predecessor k + 1 - delta, so one
// map covers the BAR short ends (whose window slides a cell a row) and
// the long gap fills (whose window stands still).  The D chain is a
// recursion, not a scan:
//   Dunc[b] = max(Hl[b] - open - extend, Dunc[b - 1] - extend),
// Hl[b] the row's unclamped H at b - 1, which is the plain version's
// Y[b] - open - extend * (b + 1) exactly (max is exact in int32); it
// starts at b_lo from the skipped cells' seed (NEG + extend * b_lo in
// the scan's form), and d_fresh compares Dunc with Hl - open - extend.
// The lanes run a skewed wavefront: lane L computes row i at step
// i - 1 + L, one round of warp shuffles a step, every lane busy once the
// pipe is full (m + 31 steps at most).  Lane L - 1's row i (its chain
// carry and last H) came one step before, and its row i - 1 (the H
// predecessor of L's first cell where the window slides) two.  Where the
// window stands still, L's last cell reads lane L + 1's first cell of
// row i - 1, which L + 1 computes at the same step: L computes that
// cell too (the ghost, H and I only), from L + 1's row i - 2 (cells 0
// and 1, hence C >= 2) and its score, and from L's own chain.  A step
// of the skew-2 schedule (lane L on row i at step 2 (i - 1) + L, the
// I predecessor a step old) takes as many instruction slots as a row of
// this one, since half the warp waits at each: PERF.md section 6
// measures both.  The steps whose lanes all stand on rows
// 2 - lo .. m - 1 (most of a long gap fill) run a step compiled without
// the sliding window, the first and the last row.  One pair a block:
// four pairs sharing an SM's shuffle and load units ran slower a row.
// q and t_shift bytes are loaded two steps ahead and looked up in the
// score table a step ahead, every lane at once; each lane stores its C
// direction bytes directly, in one vector store where they lie aligned
// inside the band (staging rows in shared memory for 16-byte stores was
// slower, PERF.md section 6).  No DPX instruction: with __vibmax_s32
// (max and its a >= b predicate) and __viaddmax_s32 (max(a + b, c)) in
// max_ge and add_max the kernel ran ~7% slower (PERF.md section 6 has
// both timings).
//
// banded_dp_kernel (W > 256): one thread block per pair, each row's live
// window split across the block's threads into contiguous runs of
// C = ceil(min(B, n + 1) / threads) cells from the window's left end (C
// is fixed per pair, so a row needs no division).  The previous row's
// H/I/D live in shared memory with band indexing (12 bytes a band cell,
// 192 KB at B = 16384); only the direction bytes of the live window go
// to device memory, staged in shared memory and stored with 16-byte
// vector writes (the 16-byte chunks that hold the window, so a few dead
// bytes at its ends are written too).
// The D chain (an inclusive max-scan along the band on the TPU) is a
// sequential max inside each thread plus one warp-shuffle / shared-memory
// exclusive max-scan of the per-thread maxima; max is exact in int32, so
// any scan order gives the same bits.  The block's width follows the
// widest live row of the launch (max_live): about four live cells a
// thread when the launch has enough pairs to fill the card, one a thread
// (up to 256 threads) when it has few.
//
// banded_traceback is device code with no Pallas counterpart: it replaces
// the vmapped lax.while_loop of
// cactus_tpu/ops/banded.py::traceback_band_batch_device, with the HOST
// semantics of traceback_band (a walk that leaves the band, or needs more
// than S moves, reports count -1 and no moves), so only O(m + n) move
// codes come back to the host.  A walk is a chain of m + n dependent
// steps, each reading the byte the previous one chose: its floor on an
// H100 is that chain's latency, not the 2 bytes a step it moves.  So each
// step must read on-chip memory.  One warp walks a pair: it stages a
// tile of the pair's direction bytes in shared memory with 16-byte
// cp.async copies (all in flight at once, one round trip a tile), one
// lane walks it, and the warp restages when the walk leaves the tile.
// The tile rule: the walk only climbs (row i falls by one on an M or an
// I and stays on a D), and its band column b = j - i - lo stays on an M,
// rises by one on an I and falls by one on a D.  So a tile of K rows,
// from the current row up, whose right edge is K - 1 columns right of
// the current b, holds every byte the next K rows read unless a D run
// crosses its left edge, which restages.  Each tile row is clipped to
// the row's live window (b_lo(r) .. b_hi(r), as above): those are the
// bytes the walk can read (1 <= i <= m, 1 <= j <= n), and the only ones
// banded_dp specifies.  A short pair (the BAR ends) fits one tile; a
// long band-128 pair takes whole 128-byte rows, K at a time.  The walk
// runs from shared memory with two loads in flight (the next cell
// depends on the state, not on the byte just read).  Its moves go to a
// shared buffer that the warp stores with coalesced writes.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

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

// ---------------------------------------------------------------- warp

constexpr int kWarpMaxLive = 256;      // ops/banded_cuda.py WARP_MAX_LIVE

// max(a, b), and a_ge = a >= b (DPX's __vibmax_s32 computes the same and
// ran slower here, PERF.md section 6)
__device__ __forceinline__ int max_ge(int a, int b, bool& a_ge) {
  a_ge = a >= b;
  return a_ge ? a : b;
}

// max(a + b, c) (DPX's __viaddmax_s32, likewise)
__device__ __forceinline__ int add_max(int a, int b, int c) {
  return imax(a + b, c);
}

// A row's bytes for lane cells b0 .. b0 + C - 1 (band indices): t_shift
// at i - 1 + b, clamped into the band (cells past it are dead), and q.
template <int C>
__device__ __forceinline__ void warp_load_row(const uint8_t* qp,
                                              const uint8_t* tp, int i,
                                              int b0, int B, int& qb,
                                              int (&tb)[C]) {
  qb = __ldg(qp + i - 1);
#pragma unroll
  for (int c = 0; c < C; ++c) tb[c] = __ldg(tp + i - 1 + min(b0 + c, B - 1));
}

// One lane's C cells of row i.  kSlide: the window moved one band cell
// left since the previous row (delta = 1), so cell c's H/D predecessor
// is the previous row's cell c - 1 (lH/lI/lD, lane - 1's last cell, for
// c = 0) and its I predecessor cell c; else cell c and c + 1 (gH/gI,
// lane + 1's first cell, for c = C - 1).  dch / hl: the D chain's value
// at the lane's first cell and the unclamped H left of it.  H/I/D become
// row i's clamped values, Hu the unclamped H, dir the direction bytes;
// returns the chain's value at the next lane's first cell.
template <int C, bool kSlide>
__device__ __forceinline__ int warp_row(int (&H)[C], int (&I)[C], int (&D)[C],
                                        int (&Hu)[C], int (&dir)[C],
                                        const int (&sc)[C], int lH, int lI,
                                        int lD, int gH, int gI, int dch,
                                        int hl, bool j0, int i, int go,
                                        int ge) {
  const int oe = go + ge;
  int In[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int Hp = kSlide ? (c ? H[c - 1] : lH) : H[c];
    const int Ip = kSlide ? (c ? I[c - 1] : lI) : I[c];
    const int Dp = kSlide ? (c ? D[c - 1] : lD) : D[c];
    const int Hq = kSlide ? H[c] : (c + 1 < C ? H[c + 1] : gH);
    const int Iq = kSlide ? I[c] : (c + 1 < C ? I[c + 1] : gI);
    bool h_ge_i, hi_ge_d, i_fresh;
    const int hi = max_ge(Hp, Ip, h_ge_i);
    const int best = max_ge(hi, Dp, hi_ge_d);
    Hu[c] = best + sc[c];
    In[c] = max_ge(Hq - go, Iq, i_fresh);
    dir[c] = (hi_ge_d ? (h_ge_i ? 0 : 1) : 2) | (i_fresh ? 4 : 0);
  }
  if (j0) {                            // cell 0 is j = 0: the DP boundary
    Hu[0] = kNeg;
    In[0] = -(go + i * ge) + ge;       // I = -(open + i * extend)
  }
  int d = dch;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int hlt = (c ? Hu[c - 1] : hl) - oe;
    if (c) d = add_max(d, -ge, hlt);
    dir[c] |= d == hlt ? 8 : 0;
    D[c] = (c == 0 && j0) ? kNeg : imax(d, kNeg);
    H[c] = imax(Hu[c], kNeg);
    I[c] = add_max(In[c], -ge, kNeg);
  }
  return add_max(d, -ge, Hu[C - 1] - oe);
}

// V direction bytes from dir[u] as one little-endian word (V <= 4)
template <int V, int C>
__device__ __forceinline__ uint32_t pack_bytes(const int (&dir)[C], int u) {
  uint32_t w = 0;
#pragma unroll
  for (int x = 0; x < V; ++x) w |= (uint32_t)dir[u + x] << (8 * x);
  return w;
}

// dir's C bytes to dst in stores of V bytes (dst aligned to V)
template <int V, int C>
__device__ __forceinline__ void store_bytes(uint8_t* dst,
                                            const int (&dir)[C]) {
#pragma unroll
  for (int u = 0; u < C; u += V) {
    if constexpr (V == 8) {
      *reinterpret_cast<uint2*>(dst + u) =
          make_uint2(pack_bytes<4>(dir, u), pack_bytes<4>(dir, u + 4));
    } else if constexpr (V == 4) {
      *reinterpret_cast<uint32_t*>(dst + u) = pack_bytes<4>(dir, u);
    } else if constexpr (V == 2) {
      *reinterpret_cast<uint16_t*>(dst + u) = (uint16_t)pack_bytes<2>(dir, u);
    } else {
      dst[u] = (uint8_t)dir[u];
    }
  }
}

// One block of one warp a pair.  C >= 2 cells a lane: a lane's ghost of
// lane + 1's first cell reads lane + 1's second cell of the row before.
template <int C>
__global__ void __launch_bounds__(32)
banded_dp_warp_kernel(const uint8_t* __restrict__ q,
                      const uint8_t* __restrict__ t_shift,
                      const int* __restrict__ m_len,
                      const int* __restrict__ n_len,
                      const int* __restrict__ lo,
                      const int* __restrict__ submat,
                      int M, int B, int W, int gap_open,
                      int gap_extend, uint8_t* __restrict__ dirs,
                      int* __restrict__ end_scores,
                      int* __restrict__ end_mat) {
  static_assert(C >= 2, "the ghost cell reads lane + 1's second cell");
  constexpr unsigned kFull = 0xffffffffu;
  // the widest power of two (up to 8 bytes) that divides a lane's C bytes
  constexpr int V = (C & -C) > 8 ? 8 : (C & -C);
  __shared__ int sub[36];
  const int lane = threadIdx.x;
  const int p = blockIdx.x;
  for (int k = lane; k < 36; k += 32) sub[k] = submat[k];
  __syncwarp();
  const int lo_p = lo[p];
  const int m = m_len[p];
  const int n = n_len[p];
  const int b_end = n - m - lo_p;
  // no cell holds the end (malformed input; n < 0 has no live cell and
  // the plain version's end is NEG there too): report NEG, compute nothing
  if (b_end < 0 || b_end >= B || m < 0 || m > M || n < 0) {
    if (lane == 0) write_end(end_scores, end_mat, p, kNeg, kNeg, kNeg);
    return;
  }
  const int go = gap_open, ge = gap_extend;
  if (m == 0) {                        // the end is on row 0, j = n
    if (lane == 0)
      write_end(end_scores, end_mat, p, n == 0 ? 0 : kNeg, kNeg,
                n > 0 ? -(go + n * ge) : kNeg);
    return;
  }
  const uint8_t* qp = q + (size_t)p * M;
  const uint8_t* tp = t_shift + (size_t)p * (M + B);
  uint8_t* dp = dirs + (size_t)p * M * B;
  // lanes with live cells: a row has at most min(B, n + 1) of them
  const int nl = (min(W, min(B, n + 1)) + C - 1) / C;
  const int k0 = lane * C;

  // row 0 in registers, band index b = b_lo(0) + k; lanes without live
  // cells and cells past the band hold NEG
  const int bl0 = max(0, -lo_p);
  int H[C], I[C], D[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int b = bl0 + k0 + c, j0 = lo_p + b;
    const bool in = lane < nl && b < B;
    H[c] = in && j0 == 0 ? 0 : kNeg;
    I[c] = kNeg;
    D[c] = in && j0 > 0 ? -(go + j0 * ge) : kNeg;
  }
  // lane - 1's last cell of the previous row (row 0 here), the H/D
  // predecessor of this lane's first cell when the window slides; NEG
  // left of the window (lane 0 keeps it)
  int lH, lI = kNeg, lD;
  {
    const int b = bl0 + k0 - 1, j0 = lo_p + b;
    lH = b >= 0 && j0 == 0 ? 0 : kNeg;
    lD = b >= 0 && j0 > 0 ? -(go + j0 * ge) : kNeg;
  }
  // this lane's last cell of the row before its last computed one: the
  // H/D predecessor of the ghost cell (below) where the window slides
  int pH = kNeg, pI = kNeg, pD = kNeg;
  // the D chain past this lane's last cell and the unclamped H there
  int Dn = kNeg, Hl = kNeg;
  // lane L computes row i at step i - 1 + L; q / t_shift bytes and
  // scores go two and one steps ahead, every lane at once
  auto row_of = [&](int s) { return min(max(s - lane + 1, 1), m); };
  int sc[C], sc2[C], tb[C], qb;
  warp_load_row<C>(qp, tp, row_of(0), max(0, -row_of(0) - lo_p) + k0, B,
                   qb, tb);
#pragma unroll
  for (int c = 0; c < C; ++c) sc[c] = sub[6 * qb + tb[c]];
  warp_load_row<C>(qp, tp, row_of(1), max(0, -row_of(1) - lo_p) + k0, B,
                   qb, tb);
#pragma unroll
  for (int c = 0; c < C; ++c) sc2[c] = sub[6 * qb + tb[c]];
  warp_load_row<C>(qp, tp, row_of(2), max(0, -row_of(2) - lo_p) + k0, B,
                   qb, tb);

  // rows start V-aligned: one store of V bytes where b0 is aligned too
  const bool vec_ok = V > 1 && (reinterpret_cast<uintptr_t>(dp) % V) == 0 &&
                      (B % V) == 0;
  const int steps = m + nl - 1;
  // One step of the wavefront.  kFast: every lane with live cells is on a
  // row 2 - lo <= i <= m - 1 (and lanes past them on any row), so the
  // window and the ghost's stand still (b_lo = 0), no lane is on row 1 or
  // m, and lanes past nl store nothing: the step skips those cases.
  auto step = [&](int s, auto fast) {
    constexpr bool kFast = decltype(fast)::value;
    // from lane - 1, its row i (this lane's row): the chain and last H,
    // and its last cell for this lane's next row; from lane + 1, its row
    // i - 2 (cells 0 and 1) and its score of row i - 1, for the ghost
    const int upDn = __shfl_up_sync(kFull, Dn, 1);
    const int upHl = __shfl_up_sync(kFull, Hl, 1);
    int upH = kNeg, upI = kNeg, upD = kNeg;
    if constexpr (!kFast) {
      upH = __shfl_up_sync(kFull, H[C - 1], 1);
      upI = __shfl_up_sync(kFull, I[C - 1], 1);
      upD = __shfl_up_sync(kFull, D[C - 1], 1);
    }
    const int rH0 = __shfl_down_sync(kFull, H[0], 1);
    const int rI0 = __shfl_down_sync(kFull, I[0], 1);
    const int rD0 = __shfl_down_sync(kFull, D[0], 1);
    const int rH1 = __shfl_down_sync(kFull, H[1], 1);
    const int rI1 = __shfl_down_sync(kFull, I[1], 1);
    const int rS0 = __shfl_down_sync(kFull, sc[0], 1);
    // lanes past nl compute rows too: their cells are dead or past the
    // band, so no live cell reads them, and they store nothing
    const int i = s - lane + 1;
    if (kFast || (i >= 1 && i <= m)) {
      const int jz = -i - lo_p;        // the band index of j = 0
      const int bl = kFast ? 0 : max(0, jz);
      const int b0 = bl + k0;
      const bool slide = !kFast && jz >= 0;  // b_lo(i - 1) = b_lo(i) + 1
      // where the window stands still, the I predecessor of this lane's
      // last cell is lane + 1's first cell of row i - 1, which lane + 1
      // computes at this very step: the lane computes it too (the ghost),
      // from lane + 1's row i - 2 (row 0: its first cell as it is)
      int gH = rH0, gI = rI0;
      if (kFast || (!slide && i > 1)) {
        const int gz = jz + 1;         // row i - 1's j = 0 band index
        const bool gslide = !kFast && gz >= 0;
        bool x0, x1, x2;
        const int Hp = gslide ? pH : rH0, Ip = gslide ? pI : rI0;
        const int Dp = gslide ? pD : rD0;
        const int Hq = gslide ? rH0 : rH1, Iq = gslide ? rI0 : rI1;
        gH = imax(max_ge(max_ge(Hp, Ip, x0), Dp, x1) + rS0, kNeg);
        gI = add_max(max_ge(Hq - go, Iq, x2), -ge, kNeg);
        if ((kFast ? 0 : max(0, gz)) + k0 + C >= B) gH = gI = kNeg;
      }
      int dch, hl;
      if (lane == 0) {
        // Dunc[b_lo] from the skipped cells' seed: Y[b_lo] = NEG +
        // max(0, extend * b_lo) (every Hl up to b_lo is NEG)
        hl = kNeg;
        dch = kNeg + imax(0, ge * bl) - go - ge * (bl + 1);
      } else {
        hl = upHl;
        dch = upDn;
      }
      if constexpr (!kFast) {
        pH = H[C - 1];
        pI = I[C - 1];
        pD = D[C - 1];
      }
      int Hu[C], dir[C];
      const bool j0 = !kFast && lane == 0 && jz >= 0;
      Dn = slide ? warp_row<C, true>(H, I, D, Hu, dir, sc, lH, lI, lD, gH,
                                     gI, dch, hl, j0, i, go, ge)
                 : warp_row<C, false>(H, I, D, Hu, dir, sc, lH, lI, lD, gH,
                                      gI, dch, hl, j0, i, go, ge);
      Hl = Hu[C - 1];
      if (b0 + C > B) {                // cells past the band read as NEG
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (b0 + c >= B) H[c] = I[c] = kNeg;
      }
      if (!kFast && i == m) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (b0 + c == b_end)
            write_end(end_scores, end_mat, p, H[c], I[c], D[c]);
      }
      if (!kFast && lane) {
        lH = upH;
        lI = upI;
        lD = upD;
      }
      // the live direction bytes: one vector store where the lane's
      // bytes lie aligned inside the band (dead bytes there are
      // unspecified), else a byte a live cell
      const int b_hi = min(B - 1, n + jz);
      uint8_t* drow = dp + (size_t)(i - 1) * B;
      if (b0 <= b_hi && (!kFast || lane < nl)) {
        if (vec_ok && b0 + C <= B && (b0 % V) == 0) {
          store_bytes<V>(drow + b0, dir);
        } else {
#pragma unroll
          for (int c = 0; c < C; ++c)
            if (b0 + c <= b_hi) drow[b0 + c] = (uint8_t)dir[c];
        }
      }
    }
    // the next step's scores; the bytes of the step after it
#pragma unroll
    for (int c = 0; c < C; ++c) {
      sc[c] = sc2[c];
      sc2[c] = sub[6 * qb + tb[c]];
    }
    const int r3 = row_of(s + 3);
    warp_load_row<C>(qp, tp, r3, max(0, -r3 - lo_p) + k0, B, qb, tb);
  };
  // the steps whose every lane with live cells is on a row of
  // max(2, 2 - lo) .. m - 1 run the fast step
  const int s1 = min(steps, max(nl, nl + max(0, -lo_p)));
  const int s2 = max(s1, m - 1);
  for (int s = 0; s < s1; ++s) step(s, std::false_type{});
  for (int s = s1; s < s2; ++s) step(s, std::true_type{});
  for (int s = s2; s < steps; ++s) step(s, std::false_type{});
}

// banded_traceback's tiles: a warp's shared slice is a K x pitch tile
// and a move buffer of 2K + tile_w bytes (a walk in one tile makes at
// most K row moves and tile_w + K column moves).
constexpr int kTbWarps = 4;            // pairs a block
constexpr int kTileW = 256;            // widest tile, band columns
constexpr int kTileBytes = 16384;      // a warp's tile budget
constexpr int kTileMaxRows = 256;
// a block's shared bytes at most: K * pitch <= kTileBytes, and a move
// buffer of at most 2 * kTileMaxRows + kTileW bytes a warp
constexpr int kTbMaxSmem = kTbWarps * (kTileBytes + 2 * kTileMaxRows + kTileW);

__host__ __device__ __forceinline__ int tb_warp_bytes(int tile_w, int pitch,
                                                      int K) {
  return K * pitch + ((2 * K + tile_w + 15) & ~15);
}

// The walk's state is 0 (H: an M move), 1 (I: an I move) or 2 (D: a D
// move); traceback_band treats any other as D.  tb_delta is the tile
// offset's change on the move the state makes, tb_next the state the
// cell's byte then picks: H takes its source from bits 0-1 (3 reads as
// D), I stays unless bit 2 says it opened fresh, D unless bit 3 does.
// Both are selects, not branches: the step's chain has no divergent
// branch to reconverge.
__device__ __forceinline__ int tb_delta(int cur, int pitch) {
  return cur == 0 ? pitch : (cur == 1 ? pitch + 1 : -1);
}

__device__ __forceinline__ int tb_next(int cur, int byte) {
  const int h_src = min(byte & 3, 2);
  const int stay = ((byte >> (cur + 1)) & 1) ? 0 : cur;
  return cur == 0 ? h_src : stay;
}

// A 16-byte copy from device to shared memory that does not hold the
// thread (cp.async): a lane issues all of its tile's copies, then waits
// once, so staging a tile costs one round trip, not one a row.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One warp a pair.  The warp stages a tile of the pair's direction bytes
// in its slice of shared memory: rows r_top..r_bot (at most K, from the
// walk's current row up) and band columns c_lo..c_hi (at most tile_w),
// each row clipped to its live window b_lo(r)..b_hi(r).  Lane 0 then
// walks the tile with the transitions of traceback_band, its moves going
// to a shared buffer that the warp stores with coalesced writes; the
// warp restages where the walk leaves the tile.  The tile's right edge
// is min(K, tile_w) - 1 columns right of the walk's column: the band
// column b only rises on an I move, which also climbs a row, so within K
// rows no read lies right of b + K - 1.  A long D run leaves through the
// left edge.
__global__ void __launch_bounds__(32 * kTbWarps)
banded_traceback_kernel(const uint8_t* __restrict__ dirs,
                        const int* __restrict__ m_len,
                        const int* __restrict__ n_len,
                        const int* __restrict__ lo,
                        const int* __restrict__ end_mat,
                        int P, int M, int B, int S, int tile_w, int pitch,
                        int K, uint8_t* __restrict__ moves,
                        int* __restrict__ counts) {
  extern __shared__ int4 tb_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p = blockIdx.x * kTbWarps + warp;
  if (p >= P) return;
  uint8_t* tile = reinterpret_cast<uint8_t*>(tb_smem) +
                  (size_t)warp * tb_warp_bytes(tile_w, pitch, K);
  uint8_t* buf = tile + (size_t)K * pitch;   // 2K + tile_w moves
  const uint8_t* d = dirs + (size_t)p * M * B;
  uint8_t* mv = moves + (size_t)p * S;
  const int m = m_len[p], n = n_len[p], lo_p = lo[p];
  const int e = end_mat[p];
  int i = m, j = n, cur = e == 0 || e == 1 ? e : 2, k = 0;
  bool ok = m >= 0 && n >= 0 && m <= M;
  const bool vec = (B & 15) == 0;
  // 16-byte staging: 2^cl lanes over a tile row's chunks, 32 >> cl rows
  // at a time
  int cl = 0;
  while ((1 << cl) < (pitch >> 4)) ++cl;
  const int rsub = lane >> cl, csub = lane & ((1 << cl) - 1);
  const int rstep = 32 >> cl;

  while (ok && i > 0 && j > 0) {
    const int b = j - i - lo_p;
    if (b < 0 || b >= B) {   // the walk left the band
      ok = false;
      break;
    }
    const int r_bot = i, r_top = max(1, i - K + 1);
    const int c_hi = min(B - 1, b + min(K, tile_w) - 1);
    const int c_lo = max(0, c_hi - tile_w + 1);
    const int c_base = c_lo & ~15;
    if (vec) {
      for (int r = r_bot - rsub; r >= r_top; r -= rstep) {
        const int lo_r = max(c_lo, -r - lo_p);
        const int hi_r = min(c_hi, n - r - lo_p);
        const int ch = (lo_r >> 4) + csub;
        if (lo_r <= hi_r && ch <= (hi_r >> 4))
          cp_async16(tile + (r_bot - r) * pitch + (ch * 16 - c_base),
                     d + (size_t)(r - 1) * B + ch * 16);
      }
      cp_async_wait_all();
    } else {
      for (int r = r_bot; r >= r_top; --r) {
        const int hi_r = min(c_hi, n - r - lo_p);
        const uint8_t* drow = d + (size_t)(r - 1) * B;
        for (int c = max(c_lo, -r - lo_p) + lane; c <= hi_r; c += 32)
          tile[(r_bot - r) * pitch + (c - c_base)] = drow[c];
      }
    }
    __syncwarp();
    int cnt = 0, full = 0;
    if (lane == 0) {
      // The cell's offset in the tile moves with the walk: an M climbs a
      // row, an I a row and a column right, a D a column left.  Where the
      // walk goes next depends on the state it is in, not on the byte it
      // reads, so the next byte's load is issued before this byte picks
      // the next state: two loads are in flight.
      int off = (r_bot - i) * pitch + (b - c_base);
      const int room = S - k;
      int byte = tile[off];                  // the anchor lies in the tile
      while (true) {
        if (cnt >= room) {                   // more than S moves
          full = 1;
          break;
        }
        const int ni = i - (cur <= 1);
        const int nj = j - (cur != 1);
        const int noff = off + tb_delta(cur, pitch);
        const int nb = nj - ni - lo_p;
        // the next cell is read from this tile (r_top >= 1), or the walk
        // stops or restages there
        const bool next_in = ni >= r_top && nj > 0 && nb >= c_lo &&
                             nb <= c_hi;
        const int next_byte = next_in ? tile[noff] : 0;
        buf[cnt++] = (uint8_t)(cur + 1);
        cur = tb_next(cur, byte);
        i = ni;
        j = nj;
        off = noff;
        byte = next_byte;
        if (!next_in) break;
      }
    }
    i = __shfl_sync(0xffffffffu, i, 0);
    j = __shfl_sync(0xffffffffu, j, 0);
    cur = __shfl_sync(0xffffffffu, cur, 0);
    cnt = __shfl_sync(0xffffffffu, cnt, 0);
    full = __shfl_sync(0xffffffffu, full, 0);
    __syncwarp();              // lane 0's moves are in buf
    for (int x = lane; x < cnt; x += 32) mv[k + x] = buf[x];
    k += cnt;
    if (full) ok = false;
    __syncwarp();              // buf and the tile are free again
  }
  // the rest runs along row 0 (D moves) or column 0 (I moves) and reads
  // no byte
  const int rest = ok ? i + j : 0;
  if (ok && k + rest > S) ok = false;
  if (ok) {
    const uint8_t code = i == 0 ? 3 : 2;
    for (int x = lane; x < rest; x += 32) mv[k + x] = code;
    k += rest;
  } else {
    // a failed walk returns no moves, as the plain version does
    for (int x = lane; x < k; x += 32) mv[x] = 0;
  }
  if (lane == 0) counts[p] = ok ? k : -1;
}

size_t banded_dp_smem_bytes(int B, int T) {
  return ((size_t)3 * B + T) * sizeof(int) + ((B + 15) / 16) * 16;
}

// W clamped to 1..B
int clamp_live(int B, int W) { return W < 1 ? 1 : (W > B ? B : W); }

// The warp kernel's cells a lane for a launch whose widest live row is
// W (at least 2), or 0 where rows are wider than kWarpMaxLive (the
// block kernel).
int warp_cells(int B, int W) {
  W = clamp_live(B, W);
  return W <= kWarpMaxLive ? max(2, (W + 31) / 32) : 0;
}

using WarpKernel = void (*)(const uint8_t*, const uint8_t*, const int*,
                            const int*, const int*, const int*, int, int,
                            int, int, int, uint8_t*, int*, int*);

WarpKernel warp_kernel(int C) {
  switch (C) {
    case 2: return banded_dp_warp_kernel<2>;
    case 3: return banded_dp_warp_kernel<3>;
    case 4: return banded_dp_warp_kernel<4>;
    case 5: return banded_dp_warp_kernel<5>;
    case 6: return banded_dp_warp_kernel<6>;
    case 7: return banded_dp_warp_kernel<7>;
    default: return banded_dp_warp_kernel<8>;
  }
}

// The tile of a traceback launch: tile_w = min(kTileW, B, S) band
// columns (a walk of at most S moves spans at most S columns), a pitch
// with room for the 16-byte chunks that hold them, and K rows within
// kTileBytes (at most the launch's M).
void banded_traceback_tile(int M, int B, int S, int* tile_w, int* pitch,
                           int* K) {
  int w = B < S ? B : S;
  w = w > kTileW ? kTileW : (w < 1 ? 1 : w);
  const int pt = ((w + 15) / 16) * 16 + 16;
  int k = kTileBytes / pt;
  k = k > kTileMaxRows ? kTileMaxRows : k;
  k = k > M ? M : k;
  *tile_w = w;
  *pitch = pt;
  *K = k < 1 ? 1 : k;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Threads a block for P pairs of band B whose widest live row is W
// (max_live).  The warp kernel (W <= kWarpMaxLive): one warp, a pair.
// The block kernel: about four live cells a thread when the
// launch fills the card (P >= 4 blocks an SM), else one, in warps, 32 to
// 256.
int banded_dp_threads(int B, int W, int P) {
  if (warp_cells(B, W)) return 32;
  W = clamp_live(B, W);
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
  int blocks = 0;
  cudaError_t err;
  if (const int C = warp_cells(B, W)) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, warp_kernel(C), 32, 0);
    return err != cudaSuccess ? -(int)err : blocks;
  }
  const int T = banded_dp_threads(B, W, P);
  const size_t smem = banded_dp_smem_bytes(B, T);
  err = cudaFuncSetAttribute(banded_dp_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return -(int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks,
                                                      banded_dp_kernel, T,
                                                      smem);
  return err != cudaSuccess ? -(int)err : blocks;
}

// The warp kernel for W <= kWarpMaxLive, the block kernel for wider rows.
int banded_dp_launch(const void* q, const void* t_shift, const void* m_len,
                     const void* n_len, const void* lo, const void* submat,
                     int P, int M, int B, int W, int gap_open, int gap_extend,
                     void* dirs, void* end_scores, void* end_mat,
                     void* stream) {
  if (P <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto q_ = static_cast<const uint8_t*>(q);
  const auto t_ = static_cast<const uint8_t*>(t_shift);
  const auto m_ = static_cast<const int*>(m_len);
  const auto n_ = static_cast<const int*>(n_len);
  const auto lo_ = static_cast<const int*>(lo);
  const auto sub_ = static_cast<const int*>(submat);
  const auto dirs_ = static_cast<uint8_t*>(dirs);
  const auto ends_ = static_cast<int*>(end_scores);
  const auto mat_ = static_cast<int*>(end_mat);
  if (const int C = warp_cells(B, W)) {
    warp_kernel(C)<<<P, 32, 0, s>>>(q_, t_, m_, n_, lo_, sub_, M, B,
                                    clamp_live(B, W), gap_open, gap_extend,
                                    dirs_, ends_, mat_);
    return (int)cudaGetLastError();
  }
  const int T = banded_dp_threads(B, W, P);
  const size_t smem = banded_dp_smem_bytes(B, T);
  cudaError_t err = cudaFuncSetAttribute(
      banded_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  banded_dp_kernel<<<P, T, smem, s>>>(q_, t_, m_, n_, lo_, sub_, M, B,
                                      gap_open, gap_extend, dirs_, ends_,
                                      mat_);
  return (int)cudaGetLastError();
}

int banded_traceback_launch(const void* dirs, const void* m_len,
                            const void* n_len, const void* lo,
                            const void* end_mat, int P, int M, int B, int S,
                            void* moves, void* counts, void* stream) {
  if (P <= 0) return 0;
  int tile_w, pitch, K;
  banded_traceback_tile(M, B, S, &tile_w, &pitch, &K);
  const size_t smem = (size_t)kTbWarps * tb_warp_bytes(tile_w, pitch, K);
  // the largest slice any launch asks for, allowed once (a thread-safe
  // static, for the device current at the first launch: the port drives
  // one card): a CUDA API call on every launch costs host time that
  // the few short walks of a small launch cannot hide
  static const int allowed = (int)cudaFuncSetAttribute(
      banded_traceback_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTbMaxSmem);
  if (allowed != cudaSuccess) return allowed;
  banded_traceback_kernel<<<(P + kTbWarps - 1) / kTbWarps, 32 * kTbWarps,
                            smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(dirs), static_cast<const int*>(m_len),
      static_cast<const int*>(n_len), static_cast<const int*>(lo),
      static_cast<const int*>(end_mat), P, M, B, S, tile_w, pitch, K,
      static_cast<uint8_t*>(moves), static_cast<int*>(counts));
  return (int)cudaGetLastError();
}

}  // extern "C"
