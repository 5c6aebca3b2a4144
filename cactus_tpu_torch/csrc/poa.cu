// Partial-order alignment (sequence against a DAG of graph nodes) for
// NVIDIA Hopper (built for sm_90a, bound with ctypes).  Three kernels:
//
// poa_linear_kernel replaces the Pallas TPU kernel
//   cactus_tpu/ops/poa_pallas.py::_kernel (entry poa_align_scan_pallas).
//   Contract: cactus_tpu/ops/poa.py::poa_align_scan, linear gaps, one
//   problem, full width (L+1 columns), up to 4 predecessors a node:
//     H (N, L+1) int32 (no NEG floor), dirs (N, L+1) uint8
//     (move | slot << 2), ends (N,) = H[:, L].
// poa_affine_kernel replaces ::_affine_kernel (with _affine_nodes and
//   _node_gather_general; entry poa_align_scan_affine_pallas_batch).
//   Contract: cactus_tpu/ops/poa.py::poa_align_scan_affine over a batch:
//   convex dual-affine gaps, adaptive band B (cell (v, b) is column
//   j = off[v] + b), any DAG of up to 4 predecessors a node:
//     H (P, N, B) int32, dirs (P, N, B) int16 (13 bits, layout of
//     poa.py:375-377), ends (P, N) int32.
// poa_chain_kernel replaces ::_chain_kernel (with _chain_nodes) under the
//   same contract, for batches whose every node is a source (no
//   predecessor) or has the single predecessor v-1 with a band offset
//   step off[v] - off[v-1] of 0 or 1 (ops/poa_cuda.py::chain_certified).
//
// All three are bit-identical to the plain PyTorch versions in
// cactus_tpu_torch/ops/poa.py on every cell, pad nodes and columns past a
// problem's query included: candidates are compared in the contract's
// order with first-maximum ties (F candidates [opens of slots 0..3,
// extends of slots 0..3], diag over slots 0..3, moves diag, F1, F2, E1,
// E2), empty predecessor slots take part as NEG candidates, and a
// predecessor p >= v reads the NEG rows the contract's scan starts from.
//
// What bounds them on an H100: the DP is integer work, about 36 int32
// operations a cell on one predecessor (ops/poa_cuda.py
// POA_AFFINE_OPS_PER_CELL), against 6 bytes a cell written (H 4, dirs 2),
// so int32 issue and the dependence between graph nodes, not the
// 3.35 TB/s of device memory, set the floor.  Nodes of one problem run in
// order (a row needs its predecessors' final rows); problems run in
// parallel.
//
// Design.  A team of threads owns one problem; each thread owns a
// contiguous run of cells of the row.  A node is two passes over the
// thread's cells with a team scan between them:
//   pass 1: gather the predecessor cells (shifted by the offset step
//     d = off[v] - off[p]), the F1/F2 deletion states and their argmax
//     codes, the diagonal and h0 = max(diag, F1, F2); stage h0 and the
//     partial direction code in the output rows; keep the thread's max of
//     Z_k[b] = h0[b] + e_k * b.
//   team scan: exclusive max-scan of Z_1 and Z_2 (warp shuffles, plus
//     shared memory across warps).  The in-row convex insertion chain is
//     then E_k[b] = max(NEG, max_{b' < b} Z_k[b'] - o_k - e_k * b): the
//     ramp form of the contract's clamped Kogge-Stone scan (max is exact
//     in int32, so any scan order gives the same bits).
//   pass 2: E1, E2, H = max(h0, E1, E2), the NEG mask past the query,
//     the move decode and the E-extend bits (which need the masked E of
//     cell b-1: the team's first cell of each thread takes it from its
//     neighbour after the pass).
// poa_affine_kernel: the team is a block (B/threads cells a thread); the
//   predecessor rows are the H output itself and per-problem F1/F2
//   history planes (P, N, B) that the wrapper allocates.
// poa_chain_kernel: the team is one warp and a block holds several
//   problems (the dominant bin is B = 64 with thousands of problems).
//   There is no history: the previous row's H/F1/F2 and the current one
//   live in a double-buffered row pair in shared memory (24 bytes a cell,
//   up to B = 8192) or, wider, in a per-problem global ring the wrapper
//   allocates (poa_chain_ring_ints).
// poa_linear_kernel: one block for the one problem; linear gaps make the
//   insertion chain a plain prefix max of h0[k] + gap * k minus gap * j.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kNeg = -(1 << 28);   // poa.py NEG
constexpr int kMaxPreds = 4;       // poa.py MAX_PREDS
constexpr int kMaxThreads = 256;
constexpr int kChainSmemBand = 8192;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

struct Gaps {
  int o1, e1, o2, e2;
};

// the virtual start row at column j: j insertions at convex cost
__device__ __forceinline__ int row0_at(int j, const Gaps& g) {
  if (j == 0) return 0;
  if (j < 0) return kNeg;
  return -imin(g.o1 + j * g.e1, g.o2 + j * g.e2);
}

// inclusive max-scan of two ints across the warp
__device__ __forceinline__ void warp_incl_max2(int& a, int& b) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int oa = __shfl_up_sync(kFull, a, off);
    const int ob = __shfl_up_sync(kFull, b, off);
    if (lane >= off) {
      a = imax(a, oa);
      b = imax(b, ob);
    }
  }
}

// exclusive max-scan of two ints across the warp, seeded with `seed`
__device__ __forceinline__ void warp_excl_max2(int& a, int& b, int seed) {
  warp_incl_max2(a, b);
  int ea = __shfl_up_sync(kFull, a, 1);
  int eb = __shfl_up_sync(kFull, b, 1);
  if ((threadIdx.x & 31) == 0) ea = eb = INT_MIN;
  a = imax(seed, ea);
  b = imax(seed, eb);
}

// exclusive max-scan of two ints across the block (blockDim.x a multiple
// of 32), seeded with `seed`.  wbuf holds 64 ints; the caller puts a
// __syncthreads between this call and the next one.
__device__ __forceinline__ void block_excl_max2(int& a, int& b, int seed,
                                                int* wbuf) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_incl_max2(a, b);
  int ea = __shfl_up_sync(kFull, a, 1);
  int eb = __shfl_up_sync(kFull, b, 1);
  if (lane == 0) ea = eb = INT_MIN;
  if (lane == 31) {
    wbuf[warp] = a;
    wbuf[32 + warp] = b;
  }
  __syncthreads();
  int pa = seed, pb = seed;
  for (int w = 0; w < warp; ++w) {
    pa = imax(pa, wbuf[w]);
    pb = imax(pb, wbuf[32 + w]);
  }
  a = imax(pa, ea);
  b = imax(pb, eb);
}

// Pass 1 of one affine cell from its per-slot predecessor values (NEG in
// empty slots).  Returns h0, the masked F1/F2, and the direction code
// without its E bits; bits 0-2 hold the move when the cell is past the
// query (H = NEG there) and, for a cell inside it, the first of
// (diag, F1, F2) equal to h0 — the move whenever H == h0.
__device__ __forceinline__ void cell_pass1(const int (&Hp)[kMaxPreds],
                                           const int (&F1p)[kMaxPreds],
                                           const int (&F2p)[kMaxPreds],
                                           const int (&Hd)[kMaxPreds],
                                           int s, bool valid, const Gaps& g,
                                           int& h0, int& F1o, int& F2o,
                                           int& code) {
  const int pen1 = g.o1 + g.e1, pen2 = g.o2 + g.e2;
  int F1 = Hp[0] - pen1, a1 = 0;
  int F2 = Hp[0] - pen2, a2 = 0;
#pragma unroll
  for (int k = 1; k < kMaxPreds; ++k) {
    if (Hp[k] - pen1 > F1) { F1 = Hp[k] - pen1; a1 = k; }
    if (Hp[k] - pen2 > F2) { F2 = Hp[k] - pen2; a2 = k; }
  }
#pragma unroll
  for (int k = 0; k < kMaxPreds; ++k) {
    if (F1p[k] - g.e1 > F1) { F1 = F1p[k] - g.e1; a1 = kMaxPreds + k; }
    if (F2p[k] - g.e2 > F2) { F2 = F2p[k] - g.e2; a2 = kMaxPreds + k; }
  }
  int diag = Hd[0] + s, ds = 0;
#pragma unroll
  for (int k = 1; k < kMaxPreds; ++k) {
    if (Hd[k] + s > diag) { diag = Hd[k] + s; ds = k; }
  }
  h0 = imax(diag, imax(F1, F2));
  int move;
  if (valid) {
    move = diag == h0 ? 0 : (F1 == h0 ? 1 : 2);
    F1o = F1;
    F2o = F2;
  } else {
    move = diag == kNeg ? 0 : 1;
    F1o = F2o = kNeg;
  }
  code = move | (ds << 3) | ((a1 & 3) << 5) | ((a1 >> 2) << 7) |
         ((a2 & 3) << 8) | ((a2 >> 2) << 10);
}

// Pass 2 of one affine cell: r1/r2 are the exclusive prefix maxima of Z_k
// before cell b.  Returns H and the masked E1/E2, and completes the move.
__device__ __forceinline__ void cell_pass2(int h0, int& code, int r1, int r2,
                                           int b, bool valid, const Gaps& g,
                                           int& H, int& E1, int& E2) {
  E1 = imax(kNeg, r1 - g.o1 - g.e1 * b);
  E2 = imax(kNeg, r2 - g.o2 - g.e2 * b);
  if (valid) {
    H = imax(h0, imax(E1, E2));
    if (H != h0) code = (code & ~7) | (H == E1 ? 3 : 4);
  } else {
    H = E1 = E2 = kNeg;
  }
}

__device__ __forceinline__ int ext_bits(int E1, int E2, int pE1, int pE2,
                                        const Gaps& g) {
  return ((E1 == pE1 - g.e1) ? 2048 : 0) | ((E2 == pE2 - g.e2) ? 4096 : 0);
}

// ------------------------------------------------------------ kernel 6

__global__ void __launch_bounds__(kMaxThreads)
poa_affine_kernel(const uint8_t* __restrict__ bases,
                  const int* __restrict__ preds,
                  const int* __restrict__ off,
                  const uint8_t* __restrict__ q_ext,
                  const int* __restrict__ l_len,
                  const int* __restrict__ submat,
                  int N, int Lq, int B, Gaps g,
                  int* H, int16_t* dirs, int* __restrict__ ends,
                  int* F1h, int* F2h) {
  __shared__ int s_sub[36];
  __shared__ int wbuf[64];
  __shared__ int lastE[2 * kMaxThreads];
  const int p = blockIdx.x;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int C = B / T;
  const int b0 = t * C, b1 = b0 + C;
  const int L = l_len[p];
  const size_t plane = (size_t)p * N * B;
  int* Hp_ = H + plane;
  int* F1_ = F1h + plane;
  int* F2_ = F2h + plane;
  int16_t* Dp = dirs + plane;
  const uint8_t* qp = q_ext + (size_t)p * Lq;
  const int* pp = preds + (size_t)p * N * kMaxPreds;
  const int* op = off + (size_t)p * N;
  for (int k = t; k < 36; k += T) s_sub[k] = submat[k];
  __syncthreads();

  for (int v = 0; v < N; ++v) {
    const int off_v = op[v];
    const int* srow = s_sub + 6 * bases[(size_t)p * N + v];
    // a slot reads its predecessor's row only when that row is final
    // (p < v); an empty slot, or a row not computed yet (the contract's
    // scan reads its NEG init there), gives NEG candidates
    int pv[kMaxPreds], dv[kMaxPreds];
    bool has = false, row_ok[kMaxPreds];
#pragma unroll
    for (int k = 0; k < kMaxPreds; ++k) {
      pv[k] = pp[v * kMaxPreds + k];
      has |= pv[k] >= 0;
      row_ok[k] = pv[k] >= 0 && pv[k] < v;
      dv[k] = row_ok[k] ? off_v - op[pv[k]] : 0;
    }
    int* hrow = Hp_ + (size_t)v * B;
    int16_t* drow = Dp + (size_t)v * B;
    int agg1 = INT_MIN, agg2 = INT_MIN;
    for (int b = b0; b < b1; ++b) {
      const int j = off_v + b;
      const bool valid = j <= L;
      const int s = srow[qp[imin(imax(j, 0), L)]];
      int Hk[kMaxPreds], F1k[kMaxPreds], F2k[kMaxPreds], Hd[kMaxPreds];
#pragma unroll
      for (int k = 0; k < kMaxPreds; ++k) {
        Hk[k] = F1k[k] = F2k[k] = Hd[k] = kNeg;
        if (!row_ok[k]) continue;
        const int gi = dv[k] + b;
        const size_t base = (size_t)pv[k] * B;
        if (gi >= 0 && gi < B) {
          Hk[k] = Hp_[base + gi];
          F1k[k] = F1_[base + gi];
          F2k[k] = F2_[base + gi];
        }
        if (gi >= 1 && gi <= B) Hd[k] = Hp_[base + gi - 1];
      }
      if (!has) {   // a source reads the virtual start row in slot 0
        Hk[0] = row0_at(j, g);
        Hd[0] = row0_at(j - 1, g);
      }
      int h0, F1o, F2o, code;
      cell_pass1(Hk, F1k, F2k, Hd, s, valid, g, h0, F1o, F2o, code);
      hrow[b] = h0;             // staged until pass 2
      drow[b] = (int16_t)code;
      F1_[(size_t)v * B + b] = F1o;
      F2_[(size_t)v * B + b] = F2o;
      agg1 = imax(agg1, h0 + g.e1 * b);
      agg2 = imax(agg2, h0 + g.e2 * b);
    }
    int r1 = agg1, r2 = agg2;
    block_excl_max2(r1, r2, kNeg, wbuf);

    int pE1 = kNeg, pE2 = kNeg, fE1 = kNeg, fE2 = kNeg, fcode = 0;
    const int bL = L - off_v;
    for (int b = b0; b < b1; ++b) {
      const int h0 = hrow[b];
      int code = drow[b];
      const bool valid = off_v + b <= L;
      int Hc, E1, E2;
      cell_pass2(h0, code, r1, r2, b, valid, g, Hc, E1, E2);
      if (b == b0) {
        fE1 = E1;
        fE2 = E2;
        fcode = code;
      } else {
        drow[b] = (int16_t)(code | ext_bits(E1, E2, pE1, pE2, g));
      }
      hrow[b] = Hc;
      if (b == bL) ends[(size_t)p * N + v] = Hc;
      r1 = imax(r1, h0 + g.e1 * b);
      r2 = imax(r2, h0 + g.e2 * b);
      pE1 = E1;
      pE2 = E2;
    }
    lastE[t] = pE1;
    lastE[kMaxThreads + t] = pE2;
    __syncthreads();
    {
      const int q1 = t == 0 ? kNeg : lastE[t - 1];
      const int q2 = t == 0 ? kNeg : lastE[kMaxThreads + t - 1];
      drow[b0] = (int16_t)(fcode | ext_bits(fE1, fE2, q1, q2, g));
    }
    if (t == 0 && (bL < 0 || bL >= B)) ends[(size_t)p * N + v] = kNeg;
    __syncthreads();   // the row is final before the next node reads it
  }
}

// ------------------------------------------------------------ kernel 7

__global__ void __launch_bounds__(kMaxThreads)
poa_chain_kernel(const uint8_t* __restrict__ bases,
                 const int* __restrict__ preds,
                 const int* __restrict__ off,
                 const uint8_t* __restrict__ q_ext,
                 const int* __restrict__ l_len,
                 const int* __restrict__ submat,
                 int P, int N, int Lq, int B, Gaps g,
                 int* __restrict__ H, int16_t* dirs,
                 int* __restrict__ ends, int* ring) {
  extern __shared__ int4 smem_raw[];
  __shared__ int s_sub[36];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int p = blockIdx.x * (blockDim.x >> 5) + w;
  for (int k = threadIdx.x; k < 36; k += blockDim.x) s_sub[k] = submat[k];
  __syncthreads();
  if (p >= P) return;
  // two row triples (H, F1, F2): 6 * B ints per problem
  int* rows = ring != nullptr
                  ? ring + (size_t)p * 6 * B
                  : reinterpret_cast<int*>(smem_raw) + (size_t)w * 6 * B;
  int* prv = rows;
  int* cur = rows + 3 * B;
  const int C = B / 32;
  const int b0 = lane * C, b1 = b0 + C;
  const int L = l_len[p];
  const uint8_t* qp = q_ext + (size_t)p * Lq;
  const int* pp = preds + (size_t)p * N * kMaxPreds;
  const int* op = off + (size_t)p * N;
  int* Hrows = H + (size_t)p * N * B;
  int16_t* Drows = dirs + (size_t)p * N * B;
  int off_prev = 0;

  for (int v = 0; v < N; ++v) {
    const int off_v = op[v];
    const int* srow = s_sub + 6 * bases[(size_t)p * N + v];
    const bool src = pp[v * kMaxPreds] < 0;
    const int d = src ? 0 : off_v - off_prev;
    int* hrow = Hrows + (size_t)v * B;
    int16_t* drow = Drows + (size_t)v * B;
    int agg1 = INT_MIN, agg2 = INT_MIN;
    for (int b = b0; b < b1; ++b) {
      const int j = off_v + b;
      const bool valid = j <= L;
      const int s = srow[qp[imin(imax(j, 0), L)]];
      int Hk[kMaxPreds] = {kNeg, kNeg, kNeg, kNeg};
      int F1k[kMaxPreds] = {kNeg, kNeg, kNeg, kNeg};
      int F2k[kMaxPreds] = {kNeg, kNeg, kNeg, kNeg};
      int Hd[kMaxPreds] = {kNeg, kNeg, kNeg, kNeg};
      if (src) {
        Hk[0] = row0_at(j, g);
        Hd[0] = row0_at(j - 1, g);
      } else {
        const int gi = d + b;
        if (gi >= 0 && gi < B) {
          Hk[0] = prv[gi];
          F1k[0] = prv[B + gi];
          F2k[0] = prv[2 * B + gi];
        }
        if (gi >= 1 && gi <= B) Hd[0] = prv[gi - 1];
      }
      int h0, F1o, F2o, code;
      cell_pass1(Hk, F1k, F2k, Hd, s, valid, g, h0, F1o, F2o, code);
      cur[b] = h0;              // staged until pass 2
      cur[B + b] = F1o;
      cur[2 * B + b] = F2o;
      drow[b] = (int16_t)code;
      agg1 = imax(agg1, h0 + g.e1 * b);
      agg2 = imax(agg2, h0 + g.e2 * b);
    }
    int r1 = agg1, r2 = agg2;
    warp_excl_max2(r1, r2, kNeg);

    int pE1 = kNeg, pE2 = kNeg, fE1 = kNeg, fE2 = kNeg, fcode = 0;
    const int bL = L - off_v;
    for (int b = b0; b < b1; ++b) {
      const int h0 = cur[b];
      int code = drow[b];
      const bool valid = off_v + b <= L;
      int Hc, E1, E2;
      cell_pass2(h0, code, r1, r2, b, valid, g, Hc, E1, E2);
      if (b == b0) {
        fE1 = E1;
        fE2 = E2;
        fcode = code;
      } else {
        drow[b] = (int16_t)(code | ext_bits(E1, E2, pE1, pE2, g));
      }
      cur[b] = Hc;
      hrow[b] = Hc;
      if (b == bL) ends[(size_t)p * N + v] = Hc;
      r1 = imax(r1, h0 + g.e1 * b);
      r2 = imax(r2, h0 + g.e2 * b);
      pE1 = E1;
      pE2 = E2;
    }
    int q1 = __shfl_up_sync(kFull, pE1, 1);
    int q2 = __shfl_up_sync(kFull, pE2, 1);
    if (lane == 0) q1 = q2 = kNeg;
    drow[b0] = (int16_t)(fcode | ext_bits(fE1, fE2, q1, q2, g));
    if (lane == 0 && (bL < 0 || bL >= B)) ends[(size_t)p * N + v] = kNeg;
    __syncwarp();      // the row is final before the next node reads it
    int* tmp = prv;
    prv = cur;
    cur = tmp;
    off_prev = off_v;
  }
}

// ------------------------------------------------------------ kernel 5

__global__ void __launch_bounds__(kMaxThreads)
poa_linear_kernel(const uint8_t* __restrict__ bases,
                  const int* __restrict__ preds,
                  const uint8_t* __restrict__ q, int N, int L, int gap,
                  int match, int mismatch, int* H, uint8_t* dirs,
                  int* __restrict__ ends) {
  __shared__ int wbuf[64];
  const int W = L + 1;
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int C = (W + T - 1) / T;
  const int b0 = imin(t * C, W), b1 = imin(b0 + C, W);

  for (int v = 0; v < N; ++v) {
    const int base = bases[v];
    int pv[kMaxPreds];
    bool has = false;
#pragma unroll
    for (int k = 0; k < kMaxPreds; ++k) {
      pv[k] = preds[v * kMaxPreds + k];
      has |= pv[k] >= 0;
    }
    int* hrow = H + (size_t)v * W;
    uint8_t* drow = dirs + (size_t)v * W;
    int agg = INT_MIN;
    for (int j = b0; j < b1; ++j) {
      // slot k's row at columns j-1 and j; empty slots and rows not
      // computed yet read NEG, a source reads the virtual start row
      const int s = j > 0 ? (q[j - 1] == base ? match : mismatch) : 0;
      int bd = INT_MIN, sd = 0, bl = INT_MIN, sl = 0;
#pragma unroll
      for (int k = 0; k < kMaxPreds; ++k) {
        int cur = kNeg, left = kNeg;
        if (!has) {
          if (k == 0) {
            cur = -gap * j;
            left = -gap * (j - 1);
          }
        } else if (pv[k] >= 0 && pv[k] < v) {
          cur = H[(size_t)pv[k] * W + j];
          if (j > 0) left = H[(size_t)pv[k] * W + j - 1];
        }
        const int diag = j > 0 ? left + s : kNeg;
        const int dele = cur - gap;
        if (k == 0 || diag > bd) {   // first maximum wins
          sd = k;
          bd = diag;
        }
        if (k == 0 || dele > bl) {
          sl = k;
          bl = dele;
        }
      }
      const int h0 = imax(bd, bl);
      const int code = bd >= bl ? (sd << 2) : (1 | (sl << 2));
      hrow[j] = h0;             // staged until pass 2
      drow[j] = (uint8_t)code;
      agg = imax(agg, h0 + gap * j);
    }
    int run = agg, unused = INT_MIN;
    block_excl_max2(run, unused, INT_MIN, wbuf);
    for (int j = b0; j < b1; ++j) {
      const int h0 = hrow[j];
      run = imax(run, h0 + gap * j);
      const int y = run - gap * j;
      if (y != h0) drow[j] = (uint8_t)((drow[j] & ~3) | 2);
      hrow[j] = y;
      if (j == L) ends[v] = y;
    }
    __syncthreads();   // the row is final before the next node reads it
  }
}

int chain_warps(int B) {
  if (B > kChainSmemBand) return 4;
  const int w = (96 * 1024) / (24 * B);
  return w < 1 ? 1 : (w > 8 ? 8 : w);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int poa_affine_threads(int B) { return B < kMaxThreads ? B : kMaxThreads; }

// ints of global row scratch a problem of band B needs in poa_chain (0:
// the rows fit in shared memory)
int poa_chain_ring_ints(int B) { return B > kChainSmemBand ? 6 * B : 0; }

int poa_affine_launch(const void* bases, const void* preds, const void* off,
                      const void* q_ext, const void* l_len,
                      const void* submat, int P, int N, int Lq, int B,
                      int o1, int e1, int o2, int e2, void* H, void* dirs,
                      void* ends, void* F1h, void* F2h, void* stream) {
  if (P <= 0 || N <= 0) return 0;
  if (B < 32 || (B & (B - 1)) != 0) return (int)cudaErrorInvalidValue;
  const Gaps g{o1, e1, o2, e2};
  poa_affine_kernel<<<P, poa_affine_threads(B), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bases), static_cast<const int*>(preds),
      static_cast<const int*>(off), static_cast<const uint8_t*>(q_ext),
      static_cast<const int*>(l_len), static_cast<const int*>(submat), N,
      Lq, B, g, static_cast<int*>(H), static_cast<int16_t*>(dirs),
      static_cast<int*>(ends), static_cast<int*>(F1h),
      static_cast<int*>(F2h));
  return (int)cudaGetLastError();
}

int poa_chain_launch(const void* bases, const void* preds, const void* off,
                     const void* q_ext, const void* l_len, const void* submat,
                     int P, int N, int Lq, int B, int o1, int e1, int o2,
                     int e2, void* H, void* dirs, void* ends, void* ring,
                     void* stream) {
  if (P <= 0 || N <= 0) return 0;
  if (B < 32 || (B & (B - 1)) != 0) return (int)cudaErrorInvalidValue;
  if ((poa_chain_ring_ints(B) > 0) != (ring != nullptr))
    return (int)cudaErrorInvalidValue;
  const int W = chain_warps(B);
  const size_t smem =
      ring != nullptr ? 0 : (size_t)W * 6 * B * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      poa_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Gaps g{o1, e1, o2, e2};
  poa_chain_kernel<<<(P + W - 1) / W, 32 * W, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bases), static_cast<const int*>(preds),
      static_cast<const int*>(off), static_cast<const uint8_t*>(q_ext),
      static_cast<const int*>(l_len), static_cast<const int*>(submat), P, N,
      Lq, B, g, static_cast<int*>(H), static_cast<int16_t*>(dirs),
      static_cast<int*>(ends), static_cast<int*>(ring));
  return (int)cudaGetLastError();
}

int poa_linear_launch(const void* bases, const void* preds, const void* q,
                      int N, int L, int gap, int match, int mismatch,
                      void* H, void* dirs, void* ends, void* stream) {
  if (N <= 0) return 0;
  const int W = L + 1;
  const int T = W >= kMaxThreads ? kMaxThreads : ((W + 31) / 32) * 32;
  poa_linear_kernel<<<1, T, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bases), static_cast<const int*>(preds),
      static_cast<const uint8_t*>(q), N, L, gap, match, mismatch,
      static_cast<int*>(H), static_cast<uint8_t*>(dirs),
      static_cast<int*>(ends));
  return (int)cudaGetLastError();
}

}  // extern "C"
