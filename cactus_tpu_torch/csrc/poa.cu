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
// poa_chain_kernel replaces ::_chain_kernel (with _chain_nodes) under
//   the same contract, for batches whose every node is a source (no
//   predecessor) or has the single predecessor v-1 with a band offset
//   step off[v] - off[v-1] of 0 or 1 (ops/poa_cuda.py::chain_certified).
//
// poa_linear computes only the live cells of its one problem: real nodes
// v < n and columns j <= L, the live query length (ops/poa_cuda.py::
// linear_live_mask; with n = N and L the whole query, every cell).  There
// H and dirs are bit-identical to the plain PyTorch version
// (cactus_tpu_torch/ops/poa.py), and so is ends (column Lq) on the real
// nodes when L is the whole query; every other cell is left unwritten.
// poa_chain and poa_affine
// compute only each problem's live cells: its real nodes v < n (the pad
// nodes of a shape bin come after them) and the band cells b with
// off[v] + b <= L.  There H and dirs are bit-identical to the plain
// version, and so is ends on every real node; every other cell is left
// unwritten (ops/poa_cuda.py::live_mask).  That is sound because a live
// cell reads only live cells: its predecessor cell at the same column j
// and at j - 1 (each live in the predecessor's row when inside its band,
// and the predecessor is a real node), and the insertion chain to its
// left; and the consumers (poa_msa_batch, poa_align_affine and their
// traceback) read dirs of real nodes at columns j <= L and ends of real
// nodes only.  A row's live width is at most min(B, L + 1) for the band
// offsets the consumers make; the wrapper passes max_live, the widest of
// the launch, and a predecessor cell at b >= max_live is never live.
// Candidates are compared in the contract's order with first-maximum
// ties (F candidates [opens of slots 0..3, extends of slots 0..3], diag
// over slots 0..3, moves diag, F1, F2, E1, E2), empty predecessor slots
// take part as NEG candidates, and a predecessor p >= v reads the NEG
// rows the contract's scan starts from.
//
// What bounds them on an H100: the DP is integer work, about 36 int32
// operations a cell on one predecessor (ops/poa_cuda.py
// POA_AFFINE_OPS_PER_CELL), against 6 bytes a cell written (H 4, dirs 2),
// so int32 issue and the dependence between graph nodes, not the
// 3.35 TB/s of device memory, set the floor.  Nodes of one problem run in
// order (a row needs its predecessors' final rows); problems run in
// parallel, so a launch of few problems is bound by one node's latency
// times its longest problem's nodes.
//
// Design of poa_chain and poa_affine.  A team of TL lanes (8, 16 or 32)
// in NW warps owns one problem, each lane C consecutive cells of the
// team's cover TL * NW * C, the first of 32, 64, ... 16384 at or above the
// launch's widest live row (Team<C, TL, NW>; the wrapper picks the shape,
// ops/poa_cuda.py::team_shape: mostly 2 cells a lane, where a node's
// latency is shortest).  Narrow rows put 32 / TL problems in a warp
// (segmented shuffles), which loops to its longest problem; wide rows
// give one problem up to 16 warps.  C is a compile-time constant of the
// instance, so a lane's cells live in registers.  Before the node
// loop, each tile of nodes is staged in shared memory: the node word
// (band offset, base, source flag; for poa_affine the predecessor slots
// and each slot's band offset step) and the query codes from the tile's
// first band offset on (a code outside that window, after an offset jump,
// comes from device memory).  A node is two passes over the lane's cells
// with a team scan between them:
//   pass 1: the predecessor cells (shifted by the offset step
//     d = off[v] - off[p]), the F1/F2 deletion states and their argmax
//     codes, the diagonal and h0 = max(diag, F1, F2), kept in registers
//     with the partial direction code; the lane's max of
//     Z_k[b] = h0[b] + e_k * b.
//   team scan: exclusive max-scan of Z_1 and Z_2 by warp shuffles; with
//     several warps, one barrier: each warp publishes its aggregates (and
//     the values below) in double-buffered shared slots and adds up the
//     ones before it.  The in-row convex insertion chain is then
//     E_k[b] = max(NEG, max_{b' < b} Z_k[b'] - o_k - e_k * b): the ramp
//     form of the contract's clamped Kogge-Stone scan (max is exact in
//     int32, so any scan order gives the same bits).
//   pass 2: E1, E2, H = max(h0, E1, E2), the move decode and the
//     E-extend bits (which need the E of cell b - 1: a lane's first cell takes it from its left lane by a
//     shuffle, a warp's first cell rebuilds it from the previous warp's
//     published aggregate without its last cell and that cell's h0).
//   stores: H and dirs of the live cells, as 16-byte vectors where a
//     lane's cells are all live; ends at column L.
// poa_chain_kernel: the predecessor is v - 1 with d = 0 or 1, so its row
//   stays in registers: a lane reads its own cells and one neighbour cell
//   each side by shuffles; at a warp's edge the neighbour warp's cell of
//   the previous row is rebuilt after the barrier from what that warp
//   published (its first cell's h0/F1/F2, its last cell's h0 and the
//   carries).  One barrier a node with several warps, none with one.
// poa_affine_kernel: predecessors are any earlier rows, so each team
//   keeps a history of its rows (H, F1, F2 of the cover cells): in shared
//   memory when a block's rows fit and the launch is resident at once
//   (ops/poa_cuda.py::affine_rows_in_smem), else in global scratch.  The
//   next node may read the row just written: a warp sync after the
//   stores, or a second barrier with several warps.
// Covers 8192 and 16384 give a lane 16 or 32 cells, more values than its
//   registers hold; the compiler keeps the rest in local memory.
// poa_linear_kernel: the same teams for the one problem (one block, NW
//   warps, cover by the live row L + 1); linear gaps make the insertion
//   chain a plain prefix max of h0[k] + gap * k minus gap * j, so a node is
//   pass 1, one max-scan and pass 2 in registers, with one barrier when
//   the team has several warps.  The previous node's row stays in
//   registers (most nodes' predecessor); other predecessor rows are read
//   from device memory.
// Rows wider than the widest cover (16384 cells; the poa engine's default
//   window of 10,000 bases keeps its rows under 10,002 cells, but the
//   window is a config knob) take the wide route, one thread-block
//   cluster a problem on its live row (csrc/poa_cluster.cu, under the
//   same contracts).  The wrappers route by width
//   (ops/poa_cuda.py::poa_route).  What the two sources share (the
//   candidates, the two passes of a cell, the stores) is csrc/poa.cuh.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "poa.cuh"

namespace {

// ------------------------------------------------------------ kernel 7

// Team shapes.  A team of TL lanes (8, 16 or 32) in each of NW warps owns
// one problem, each lane C consecutive band cells: cells b = lane * C ..
// lane * C + C - 1 of the team's cover TL * NW * C, the first power of two
// at or above the launch's widest live row (max_live).  With NW == 1 a
// block is four warps (poa_affine with its rows in shared memory: one)
// and a warp carries 32 / TL problems; with NW > 1 a block is the one
// problem's NW warps.
template <int C, int TL, int NW, int kBlockWarps = 4, int kTile1 = 64>
struct Team {
  static constexpr int kThreads = NW > 1 ? 32 * NW : 32 * kBlockWarps;
  static constexpr int kLanes = TL * NW;
  static constexpr int kTeams = kThreads / kLanes;
  static constexpr int kCover = kLanes * C;
  // nodes staged at a time, and the query codes staged with them: the
  // tile's first band offset onward, kCover + kNodeTile codes (a chain's
  // offsets step by at most one a node; a code outside the window is
  // read from device memory)
  static constexpr int kNodeTile = NW > 1 ? 32 * NW : kTile1;
  static constexpr int kQWin = kCover + kNodeTile;
};

// inclusive max-scan of two ints across each segment of TL lanes
template <int TL>
__device__ __forceinline__ void seg_incl_max2(int& a, int& b, int lane_t) {
#pragma unroll
  for (int off = 1; off < TL; off <<= 1) {
    const int oa = __shfl_up_sync(kFull, a, off, TL);
    const int ob = __shfl_up_sync(kFull, b, off, TL);
    if (lane_t >= off) {
      a = imax(a, oa);
      b = imax(b, ob);
    }
  }
}

// The rest of a node row after pass 1, shared by both kernels: the
// team's exclusive max-scan of Z_k = h0 + e_k * b (segment shuffles; with
// several warps each warp publishes its aggregates, the two without its
// last cell, its first cell's h0/F1/F2 and its last cell's h0 in pub, one
// barrier, and each warp rebuilds its carry and the edge cells of its
// neighbour warps from them: xl_H / xr_* for the next node's neighbour
// reads, the left E for this node's extend bits), pass 2 and the extend
// bits (the E of cell b0 - 1 by a shuffle inside a warp).
template <int C, int TL, int NW>
__device__ __forceinline__ void team_row(
    const int (&h0)[C], const int (&nF1)[C], const int (&nF2)[C],
    int (&code)[C], int (&Hc)[C], int agg1, int agg2, int aggx1, int aggx2,
    int off_v, int L, int b0, int lane_t, int warp_t, int (*pub)[8],
    const Gaps& g, int& xl_H, int& xr_H, int& xr_F1, int& xr_F2) {
  // exclusive prefix maxima of Z_k before the lane, inside its warp
  int r1 = agg1, r2 = agg2;
  seg_incl_max2<TL>(r1, r2, lane_t);
  int x1 = __shfl_up_sync(kFull, r1, 1, TL);
  int x2 = __shfl_up_sync(kFull, r2, 1, TL);
  if (lane_t == 0) x1 = x2 = INT_MIN;
  int carry1 = kNeg, carry2 = kNeg;
  int lE1 = kNeg, lE2 = kNeg;     // E of cell b0 - 1 across a warp edge
  if constexpr (NW > 1) {
    if (lane_t == 31) {
      pub[warp_t][0] = r1;
      pub[warp_t][1] = r2;
      pub[warp_t][2] = imax(x1, aggx1);
      pub[warp_t][3] = imax(x2, aggx2);
      pub[warp_t][7] = h0[C - 1];
    }
    if (lane_t == 0) {
      pub[warp_t][4] = h0[0];
      pub[warp_t][5] = nF1[0];
      pub[warp_t][6] = nF2[0];
    }
    __syncthreads();
    // the carry before warp w - 1, then before w and w + 1
    int c1 = kNeg, c2 = kNeg;
    for (int u = 0; u + 1 < warp_t; ++u) {
      c1 = imax(c1, pub[u][0]);
      c2 = imax(c2, pub[u][1]);
    }
    if (warp_t > 0) {
      // the previous warp's last cell: its E now (the extend bits of cell
      // b0), its H for the next node
      const int bl = warp_t * 32 * C - 1;
      edge_cell(pub[warp_t - 1][7], imax(c1, pub[warp_t - 1][2]),
                imax(c2, pub[warp_t - 1][3]), bl, g, xl_H, lE1, lE2);
      carry1 = imax(c1, pub[warp_t - 1][0]);
      carry2 = imax(c2, pub[warp_t - 1][1]);
    }
    if (warp_t < NW - 1) {
      // the next warp's first cell, for the next node
      const int bf = (warp_t + 1) * 32 * C;
      int E1f, E2f;
      edge_cell(pub[warp_t + 1][4], imax(carry1, pub[warp_t][0]),
                imax(carry2, pub[warp_t][1]), bf, g, xr_H, E1f, E2f);
      xr_F1 = pub[warp_t + 1][5];
      xr_F2 = pub[warp_t + 1][6];
    }
  }
  // pass 2: E1, E2, H and the move; the extend bits from cell b - 1
  r1 = imax(carry1, x1);
  r2 = imax(carry2, x2);
  int pE1 = kNeg, pE2 = kNeg, fE1 = kNeg, fE2 = kNeg;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int b = b0 + c;
    int E1, E2;
    cell_pass2_live(h0[c], code[c], r1, r2, b, g, Hc[c], E1, E2);
    if (c == 0) {
      fE1 = E1;
      fE2 = E2;
    } else {
      code[c] |= ext_bits(E1, E2, pE1, pE2, g);
    }
    r1 = imax(r1, h0[c] + g.e1 * b);
    r2 = imax(r2, h0[c] + g.e2 * b);
    pE1 = E1;
    pE2 = E2;
  }
  int q1 = __shfl_up_sync(kFull, pE1, 1, TL);
  int q2 = __shfl_up_sync(kFull, pE2, 1, TL);
  if (lane_t == 0) {
    q1 = lE1;
    q2 = lE2;
  }
  code[0] |= ext_bits(fE1, fE2, q1, q2, g);
}

// A node's substitution scores at the lane's cells: the query code of
// each column from the staged window (from device memory outside it)
// and the node base's row of the 6x6 matrix.  No operand depends on the
// previous node, so the kernels load the next node's scores while they
// finish the current one.
template <int C, int kQWin>
__device__ __forceinline__ void node_scores(int wd, int b0, int L, int qlo,
                                            const uint8_t* sq,
                                            const uint8_t* qp,
                                            const int* s_sub, int (&s)[C]) {
  const int off_v = wd >> 4;
  const int* srow = s_sub + 6 * ((wd >> 1) & 7);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int jj = imin(imax(off_v + b0 + c, 0), L);
    const unsigned k = (unsigned)(jj - qlo);
    s[c] = srow[k < (unsigned)kQWin ? sq[k] : qp[jj]];
  }
}

// poa_chain_kernel: one team a problem, its previous row in registers.
// Per node: the node's word and query codes from shared memory, the
// neighbour lanes' previous-row cells by shuffles (at a warp's edges,
// recomputed from what the neighbour warp published), pass 1, the team's
// exclusive max-scan (one barrier with several warps), pass 2, the E of
// cell b0 - 1 for the extend bits by a shuffle, and the live cells'
// stores.
template <int C, int TL, int NW>
__global__ void __launch_bounds__(Team<C, TL, NW>::kThreads)
poa_chain_kernel(const uint8_t* __restrict__ bases,
                 const int* __restrict__ preds, const int* __restrict__ off,
                 const uint8_t* __restrict__ q_ext,
                 const int* __restrict__ l_len,
                 const int* __restrict__ n_nodes,
                 const int* __restrict__ submat, int P, int N, int Lq, int B,
                 Gaps g, int* __restrict__ H, int16_t* __restrict__ dirs,
                 int* __restrict__ ends) {
  using T = Team<C, TL, NW>;
  __shared__ int s_sub[36];
  __shared__ int s_node[T::kTeams][T::kNodeTile];
  __shared__ uint8_t s_q[T::kTeams][T::kQWin];
  // per warp and node parity: the warp's two aggregates, the two without
  // its last cell, its first cell's h0/F1/F2 and its last cell's h0
  __shared__ int s_pub[NW > 1 ? 2 : 1][NW][8];
  const int tid = threadIdx.x;
  const int team = tid / T::kLanes;
  const int tl = tid % T::kLanes;    // lane in the team
  const int lane_t = tid % TL;       // lane in its shuffle segment
  const int warp_t = tl / 32;        // warp in the team (NW > 1)
  for (int k = tid; k < 36; k += T::kThreads) s_sub[k] = submat[k];
  __syncthreads();
  const int slot = blockIdx.x * T::kTeams + team;
  const bool active = slot < P;
  const int p = active ? slot : 0;
  const int L = active ? l_len[p] : 0;
  const int n = active ? n_nodes[p] : 0;
  if (NW > 1 && !active) return;     // the block is this one team
  // the loop runs to the warp's longest problem (shuffles need every lane)
  const int nv = NW > 1 ? n : __reduce_max_sync(kFull, n);
  const uint8_t* qp = q_ext + (size_t)p * Lq;
  const size_t pN = (size_t)p * N;
  const int b0 = tl * C;
  int pH[C], pF1[C], pF2[C];
#pragma unroll
  for (int c = 0; c < C; ++c) pH[c] = pF1[c] = pF2[c] = kNeg;
  // the neighbour warps' edge cells of the previous row (NW > 1)
  int xl_H = kNeg, xr_H = kNeg, xr_F1 = kNeg, xr_F2 = kNeg;
  int off_prev = 0;

  for (int v0 = 0; v0 < nv; v0 += T::kNodeTile) {
    if (NW == 1) __syncwarp();
    // stage the tile's node words (band offset, base, source flag) and
    // the query codes from its first node's offset on
    for (int i = tl; i < T::kNodeTile; i += T::kLanes) {
      const int v = v0 + i;
      int w = 0;
      if (v < n) {
        const int src = preds[(pN + v) * kMaxPreds] < 0;
        w = off[pN + v] * 16 + (bases[pN + v] << 1) + src;
      }
      s_node[team][i] = w;
    }
    const int qlo = v0 < n ? imax(0, off[pN + v0]) : 0;
    const int qhi = imin(L, Lq - 1);
    for (int i = tl; i < T::kQWin; i += T::kLanes) {
      const int j = qlo + i;
      s_q[team][i] = active && j <= qhi ? qp[j] : 5;
    }
    if (NW > 1) __syncthreads();
    else __syncwarp();
    const int vend = imin(T::kNodeTile, nv - v0);
    int wd = s_node[team][0];
    int sc[C];
    node_scores<C, T::kQWin>(wd, b0, L, qlo, s_q[team], qp, s_sub, sc);

    for (int i = 0; i < vend; ++i) {
      const int v = v0 + i;
      const int off_v = wd >> 4;
      const bool src = wd & 1;
      const int d = src ? 0 : off_v - off_prev;   // 0 or 1
      // the previous row's neighbour cells: the left lane's last H, the
      // right lane's first H/F1/F2; NEG past the team's cover
      int hl = __shfl_up_sync(kFull, pH[C - 1], 1, TL);
      int hr = __shfl_down_sync(kFull, pH[0], 1, TL);
      int f1r = __shfl_down_sync(kFull, pF1[0], 1, TL);
      int f2r = __shfl_down_sync(kFull, pF2[0], 1, TL);
      if (lane_t == 0) hl = xl_H;
      if (lane_t == TL - 1) {
        hr = xr_H;
        f1r = xr_F1;
        f2r = xr_F2;
      }

      int h0[C], code[C], nF1[C], nF2[C];
      int agg1 = INT_MIN, agg2 = INT_MIN, aggx1 = INT_MIN, aggx2 = INT_MIN;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int b = b0 + c;
        const int j = off_v + b;
        int Hk, F1k, F2k, Hd;
        if (src) {
          Hk = row0_at(j, g);
          Hd = row0_at(j - 1, g);
          F1k = F2k = kNeg;
        } else {
          const int left = c > 0 ? pH[c - 1] : hl;
          const int rH = c < C - 1 ? pH[c + 1] : hr;
          const int rF1 = c < C - 1 ? pF1[c + 1] : f1r;
          const int rF2 = c < C - 1 ? pF2[c + 1] : f2r;
          Hk = d ? rH : pH[c];
          F1k = d ? rF1 : pF1[c];
          F2k = d ? rF2 : pF2[c];
          Hd = d ? pH[c] : left;
        }
        // slot 0 and the empty slots 1-3
        Cands cd;
        cands_empty(cd, 1, sc[c], g);
        cands_slot(cd, 0, Hk, F1k, F2k, Hd, sc[c], g);
        cands_cell(cd, h0[c], nF1[c], nF2[c], code[c]);
        if (c == C - 1) {
          aggx1 = agg1;
          aggx2 = agg2;
        }
        agg1 = imax(agg1, h0[c] + g.e1 * b);
        agg2 = imax(agg2, h0[c] + g.e2 * b);
      }
      if (i + 1 < vend) {
        wd = s_node[team][i + 1];
        node_scores<C, T::kQWin>(wd, b0, L, qlo, s_q[team], qp, s_sub, sc);
      }
      int Hc[C];
      team_row<C, TL, NW>(h0, nF1, nF2, code, Hc, agg1, agg2, aggx1, aggx2,
                          off_v, L, b0, lane_t, warp_t,
                          s_pub[NW > 1 ? (v & 1) : 0], g, xl_H, xr_H,
                          xr_F1, xr_F2);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        pH[c] = Hc[c];
        pF1[c] = nF1[c];
        pF2[c] = nF2[c];
      }
      off_prev = off_v;
      if (v < n) {
        const size_t row = (pN + v) * B;
        const int bL = L - off_v;
        store_cells<C>(H + row, dirs + row, Hc, code, b0, bL + 1);
        if (bL >= 0 && bL < B) {
#pragma unroll
          for (int c = 0; c < C; ++c)
            if (b0 + c == bL) ends[pN + v] = Hc[c];
        } else if (tl == 0) {
          ends[pN + v] = kNeg;
        }
      }
    }
  }
}

// ------------------------------------------------------------ kernel 6

// A lane's cells of one history row (H, F1, F2 planes of `cover` cells a
// node), live cells only, as vector stores when they are all live.
template <int C>
__device__ __forceinline__ void store_hist(int* rH, int* rF1, int* rF2,
                                           const int (&Hc)[C],
                                           const int (&F1)[C],
                                           const int (&F2)[C], int b0,
                                           int wlive) {
  if (b0 + C <= wlive) {
    store_ints<C>(rH + b0, Hc);
    store_ints<C>(rF1 + b0, F1);
    store_ints<C>(rF2 + b0, F2);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (b0 + c < wlive) {
        rH[b0 + c] = Hc[c];
        rF1[b0 + c] = F1[c];
        rF2[b0 + c] = F2[c];
      }
    }
  }
}

// poa_affine_kernel: one team a problem over any DAG.  The rows later
// nodes read (H, F1, F2 of each real node's first `stride` cells, live
// cells written) live in the team's history: shared memory when the
// launch's rows fit (kSmem: one-warp blocks, or the problem's NW warps),
// else the wrapper's global scratch (P, 3, rows, stride).  Per node: the node's
// word, its predecessor slots (-1 where the contract reads NEG rows: an
// empty slot or a predecessor not computed yet, p >= v) and each slot's
// band offset step, staged by tiles with the query codes; pass 1 from
// the predecessors' history rows; the team's scan and pass 2 (team_row);
// the live cells' stores; then the team's sync (a warp sync, or a second
// barrier with several warps) before the next node reads the row.
template <int C, int TL, int NW, bool kSmem>
__global__ void __launch_bounds__(Team<C, TL, NW, kSmem ? 1 : 4, 32>::kThreads)
poa_affine_kernel(const uint8_t* __restrict__ bases,
                  const int* __restrict__ preds, const int* __restrict__ off,
                  const uint8_t* __restrict__ q_ext,
                  const int* __restrict__ l_len,
                  const int* __restrict__ n_nodes,
                  const int* __restrict__ submat, int P, int N, int Lq, int B,
                  int rows, int stride, Gaps g, int* __restrict__ H,
                  int16_t* __restrict__ dirs, int* __restrict__ ends,
                  int* __restrict__ hist) {
  using T = Team<C, TL, NW, kSmem ? 1 : 4, 32>;
  extern __shared__ int4 s_dyn[];
  __shared__ int s_sub[36];
  __shared__ int s_node[T::kTeams][T::kNodeTile];
  __shared__ int4 s_pr[T::kTeams][T::kNodeTile];
  __shared__ int4 s_dv[T::kTeams][T::kNodeTile];
  __shared__ uint8_t s_q[T::kTeams][T::kQWin];
  __shared__ int s_pub[NW > 1 ? 2 : 1][NW][8];
  const int tid = threadIdx.x;
  const int team = tid / T::kLanes;
  const int tl = tid % T::kLanes;
  const int lane_t = tid % TL;
  const int warp_t = tl / 32;
  for (int k = tid; k < 36; k += T::kThreads) s_sub[k] = submat[k];
  __syncthreads();
  const int p = blockIdx.x * T::kTeams + team;
  const bool active = p < P;
  const int L = active ? l_len[p] : 0;
  const int n = active ? n_nodes[p] : 0;
  if (NW > 1 && !active) return;
  const int nv = NW > 1 ? n : __reduce_max_sync(kFull, n);
  const uint8_t* qp = q_ext + (size_t)(active ? p : 0) * Lq;
  const size_t pN = (size_t)(active ? p : 0) * N;
  const size_t plane = (size_t)rows * stride;
  int* hH = kSmem ? reinterpret_cast<int*>(s_dyn) + team * 3 * plane
                  : hist + (size_t)(active ? p : 0) * 3 * plane;
  int* hF1 = hH + plane;
  int* hF2 = hH + 2 * plane;
  const int b0 = tl * C;
  int unused0 = kNeg, unused1 = kNeg, unused2 = kNeg, unused3 = kNeg;

  for (int v0 = 0; v0 < nv; v0 += T::kNodeTile) {
    if (NW == 1) __syncwarp();
    for (int i = tl; i < T::kNodeTile; i += T::kLanes) {
      const int v = v0 + i;
      int w = 0;
      int4 pr = make_int4(-1, -1, -1, -1), dd = make_int4(0, 0, 0, 0);
      if (v < n) {
        const int ov = off[pN + v];
        const int4 pv =
            *reinterpret_cast<const int4*>(preds + (pN + v) * kMaxPreds);
        const bool has = pv.x >= 0 || pv.y >= 0 || pv.z >= 0 || pv.w >= 0;
        // a slot reads its predecessor's row only when that row is final
        // (0 <= p < v); otherwise the contract's NEG candidates
        if (pv.x >= 0 && pv.x < v) { pr.x = pv.x; dd.x = ov - off[pN + pv.x]; }
        if (pv.y >= 0 && pv.y < v) { pr.y = pv.y; dd.y = ov - off[pN + pv.y]; }
        if (pv.z >= 0 && pv.z < v) { pr.z = pv.z; dd.z = ov - off[pN + pv.z]; }
        if (pv.w >= 0 && pv.w < v) { pr.w = pv.w; dd.w = ov - off[pN + pv.w]; }
        w = ov * 16 + (bases[pN + v] << 1) + (has ? 0 : 1);
      }
      s_node[team][i] = w;
      s_pr[team][i] = pr;
      s_dv[team][i] = dd;
    }
    const int qlo = v0 < n ? imax(0, off[pN + v0]) : 0;
    const int qhi = imin(L, Lq - 1);
    for (int i = tl; i < T::kQWin; i += T::kLanes) {
      const int j = qlo + i;
      s_q[team][i] = active && j <= qhi ? qp[j] : 5;
    }
    if (NW > 1) __syncthreads();
    else __syncwarp();
    const int vend = imin(T::kNodeTile, nv - v0);
    int wd = s_node[team][0];
    int sc[C];
    node_scores<C, T::kQWin>(wd, b0, L, qlo, s_q[team], qp, s_sub, sc);

    for (int i = 0; i < vend; ++i) {
      const int v = v0 + i;
      const int off_v = wd >> 4;
      const bool src = wd & 1;
      const int4 pr4 = s_pr[team][i];
      const int4 dv4 = s_dv[team][i];
      const int prk[kMaxPreds] = {pr4.x, pr4.y, pr4.z, pr4.w};
      const int dvk[kMaxPreds] = {dv4.x, dv4.y, dv4.z, dv4.w};
      // the lowest slot that reads NEG rows (a source's slot 0 reads the
      // virtual start row)
      int kmin = kMaxPreds;
#pragma unroll
      for (int k = kMaxPreds - 1; k >= 0; --k)
        if (prk[k] < 0 && !(src && k == 0)) kmin = k;
      Cands cd[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (kmin < kMaxPreds) cands_empty(cd[c], kmin, sc[c], g);
        else cands_none(cd[c]);
        if (src) {
          const int j = off_v + b0 + c;
          cands_slot(cd[c], 0, row0_at(j, g), kNeg, kNeg, row0_at(j - 1, g),
                     sc[c], g);
        }
      }
      // slot by slot: the lane's window of the predecessor's history row
      // (C + 1 H cells, C F1 and F2 cells), all loads in flight at once
#pragma unroll
      for (int k = 0; k < kMaxPreds; ++k) {
        if (prk[k] < 0) continue;
        const size_t at = (size_t)prk[k] * stride;
        const int gi0 = dvk[k] + b0;
        int hw[C + 1], f1w[C], f2w[C];
#pragma unroll
        for (int t = 0; t <= C; ++t) {
          const int gi = gi0 - 1 + t;
          hw[t] = (unsigned)gi < (unsigned)stride ? hH[at + gi] : kNeg;
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int gi = gi0 + c;
          const bool ok = (unsigned)gi < (unsigned)stride;
          f1w[c] = ok ? hF1[at + gi] : kNeg;
          f2w[c] = ok ? hF2[at + gi] : kNeg;
        }
#pragma unroll
        for (int c = 0; c < C; ++c)
          cands_slot(cd[c], k, hw[c + 1], f1w[c], f2w[c], hw[c], sc[c], g);
      }
      int h0[C], code[C], nF1[C], nF2[C];
      int agg1 = INT_MIN, agg2 = INT_MIN, aggx1 = INT_MIN, aggx2 = INT_MIN;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int b = b0 + c;
        cands_cell(cd[c], h0[c], nF1[c], nF2[c], code[c]);
        if (c == C - 1) {
          aggx1 = agg1;
          aggx2 = agg2;
        }
        agg1 = imax(agg1, h0[c] + g.e1 * b);
        agg2 = imax(agg2, h0[c] + g.e2 * b);
      }
      if (i + 1 < vend) {
        wd = s_node[team][i + 1];
        node_scores<C, T::kQWin>(wd, b0, L, qlo, s_q[team], qp, s_sub, sc);
      }
      int Hc[C];
      team_row<C, TL, NW>(h0, nF1, nF2, code, Hc, agg1, agg2, aggx1, aggx2,
                          off_v, L, b0, lane_t, warp_t,
                          s_pub[NW > 1 ? (v & 1) : 0], g, unused0, unused1,
                          unused2, unused3);
      if (v < n) {
        const size_t row = (pN + v) * B;
        const int bL = L - off_v;
        store_cells<C>(H + row, dirs + row, Hc, code, b0, bL + 1);
        store_hist<C>(hH + (size_t)v * stride, hF1 + (size_t)v * stride,
                      hF2 + (size_t)v * stride, Hc, nF1, nF2, b0, bL + 1);
        if (bL >= 0 && bL < B) {
#pragma unroll
          for (int c = 0; c < C; ++c)
            if (b0 + c == bL) ends[pN + v] = Hc[c];
        } else if (tl == 0) {
          ends[pN + v] = kNeg;
        }
      }
      // the row is in the history before a later node reads it
      if (NW > 1) __syncthreads();
      else __syncwarp();
    }
  }
}

// ------------------------------------------------------------ kernel 5

// poa_linear_kernel: the one problem's team, NW warps of C cells a lane
// (lane t owns columns j = t C .. t C + C - 1 of the cover 32 NW C, the
// first power of two at or above the live row l_len + 1; one block).
// Only the live cells are computed: real nodes v < n, columns j <= L
// (the live query length).  A live cell reads its predecessors' cells at
// j and j - 1 and the insertion chain to its left, all live.  Per node:
// the node's base and its predecessor slots from a staged tile (a slot
// holds -1 where the contract reads NEG rows: empty, or p >= v), pass 1
// from the predecessor rows (the previous node's row from registers, its
// cell left of the lane by a shuffle and, at a warp's edge, rebuilt from
// the warp carries; any other row from device memory, where it is final
// and L2-resident), packed first-maximum candidates, the warp's max-scan
// of h0[j] + gap j and, with several warps, one barrier a node (each
// warp publishes its aggregate), pass 2 in registers, then the live
// cells' stores.  The lane's query codes stay in registers for the
// whole launch: its columns are the same at every node.
template <int C, int NW>
__global__ void __launch_bounds__(32 * NW)
poa_linear_kernel(const uint8_t* __restrict__ bases,
                  const int* __restrict__ preds,
                  const uint8_t* __restrict__ q, int n, int Lq, int L,
                  int gap, int match, int mismatch, int* __restrict__ H,
                  uint8_t* __restrict__ dirs, int* __restrict__ ends) {
  constexpr int kLanes = 32 * NW;
  constexpr int kTile = NW > 1 ? kLanes : 64;
  __shared__ int s_base[kTile];
  __shared__ int4 s_pr[kTile];
  __shared__ int s_pub[2][NW];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t W = (size_t)Lq + 1;   // row stride
  const int b0 = tid * C;            // the lane's first column
  const int bw = warp * 32 * C;      // the warp's first column
  int qc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = b0 + c;
    qc[c] = j >= 1 && j <= L ? q[j - 1] : 5;
  }
  int pH[C];        // the previous node's final row
#pragma unroll
  for (int c = 0; c < C; ++c) pH[c] = kNeg;
  int xl = kNeg;    // its cell at column bw - 1, across the warp's edge

  for (int v0 = 0; v0 < n; v0 += kTile) {
    if (NW > 1) __syncthreads();
    else __syncwarp();
    for (int i = tid; i < kTile; i += kLanes) {
      const int v = v0 + i;
      int w = 0;
      int4 pr = make_int4(-1, -1, -1, -1);
      if (v < n) {
        const int4 pv =
            *reinterpret_cast<const int4*>(preds + (size_t)v * kMaxPreds);
        const bool has = pv.x >= 0 || pv.y >= 0 || pv.z >= 0 || pv.w >= 0;
        // a slot reads its predecessor's row only when that row is final
        // (0 <= p < v); otherwise the contract's NEG rows
        if (pv.x >= 0 && pv.x < v) pr.x = pv.x;
        if (pv.y >= 0 && pv.y < v) pr.y = pv.y;
        if (pv.z >= 0 && pv.z < v) pr.z = pv.z;
        if (pv.w >= 0 && pv.w < v) pr.w = pv.w;
        w = (bases[v] << 1) | (has ? 0 : 1);
      }
      s_base[i] = w;
      s_pr[i] = pr;
    }
    if (NW > 1) __syncthreads();
    else __syncwarp();
    const int vend = imin(kTile, n - v0);
    for (int i = 0; i < vend; ++i) {
      const int v = v0 + i;
      const int wd = s_base[i];
      const int4 pr4 = s_pr[i];
      const bool src = wd & 1;
      const int base = wd >> 1;
      const int prk[kMaxPreds] = {pr4.x, pr4.y, pr4.z, pr4.w};
      // the previous row's cell left of the lane's first cell
      int hl = __shfl_up_sync(kFull, pH[C - 1], 1);
      if (lane == 0) hl = xl;
      // the lowest slot that reads NEG rows stands for every such slot
      // (of equal candidates only the lowest can be a first maximum); a
      // source's slot 0 reads the virtual start row -gap j
      int kmin = kMaxPreds;
#pragma unroll
      for (int k = kMaxPreds - 1; k >= 0; --k)
        if (prk[k] < 0 && !(src && k == 0)) kmin = k;
      int sc[C], cd[C], cl[C];   // scores; packed diag and deletion maxima
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = b0 + c;
        sc[c] = qc[c] == base ? match : mismatch;
        if (kmin < kMaxPreds) {
          cd[c] = pack(j > 0 ? kNeg + sc[c] : kNeg, kmin);
          cl[c] = pack(kNeg - gap, kmin);
        } else {
          cd[c] = cl[c] = INT_MIN;
        }
        if (src) {
          cd[c] = imax(cd[c], pack(j > 0 ? -gap * (j - 1) + sc[c] : kNeg, 0));
          cl[c] = imax(cl[c], pack(-gap * j - gap, 0));
        }
      }
#pragma unroll
      for (int k = 0; k < kMaxPreds; ++k) {
        const int p = prk[k];
        if (p < 0) continue;
        // the predecessor row at columns b0 - 1 .. b0 + C - 1
        int hw[C + 1];
        if (p == v - 1) {
          hw[0] = hl;
#pragma unroll
          for (int c = 0; c < C; ++c) hw[c + 1] = pH[c];
        } else {
          const int* prow = H + (size_t)p * W;
#pragma unroll
          for (int t = 0; t <= C; ++t) {
            const int j = b0 - 1 + t;
            hw[t] = j >= 0 && j <= L ? prow[j] : kNeg;
          }
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = b0 + c;
          cd[c] = imax(cd[c], pack(j > 0 ? hw[c] + sc[c] : kNeg, k));
          cl[c] = imax(cl[c], pack(hw[c + 1] - gap, k));
        }
      }
      // pass 1: h0 and the move; the lane's max of h0[j] + gap j
      int h0[C], code[C];
      int agg = INT_MIN;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int bd = cd[c] >> 2, bl = cl[c] >> 2;
        h0[c] = imax(bd, bl);
        code[c] = bd >= bl ? ((3 - (cd[c] & 3)) << 2)
                           : (1 | ((3 - (cl[c] & 3)) << 2));
        agg = imax(agg, h0[c] + gap * (b0 + c));
      }
      // the team's exclusive max-scan: the warp's by shuffles, the warps
      // before it through shared memory (one barrier)
      int r = agg;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(kFull, r, off);
        if (lane >= off) r = imax(r, o);
      }
      int x = __shfl_up_sync(kFull, r, 1);
      if (lane == 0) x = INT_MIN;
      int carry = INT_MIN;
      if constexpr (NW > 1) {
        if (lane == 31) s_pub[v & 1][warp] = r;
        __syncthreads();
        for (int u = 0; u < warp; ++u) carry = imax(carry, s_pub[v & 1][u]);
        // the previous warp's last cell, final, for the next node
        if (warp > 0) xl = carry - gap * (bw - 1);
      }
      // pass 2: the insertion chain y[j] = max_{k <= j} h0[k] + gap k
      // minus gap j
      r = imax(carry, x);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = b0 + c;
        r = imax(r, h0[c] + gap * j);
        const int y = r - gap * j;
        if (y != h0[c]) code[c] = (code[c] & ~3) | 2;
        pH[c] = y;
      }
      int* hrow = H + (size_t)v * W;
      uint8_t* drow = dirs + (size_t)v * W;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = b0 + c;
        if (j <= L) {
          hrow[j] = pH[c];
          drow[j] = (uint8_t)code[c];
          if (j == Lq) ends[v] = pH[c];
        }
      }
      // the row is in device memory before a later node reads it (with
      // several warps, the next node's barrier orders it)
      if (NW == 1) __syncwarp();
    }
  }
}

// The team shapes ops/poa_cuda.py::TEAM_SHAPES lists for each kernel,
// cover by cover (and poa_chain's shape for large cover-64 launches,
// POA_CHAIN_PACKED): the shapes team_shape picks and no other.
#define POA_CHAIN_SHAPES(X)                                                  \
  X(2, 16, 1) X(2, 32, 1) X(4, 16, 1) X(2, 32, 2) X(2, 32, 4) X(4, 32, 4)  \
  X(4, 32, 8) X(4, 32, 16) X(8, 32, 16) X(16, 32, 16) X(32, 32, 16)
// NARROW(C, TL, NW) for covers up to 256, which poa_affine also
// instantiates with its history rows in shared memory; WIDE past them.
#define POA_AFFINE_SHAPES(NARROW, WIDE)                                      \
  NARROW(2, 16, 1) NARROW(2, 32, 1) NARROW(2, 32, 2) NARROW(2, 32, 4)        \
  WIDE(2, 32, 8) WIDE(2, 32, 16) WIDE(4, 32, 16) WIDE(8, 32, 16)             \
  WIDE(16, 32, 16) WIDE(32, 32, 16)
// poa_linear's one team a launch (TL is 32: one problem)
#define POA_LINEAR_SHAPES(X)                                                 \
  X(1, 32, 1) X(2, 32, 1) X(2, 32, 2) X(2, 32, 4) X(4, 32, 4) X(4, 32, 8)   \
  X(4, 32, 16) X(8, 32, 16) X(16, 32, 16) X(32, 32, 16)

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// poa_affine over any DAG.  (C, TL, NW) is the team shape the wrapper
// picked from max_live (ops/poa_cuda.py::team_shape), smem whether the
// history rows live in shared memory or in hist, the global scratch
// (P, 3, rows, stride): rows nodes of `stride` cells (max_live rounded up
// to 4; a cell past a launch's widest live row is never live, so no live
// cell reads one).
int poa_affine_launch(const void* bases, const void* preds, const void* off,
                      const void* q_ext, const void* l_len,
                      const void* n_nodes, const void* submat, int P, int N,
                      int Lq, int B, int C, int TL, int NW, int smem,
                      int rows, int stride, int o1, int e1, int o2, int e2,
                      void* H, void* dirs, void* ends, void* hist,
                      void* stream) {
  if (P <= 0 || N <= 0) return 0;
  if (B < 32 || (B & (B - 1)) != 0) return (int)cudaErrorInvalidValue;
  const Gaps g{o1, e1, o2, e2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* bs = static_cast<const uint8_t*>(bases);
  const auto* pr = static_cast<const int*>(preds);
  const auto* of = static_cast<const int*>(off);
  const auto* q = static_cast<const uint8_t*>(q_ext);
  const auto* ll = static_cast<const int*>(l_len);
  const auto* nn = static_cast<const int*>(n_nodes);
  const auto* sm = static_cast<const int*>(submat);
  auto* h = static_cast<int*>(H);
  auto* d = static_cast<int16_t*>(dirs);
  auto* e = static_cast<int*>(ends);
  auto* hs = static_cast<int*>(hist);
#define POA_AFFINE_RUN(C_, TL_, NW_, SMEM_)                                 \
  {                                                                         \
    using T = Team<C_, TL_, NW_, SMEM_ ? 1 : 4, 32>;                        \
    if (T::kCover > B || rows < 1 || stride < 1 || stride > T::kCover ||    \
        stride % 4 != 0 || (!SMEM_ && hs == nullptr))                       \
      return (int)cudaErrorInvalidValue;                                    \
    const size_t dyn =                                                      \
        SMEM_ ? (size_t)T::kTeams * 3 * rows * stride * sizeof(int) : 0;    \
    cudaError_t err = cudaFuncSetAttribute(                                 \
        poa_affine_kernel<C_, TL_, NW_, SMEM_>,                             \
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);             \
    if (err != cudaSuccess) return (int)err;                                \
    poa_affine_kernel<C_, TL_, NW_, SMEM_>                                  \
        <<<(P + T::kTeams - 1) / T::kTeams, T::kThreads, dyn, st>>>(        \
            bs, pr, of, q, ll, nn, sm, P, N, Lq, B, rows, stride, g, h, d, e, \
            hs);                                                            \
    return (int)cudaGetLastError();                                         \
  }
#define POA_AFFINE_SHAPE_SMEM(C_, TL_, NW_)                                 \
  if (C == C_ && TL == TL_ && NW == NW_) {                                  \
    if (smem) POA_AFFINE_RUN(C_, TL_, NW_, true)                            \
    POA_AFFINE_RUN(C_, TL_, NW_, false)                                     \
  }
#define POA_AFFINE_SHAPE(C_, TL_, NW_)                                      \
  if (C == C_ && TL == TL_ && NW == NW_) {                                  \
    if (smem) return (int)cudaErrorInvalidValue;                            \
    POA_AFFINE_RUN(C_, TL_, NW_, false)                                     \
  }
  POA_AFFINE_SHAPES(POA_AFFINE_SHAPE_SMEM, POA_AFFINE_SHAPE)
#undef POA_AFFINE_SHAPE_SMEM
#undef POA_AFFINE_SHAPE
#undef POA_AFFINE_RUN
  return (int)cudaErrorInvalidValue;   // not a shape of POA_AFFINE_SHAPES
}

// poa_chain on a certified chain batch.  (C, TL, NW) is the team shape
// the wrapper picked from max_live (ops/poa_cuda.py::team_shape).
int poa_chain_launch(const void* bases, const void* preds, const void* off,
                     const void* q_ext, const void* l_len,
                     const void* n_nodes, const void* submat, int P, int N,
                     int Lq, int B, int C, int TL, int NW, int o1, int e1,
                     int o2, int e2, void* H, void* dirs, void* ends,
                     void* stream) {
  if (P <= 0 || N <= 0) return 0;
  if (B < 32 || (B & (B - 1)) != 0) return (int)cudaErrorInvalidValue;
  const Gaps g{o1, e1, o2, e2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* bs = static_cast<const uint8_t*>(bases);
  const auto* pr = static_cast<const int*>(preds);
  const auto* of = static_cast<const int*>(off);
  const auto* q = static_cast<const uint8_t*>(q_ext);
  const auto* ll = static_cast<const int*>(l_len);
  const auto* nn = static_cast<const int*>(n_nodes);
  const auto* sm = static_cast<const int*>(submat);
  auto* h = static_cast<int*>(H);
  auto* d = static_cast<int16_t*>(dirs);
  auto* e = static_cast<int*>(ends);
#define POA_CHAIN_SHAPE(C_, TL_, NW_)                                      \
  if (C == C_ && TL == TL_ && NW == NW_) {                                 \
    using T = Team<C_, TL_, NW_>;                                          \
    if (T::kCover > B) return (int)cudaErrorInvalidValue;                  \
    poa_chain_kernel<C_, TL_, NW_>                                         \
        <<<(P + T::kTeams - 1) / T::kTeams, T::kThreads, 0, st>>>(         \
            bs, pr, of, q, ll, nn, sm, P, N, Lq, B, g, h, d, e);           \
    return (int)cudaGetLastError();                                        \
  }
  POA_CHAIN_SHAPES(POA_CHAIN_SHAPE)
#undef POA_CHAIN_SHAPE
  return (int)cudaErrorInvalidValue;   // not a shape of POA_CHAIN_SHAPES
}

// poa_linear on the live cells (nodes v < n, columns j <= L) of one
// problem whose rows have stride Lq + 1.  (C, TL, NW) is the team shape
// the wrapper picked from L + 1 (ops/poa_cuda.py::team_shape).
int poa_linear_launch(const void* bases, const void* preds, const void* q,
                      int n, int Lq, int L, int C, int TL, int NW, int gap,
                      int match, int mismatch, void* H, void* dirs,
                      void* ends, void* stream) {
  if (n <= 0) return 0;
  if (L < 0 || L > Lq) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define POA_LINEAR_SHAPE(C_, TL_, NW_)                                     \
  if (C == C_ && TL == TL_ && NW == NW_) {                                 \
    if (32 * NW_ * C_ < L + 1) return (int)cudaErrorInvalidValue;          \
    poa_linear_kernel<C_, NW_><<<1, 32 * NW_, 0, st>>>(                    \
        static_cast<const uint8_t*>(bases), static_cast<const int*>(preds), \
        static_cast<const uint8_t*>(q), n, Lq, L, gap, match, mismatch,     \
        static_cast<int*>(H), static_cast<uint8_t*>(dirs),                 \
        static_cast<int*>(ends));                                          \
    return (int)cudaGetLastError();                                        \
  }
  POA_LINEAR_SHAPES(POA_LINEAR_SHAPE)
#undef POA_LINEAR_SHAPE
  return (int)cudaErrorInvalidValue;   // not a shape of POA_LINEAR_SHAPES
}

}  // extern "C"
