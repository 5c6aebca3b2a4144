// The partial-order alignment DPs at rows wider than the widest team cover
// (poa.cu's kernels, 16384 cells), for NVIDIA Hopper (built for sm_90a,
// bound with ctypes): one thread-block cluster a problem on its live row.
//
// poa_cluster_kernel is the wide route of poa_affine and poa_chain
//   (ops/poa_cuda.py::poa_route), whose team kernels replace the Pallas
//   TPU kernels cactus_tpu/ops/poa_pallas.py::_affine_kernel and
//   ::_chain_kernel.  Contract: cactus_tpu/ops/poa.py::
//   poa_align_scan_affine (convex dual-affine gaps, adaptive band B, cell
//   (v, b) at column off[v] + b, up to 4 predecessors a node), matched
//   bit for bit on each problem's live cells (ops/poa_cuda.py::live_mask:
//   its real nodes v < n, band cells b with off[v] + b <= L), and ends on
//   its real nodes (NEG where column L is outside the band); no other
//   cell is written.  Its launches count as "poa_wide".
// poa_linear_cluster_kernel is the wide route of poa_linear (the Pallas
//   kernel ::_kernel).  Contract: ops/poa.py::poa_align_scan (linear
//   gaps), matched bit for bit on the live cells (linear_live_mask: real
//   nodes v < n, columns j <= L), ends on the real nodes when L is the
//   whole query.  Its launches count as "poa_linear_wide".
//
// What bounds them on an H100: a node needs its predecessors' final rows,
// so a problem's nodes run one after another, and a launch of one or a
// few problems (the wide route's) is bound by its longest problem's nodes
// times the dependent steps of one node: the warp scans, the block and
// cluster barriers of the row's exchange, and in a DAG a round of loads
// of the predecessor rows.  The int32 work (ops/poa_cuda.py
// POA_AFFINE_OPS_PER_CELL, POA_LINEAR_OPS_PER_CELL) and the 6 (5) bytes a
// live cell written are far below the card's rates.
//
// Design.  The shared parts of a cell (packed first-maximum candidates,
// pass 2, the stores) are poa.cu's, in poa.cuh.
//  - A problem's live row [0, max_live) is spread over one cluster of up
//    to 16 CTAs (non-portable past 8): each CTA a contiguous slice, each
//    lane C = 4 consecutive cells of it in registers, in the fewest warps
//    that cover max_live (poa_shape; the wrapper passes max_live from the
//    host arrays).  Past 16 CTAs of the register instance's widest CTA,
//    512 threads (32,768 cells), the same kernel (kReg false) keeps a
//    lane's cells in the problem's global scratch, cell c of lane G at
//    c * lanes + G, so every width runs.  Four cells a lane beat eight
//    and sixteen on an H100 (twice and four times the warps to hide a
//    cell's latency; at sixteen the lanes' scattered stores cost the
//    linear kernel a third of its node).
//  - A node is pass 1 (the predecessor cells, the deletion states and
//    h0 = max(diag, F1, F2) with its partial code), the row's exchange and
//    pass 2 (the in-row insertion chains E_k[b] = max(NEG, max_{b' < b}
//    Z_k[b'] - o_k - e_k b) with Z_k = h0 + e_k b, the move and the
//    E-extend bits, which need E of cell b - 1).
//  - The row's exchange: the lanes' max-scan of Z_1, Z_2 by warp
//    shuffles; each warp publishes its totals, its totals without its last
//    cell, its last cell's h0 and its first cell's h0 / F1 / F2 in shared
//    memory; one block barrier; warp 0 folds them into the CTA's and pushes
//    (distributed shared memory stores, double-buffered by node parity)
//    its totals into every later CTA's ring, its last cell's h0 with the
//    totals without it into the next CTA's and its first cell's values
//    into the previous CTA's; one cluster barrier.  Every thread then forms
//    the carry entering its CTA and warp from the totals before it, and
//    rebuilds the cells across its warp's (CTA's) edges from the published
//    values: the final H and E of the cell left of its first (the extend
//    bits now, the left neighbour of the next node) and the H / F1 / F2
//    of the cell right of its last (the right neighbour of the next node).
//    That is poa.cu's warp-edge rebuild (team_row) lifted to CTA edges.
//  - History.  The previous node's row stays in the lanes' registers: on a
//    chain_certified launch (predecessor v - 1 at a band-offset step of 0
//    or 1) it is the only row read, as in poa_chain_kernel.  A DAG launch
//    (kDag) also keeps H, F1 and F2 of every node's live cells in rows of
//    `stride` cells in global scratch (P, 3, N, stride), read at each
//    predecessor slot's step d = off[v] - off[p], which may put the cell
//    in any CTA's slice; a slot naming v - 1 at d = 0 or 1 reads the
//    registers.  The register instance copies each other slot's window
//    of the CTA's slice (its H, F1, F2 at the step, one cell more) into
//    shared memory by coalesced cp.async, a node ahead where it can (rows
//    p <= v - 2 are final at node v - 1's barrier), so that the round of
//    loads leaves the node's chain; pass 1 reads a slot's cells of a lane
//    together, one round of shared-memory loads a slot.
//  - Memory order across CTAs.  cg::this_cluster().sync() is
//    barrier.cluster.arrive (release) and barrier.cluster.wait (acquire)
//    at cluster scope: every store a CTA made before it (the distributed
//    shared memory pushes, and the history rows and H rows in global
//    memory) is visible to every load another CTA makes after it.  A row
//    p is stored after node p's barrier, so node v reads rows p <= v - 2
//    after node v - 1's barrier; a DAG node that reads row v - 1 at
//    another step first takes one more cluster barrier.  No __syncthreads
//    orders memory across CTAs.  Global rows written in the launch are
//    read by plain loads (not the read-only path).
//  - Each CTA stages a tile of 64 nodes (node word; in a DAG the
//    predecessor slots and their steps) and the query codes of its slice
//    from the tile's first offset on in shared memory (a code outside
//    that window comes from device memory).  A lane stores H of its live
//    cells as one 16-byte vector (dirs as one 8-byte vector) where its
//    cells are all live.
// poa_linear_cluster_kernel: the same cluster over the columns
//   [0, l_len + 1) of one problem.  Linear gaps make the insertion chain a
//   plain prefix max of h0[k] + gap k minus gap j, so a warp publishes one
//   total, a CTA pushes its total into every later CTA, and the left
//   neighbour across an edge is the carry entering it minus gap times its
//   column.  The previous node's row stays in registers; other
//   predecessor rows p < v - 1 are read from the H output (stored after
//   node p's barrier, so final and visible at node v); p >= v reads the
//   contract's NEG rows.  A lane stores H as one 16-byte vector and its
//   codes as one 4-byte word where the row's stride lets them align.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "cluster.cuh"
#include "poa.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kClusterMax = 16;       // CTAs a cluster (non-portable past 8)
constexpr int kCells = 4;             // cells a lane, register instances
constexpr int kRegThreads = 512;      // their widest CTA
constexpr int kScratchThreads = 512;  // CTAs of the global-scratch instance
constexpr int kMaxWarps = kScratchThreads / 32;
constexpr int kNodeTile = 64;         // nodes staged at a time
// query codes staged a CTA: the register instance's slice and the offset
// steps of a chain tile
constexpr int kQWin = kRegThreads * kCells + kNodeTile;
// a lane's rows in global scratch: previous H, F1, F2, h0, new F1, F2 and
// the code (affine); previous H, h0 and the code (linear)
constexpr int kAffinePlanes = 7;
constexpr int kLinearPlanes = 3;

// The cluster a wide launch takes for max_live W: kCells cells a lane in
// the fewest warps that cover W, over as many CTAs as there are warps, up
// to kClusterMax (max_ctas, when it is above 0), CTAs of up to
// kRegThreads threads with the cells in registers (reg); past that cap
// CTAs of kScratchThreads threads with as many cells a lane as W needs,
// in global scratch.
struct PoaShape {
  ClusterShape sh;   // smem unused: 0
  bool reg;
};

PoaShape poa_shape(int W, int max_ctas) {
  const int cap = max_ctas > 0 && max_ctas < kClusterMax ? max_ctas
                                                          : kClusterMax;
  const long long per_warp = 32LL * kCells;
  const long long warps = (W + per_warp - 1) / per_warp;
  if (warps <= (long long)cap * (kRegThreads / 32)) {
    const int ctas = (int)(warps < cap ? warps : cap);
    return PoaShape{
        {ctas, 32 * (int)((warps + ctas - 1) / ctas), kCells, 0}, true};
  }
  const long long lanes = (long long)cap * kScratchThreads;
  return PoaShape{
      {cap, kScratchThreads, (int)((W + lanes - 1) / lanes), 0}, false};
}

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = imax(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// inclusive max-scan of two ints across the warp
__device__ __forceinline__ void warp_scan2(int& a, int& b) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int oa = __shfl_up_sync(kFull, a, o);
    const int ob = __shfl_up_sync(kFull, b, o);
    if (lane >= o) {
      a = imax(a, oa);
      b = imax(b, ob);
    }
  }
}

__device__ __forceinline__ void cp_async4(int* smem, const int* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ------------------------------------------------------------ affine

// A staged window's word for cell i: one pad word in 33, so that the
// lanes of a warp (C cells apart, C a divisor of 32) read 32 banks.
__device__ __forceinline__ int pad32(int i) { return i + (i >> 5); }

// The CTA's window of history row p at step d for predecessor slot k: the
// cells bc + d - 1 + i, i = 0 .. slice, of its H, F1 and F2 planes into
// the slot's three planes of `buf` (pw words each), one 4-byte cp.async a
// cell in the row (a reader masks a cell outside it to NEG).  Coalesced:
// neighbouring threads copy neighbouring cells.
__device__ __forceinline__ void stage_window(int* buf, int k, int pw,
                                             const int* hH, size_t hplane,
                                             int p, int d, int stride,
                                             int bc, int slice) {
  const size_t at = (size_t)p * stride;
  int* w = buf + 3 * k * pw;
  for (int i = threadIdx.x; i <= slice; i += blockDim.x) {
    const int gi = bc + d - 1 + i;
    if ((unsigned)gi < (unsigned)stride) {
      const int x = pad32(i);
      cp_async4(w + x, hH + at + gi);
      cp_async4(w + pw + x, hH + hplane + at + gi);
      cp_async4(w + 2 * pw + x, hH + 2 * hplane + at + gi);
    }
  }
}

// What a warp publishes for its CTA's part of the row's exchange: its
// totals of Z_1 / Z_2, the same without its last cell, its last cell's h0
// and its first cell's h0, F1, F2.
struct WarpPub {
  int w1, w2, a1, a2, h0l, h0f, F1f, F2f;
};

// What the other CTAs of a problem's cluster push into this CTA's shared
// memory, double-buffered by node parity.
struct AffineRing {
  int tot[2][kClusterMax][2];   // each earlier CTA's totals of Z_1, Z_2
  int hi[2][3];                 // the previous CTA's last cell: h0, and its
                                // totals without that cell
  int lo[2][3];                 // the next CTA's first cell: h0, F1, F2
};

struct AffineSmem {
  int sub[36];
  int node[kNodeTile];          // band offset * 16 | base << 1 | source
  int4 pr[kNodeTile];           // DAG: predecessor slots (-1: NEG rows)
  int4 dv[kNodeTile];           // DAG: each slot's band-offset step
  WarpPub pub[2][kMaxWarps];
  AffineRing ring;
  uint8_t q[kQWin];
};

// Warp 0, after the block barrier: the CTA's totals (with and without its
// last cell), pushed with its edge cells into the rings of the CTAs that
// read them.
__device__ void push_affine(AffineSmem& s, int par, int nw, int rank,
                            int ctas) {
  cg::cluster_group cl = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  const WarpPub* pub = s.pub[par];
  int t1 = INT_MIN, t2 = INT_MIN, x1 = INT_MIN, x2 = INT_MIN;
  if (lane < nw) {
    t1 = pub[lane].w1;
    t2 = pub[lane].w2;
    x1 = lane < nw - 1 ? t1 : pub[lane].a1;
    x2 = lane < nw - 1 ? t2 : pub[lane].a2;
  }
  t1 = warp_max(t1);
  t2 = warp_max(t2);
  x1 = warp_max(x1);
  x2 = warp_max(x2);
  if (lane < ctas) {
    AffineRing* r = cl.map_shared_rank(&s.ring, lane);
    if (lane > rank) {
      r->tot[par][rank][0] = t1;
      r->tot[par][rank][1] = t2;
    }
    if (lane == rank + 1) {
      r->hi[par][0] = pub[nw - 1].h0l;
      r->hi[par][1] = x1;
      r->hi[par][2] = x2;
    }
    if (lane == rank - 1) {
      r->lo[par][0] = pub[0].h0f;
      r->lo[par][1] = pub[0].F1f;
      r->lo[par][2] = pub[0].F2f;
    }
  }
}

// poa_cluster_kernel<C, kReg, kDag, kThreads>: one cluster a problem
// (blockIdx.x / cluster size), C cells a lane in registers (kReg) or
// `cells` in the problem's `scratch` (P, kAffinePlanes, lanes * cells);
// kDag: any DAG, history rows in `hist` (P, 3, N, stride); else a
// chain_certified batch, no history.  The register instance of a DAG
// stages each predecessor slot's history window in dynamic shared memory
// (stage_window; 4 slots x 3 planes of pad32(slice) + 1 words), a node
// ahead where the row is final: node v's windows of rows p <= v - 2 are
// copied right after node v - 1's cluster barrier, while it finishes.
template <int C, bool kReg, bool kDag, int kThreads>
__global__ void __launch_bounds__(kThreads)
poa_cluster_kernel(const uint8_t* __restrict__ bases,
                   const int* __restrict__ preds, const int* __restrict__ off,
                   const uint8_t* __restrict__ q_ext,
                   const int* __restrict__ l_len,
                   const int* __restrict__ n_nodes,
                   const int* __restrict__ submat, int N, int Lq, int B,
                   int stride, int cells, Gaps g, int* __restrict__ H,
                   int16_t* __restrict__ dirs, int* __restrict__ ends,
                   int* hist, int* scratch) {
  constexpr bool kStage = kReg && kDag;
  constexpr int K = C;                // cells a chunk of pass 1
  cg::cluster_group cl = cg::this_cluster();
  __shared__ AffineSmem s;
  extern __shared__ int4 s_dyn[];
  int* buf = reinterpret_cast<int*>(s_dyn);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int T = blockDim.x;
  const int nw = T >> 5;
  const int rank = (int)cl.block_rank();
  const int ctas = (int)cl.num_blocks();
  const int p = blockIdx.x / ctas;
  const int nc = kReg ? C : cells;    // cells a lane
  const int slice = T * nc;           // cells a CTA
  const int pw = pad32(slice) + 1;     // words of a staged plane
  const int lanes = ctas * T;
  const int G = rank * T + t;         // the lane's place in the cluster
  const int b0 = G * nc;              // its first band cell
  const int bw = (G - lane) * nc;     // its warp's
  const int bc = rank * T * nc;       // its CTA's
  const int be = bc + T * nc;         // past its CTA's last
  const int L = l_len[p];
  const int n = n_nodes[p];
  const uint8_t* qp = q_ext + (size_t)p * Lq;
  const size_t pN = (size_t)p * N;
  const size_t hplane = (size_t)N * stride;
  int* hH = kDag ? hist + (size_t)p * 3 * hplane : nullptr;
  for (int k = t; k < 36; k += T) s.sub[k] = submat[k];
  // the previous node's row (final H, F1, F2) and this node's h0, F1, F2
  // and direction code
  Cells<C, kReg, int> pH, pF1, pF2, h0, nF1, nF2, code;
  if constexpr (!kReg) {
    const size_t pl = (size_t)lanes * nc;
    int* base = scratch + (size_t)p * kAffinePlanes * pl + G;
    pH.bind(base, lanes);
    pF1.bind(base + pl, lanes);
    pF2.bind(base + 2 * pl, lanes);
    h0.bind(base + 3 * pl, lanes);
    nF1.bind(base + 4 * pl, lanes);
    nF2.bind(base + 5 * pl, lanes);
    code.bind(base + 6 * pl, lanes);
  }
#pragma unroll
  for (int c = 0; c < nc; ++c) pH[c] = pF1[c] = pF2[c] = kNeg;
  // the previous row's cells across the warp's edges: left of its first
  // (H), right of its last (H, F1, F2); NEG past the row's ends
  int xl_H = kNeg, xr_H = kNeg, xr_F1 = kNeg, xr_F2 = kNeg;
  int off_prev = 0;
  // every CTA of the cluster runs before any pushes into its shared memory
  cl.sync();

  for (int v0 = 0; v0 < n; v0 += kNodeTile) {
    __syncthreads();   // the previous tile is read
    for (int i = t; i < kNodeTile; i += T) {
      const int v = v0 + i;
      int w = 0;
      int4 pr = make_int4(-1, -1, -1, -1), dd = make_int4(0, 0, 0, 0);
      if (v < n) {
        const int ov = off[pN + v];
        const int4 pv =
            *reinterpret_cast<const int4*>(preds + (pN + v) * kMaxPreds);
        const bool has = pv.x >= 0 || pv.y >= 0 || pv.z >= 0 || pv.w >= 0;
        if constexpr (kDag) {
          // a slot reads its predecessor's row only when that row is final
          // (0 <= p < v); otherwise the contract's NEG candidates
          const int pk[kMaxPreds] = {pv.x, pv.y, pv.z, pv.w};
          int pq[kMaxPreds], dq[kMaxPreds];
#pragma unroll
          for (int k = 0; k < kMaxPreds; ++k) {
            const bool ready = pk[k] >= 0 && pk[k] < v;
            pq[k] = ready ? pk[k] : -1;
            dq[k] = ready ? ov - off[pN + pk[k]] : 0;
          }
          pr = make_int4(pq[0], pq[1], pq[2], pq[3]);
          dd = make_int4(dq[0], dq[1], dq[2], dq[3]);
        }
        w = ov * 16 + (bases[pN + v] << 1) + (has ? 0 : 1);
      }
      s.node[i] = w;
      if constexpr (kDag) {
        s.pr[i] = pr;
        s.dv[i] = dd;
      }
    }
    const int qlo = imax(0, off[pN + v0] + bc);
    const int qhi = imin(L, Lq - 1);
    for (int i = t; i < kQWin; i += T) {
      const int j = qlo + i;
      s.q[i] = j <= qhi ? qp[j] : 5;
    }
    __syncthreads();
    const int vend = imin(kNodeTile, n - v0);

    for (int i = 0; i < vend; ++i) {
      const int v = v0 + i;
      const int par = v & 1;
      const int wd = s.node[i];
      const int off_v = wd >> 4;
      const bool src = wd & 1;
      const int* srow = s.sub + 6 * ((wd >> 1) & 7);
      int prk[kMaxPreds] = {-1, -1, -1, -1};
      int dvk[kMaxPreds] = {0, 0, 0, 0};
      bool reg[kMaxPreds] = {false, false, false, false};
      int kmin = kMaxPreds;
      if constexpr (kDag) {
        const int4 pr4 = s.pr[i];
        const int4 dv4 = s.dv[i];
        prk[0] = pr4.x; prk[1] = pr4.y; prk[2] = pr4.z; prk[3] = pr4.w;
        dvk[0] = dv4.x; dvk[1] = dv4.y; dvk[2] = dv4.z; dvk[3] = dv4.w;
        bool again = false;
#pragma unroll
        for (int k = kMaxPreds - 1; k >= 0; --k) {
          reg[k] = prk[k] == v - 1 && (unsigned)dvk[k] <= 1u;
          again |= prk[k] == v - 1 && !reg[k];
          // the lowest slot that reads NEG rows (a source's slot 0 reads
          // the virtual start row)
          if (prk[k] < 0 && !(src && k == 0)) kmin = k;
        }
        // Row v - 1 at a step the registers do not hold: its history
        // stores (after node v - 1's barrier) are ordered before these
        // loads by one more release / acquire cluster barrier.
        if (again) cl.sync();
      } else {
        // chain: slot 0 holds v - 1 at step d, slots 1-3 are empty
        prk[0] = src ? -1 : v - 1;
        dvk[0] = src ? 0 : off_v - off_prev;
        reg[0] = !src;
        kmin = 1;
      }
      if constexpr (kStage) {
        // the history windows this node reads that the node before did not
        // prefetch, then every copy in, for the whole CTA
        bool any = false;
#pragma unroll
        for (int k = 0; k < kMaxPreds; ++k) {
          if (prk[k] < 0 || reg[k]) continue;
          any = true;
          if (!(i > 0 && prk[k] <= v - 2))
            stage_window(buf, k, pw, hH, hplane, prk[k], dvk[k], stride, bc,
                         slice);
        }
        if (any) {
          cp_async_wait_all();
          __syncthreads();
        }
      }
      // the previous row's cells next to the lane's: the left lane's last
      // H, the right lane's first H, F1, F2 (at a warp's edge rebuilt from
      // what the neighbour warp or CTA published)
      int hl = __shfl_up_sync(kFull, pH[nc - 1], 1);
      int hr = __shfl_down_sync(kFull, pH[0], 1);
      int f1r = __shfl_down_sync(kFull, pF1[0], 1);
      int f2r = __shfl_down_sync(kFull, pF2[0], 1);
      if (lane == 0) hl = xl_H;
      if (lane == 31) {
        hr = xr_H;
        f1r = xr_F1;
        f2r = xr_F2;
      }

      // pass 1, by chunks of K cells (the lane's C in registers): each
      // slot's cells of a chunk are read together, then used
      int agg1 = INT_MIN, agg2 = INT_MIN, aggx1 = INT_MIN, aggx2 = INT_MIN;
      for (int c0 = 0; c0 < nc; c0 += K) {
        Cands cd[K];
        int sc[K];
#pragma unroll
        for (int x = 0; x < K; ++x) {
          const int j = off_v + b0 + c0 + x;
          const int jj = imin(imax(j, 0), L);
          const unsigned qk = (unsigned)(jj - qlo);
          sc[x] = srow[qk < (unsigned)kQWin ? s.q[qk] : qp[jj]];
          if (kmin < kMaxPreds) cands_empty(cd[x], kmin, sc[x], g);
          else cands_none(cd[x]);
          if (src) {
            cands_slot(cd[x], 0, row0_at(j, g), kNeg, kNeg,
                       row0_at(j - 1, g), sc[x], g);
          }
        }
#pragma unroll
        for (int k = 0; k < kMaxPreds; ++k) {
          if (prk[k] < 0) continue;
          if (reg[k]) {
            // v - 1 from the registers: step 1 reads the cell right of b
            // (NEG past the band, where a cover wider than the band
            // computes cells)
            const bool one = dvk[k] != 0;
#pragma unroll
            for (int x = 0; x < K; ++x) {
              const int c = c0 + x;
              if (!kReg && c >= nc) break;
              const int b = b0 + c;
              const int H0 = pH[c];
              if (one) {
                const bool rin = b + 1 < B;
                const bool in = c < nc - 1;
                cands_slot(cd[x], k, !rin ? kNeg : in ? pH[c + 1] : hr,
                           !rin ? kNeg : in ? pF1[c + 1] : f1r,
                           !rin ? kNeg : in ? pF2[c + 1] : f2r, H0, sc[x],
                           g);
              } else {
                cands_slot(cd[x], k, H0, pF1[c], pF2[c],
                           c > 0 ? pH[c - 1] : hl, sc[x], g);
              }
            }
          } else if constexpr (kDag) {
            // the history row at b + d (H, F1, F2) and b + d - 1 (H):
            // from the CTA's staged window, or from global memory; NEG
            // outside the row (a live cell reads only live cells there)
            const int gi0 = dvk[k] + b0 + c0;
            int hw[K + 1], f1w[K], f2w[K];
#pragma unroll
            for (int y = 0; y <= K; ++y) {
              const int gi = gi0 - 1 + y;
              const bool ok = (unsigned)gi < (unsigned)stride;
              if constexpr (kStage) {
                const int* w = buf + 3 * k * pw;
                const int at = pad32(t * C + c0 + y);
                hw[y] = ok ? w[at] : kNeg;
                if (y > 0) {
                  f1w[y - 1] = ok ? w[pw + at] : kNeg;
                  f2w[y - 1] = ok ? w[2 * pw + at] : kNeg;
                }
              } else {
                const size_t at = (size_t)prk[k] * stride + gi;
                hw[y] = ok ? hH[at] : kNeg;
                if (y > 0) {
                  f1w[y - 1] = ok ? hH[hplane + at] : kNeg;
                  f2w[y - 1] = ok ? hH[2 * hplane + at] : kNeg;
                }
              }
            }
#pragma unroll
            for (int x = 0; x < K; ++x)
              cands_slot(cd[x], k, hw[x + 1], f1w[x], f2w[x], hw[x], sc[x],
                         g);
          }
        }
#pragma unroll
        for (int x = 0; x < K; ++x) {
          const int c = c0 + x;
          if (!kReg && c >= nc) break;
          const int b = b0 + c;
          int hh, F1o, F2o, cc;
          cands_cell(cd[x], hh, F1o, F2o, cc);
          h0[c] = hh;
          nF1[c] = F1o;
          nF2[c] = F2o;
          code[c] = cc;
          if (c == nc - 1) {
            aggx1 = agg1;
            aggx2 = agg2;
          }
          agg1 = imax(agg1, hh + g.e1 * b);
          agg2 = imax(agg2, hh + g.e2 * b);
        }
      }

      // the row's exchange: the warp's scan, its published values, the
      // block barrier, warp 0's pushes, the cluster barrier
      int r1 = agg1, r2 = agg2;
      warp_scan2(r1, r2);
      int x1 = __shfl_up_sync(kFull, r1, 1);
      int x2 = __shfl_up_sync(kFull, r2, 1);
      if (lane == 0) x1 = x2 = INT_MIN;
      WarpPub* pub = s.pub[par];
      if (lane == 31) {
        pub[warp].w1 = r1;
        pub[warp].w2 = r2;
        pub[warp].a1 = imax(x1, aggx1);
        pub[warp].a2 = imax(x2, aggx2);
        pub[warp].h0l = h0[nc - 1];
      }
      if (lane == 0) {
        pub[warp].h0f = h0[0];
        pub[warp].F1f = nF1[0];
        pub[warp].F2f = nF2[0];
      }
      __syncthreads();
      if (warp == 0) push_affine(s, par, nw, rank, ctas);
      // release / acquire: the pushes above (and every CTA's history and
      // output stores of the nodes before) are visible after it
      cl.sync();

      // the carries entering the CTA before this one, this CTA, the warp
      // before this one and this warp, from the totals before them
      const AffineRing& rg = s.ring;
      int cp1 = kNeg, cp2 = kNeg, cc1 = kNeg, cc2 = kNeg;
      for (int r = 0; r < rank; ++r) {
        cp1 = cc1;
        cp2 = cc2;
        cc1 = imax(cc1, rg.tot[par][r][0]);
        cc2 = imax(cc2, rg.tot[par][r][1]);
      }
      int wp1 = cc1, wp2 = cc2, cw1 = cc1, cw2 = cc2;
      for (int u = 0; u < warp; ++u) {
        wp1 = cw1;
        wp2 = cw2;
        cw1 = imax(cw1, pub[u].w1);
        cw2 = imax(cw2, pub[u].w2);
      }
      // the cell left of the warp's first: its E now (the extend bits of
      // cell bw), its H for the next node
      int lE1 = kNeg, lE2 = kNeg;
      if (warp > 0) {
        edge_cell(pub[warp - 1].h0l, imax(wp1, pub[warp - 1].a1),
                  imax(wp2, pub[warp - 1].a2), bw - 1, g, xl_H, lE1, lE2);
      } else if (rank > 0) {
        edge_cell(rg.hi[par][0], imax(cp1, rg.hi[par][1]),
                  imax(cp2, rg.hi[par][2]), bc - 1, g, xl_H, lE1, lE2);
      }
      // the cell right of the warp's last, for the next node
      const int cn1 = imax(cw1, pub[warp].w1);
      const int cn2 = imax(cw2, pub[warp].w2);
      if (warp < nw - 1) {
        int e1, e2;
        edge_cell(pub[warp + 1].h0f, cn1, cn2, bw + 32 * nc, g, xr_H, e1,
                  e2);
        xr_F1 = pub[warp + 1].F1f;
        xr_F2 = pub[warp + 1].F2f;
      } else if (rank < ctas - 1) {
        int e1, e2;
        edge_cell(rg.lo[par][0], cn1, cn2, be, g, xr_H, e1, e2);
        xr_F1 = rg.lo[par][1];
        xr_F2 = rg.lo[par][2];
      }

      if constexpr (kStage) {
        // the next node's windows of rows p <= v - 1, final and visible
        // since this barrier, copied while this node finishes (every
        // thread has read this node's windows before the block barrier)
        if (i + 1 < vend) {
          const int4 pr4 = s.pr[i + 1];
          const int4 dv4 = s.dv[i + 1];
          const int pn[kMaxPreds] = {pr4.x, pr4.y, pr4.z, pr4.w};
          const int dn[kMaxPreds] = {dv4.x, dv4.y, dv4.z, dv4.w};
#pragma unroll
          for (int k = 0; k < kMaxPreds; ++k) {
            if (pn[k] >= 0 && pn[k] <= v - 1)
              stage_window(buf, k, pw, hH, hplane, pn[k], dn[k], stride, bc,
                           slice);
          }
        }
      }

      // pass 2: E1, E2, H and the move; the extend bits from cell b - 1
      int q1 = imax(cw1, x1), q2 = imax(cw2, x2);
      int pE1 = kNeg, pE2 = kNeg, fE1 = kNeg, fE2 = kNeg;
#pragma unroll
      for (int c = 0; c < nc; ++c) {
        const int b = b0 + c;
        const int hh = h0[c];
        int cd = code[c];
        int Hc, E1, E2;
        cell_pass2_live(hh, cd, q1, q2, b, g, Hc, E1, E2);
        if (c == 0) {
          fE1 = E1;
          fE2 = E2;
        } else {
          cd |= ext_bits(E1, E2, pE1, pE2, g);
        }
        q1 = imax(q1, hh + g.e1 * b);
        q2 = imax(q2, hh + g.e2 * b);
        pE1 = E1;
        pE2 = E2;
        code[c] = cd;
        pH[c] = Hc;
      }
      int y1 = __shfl_up_sync(kFull, pE1, 1);
      int y2 = __shfl_up_sync(kFull, pE2, 1);
      if (lane == 0) {
        y1 = lE1;
        y2 = lE2;
      }
      code[0] = code[0] | ext_bits(fE1, fE2, y1, y2, g);

      // the live cells' stores (b <= L - off_v, inside the band), the
      // history row, ends
      const size_t row = (pN + v) * B;
      const int bL = L - off_v;
      const int wlive = imin(bL + 1, B);
      if constexpr (kReg) {
        store_cells<C>(H + row, dirs + row, pH.v, code.v, b0, wlive);
        if constexpr (kDag) {
          int* rH = hH + (size_t)v * stride;
          if (b0 + C <= wlive) {
            store_ints<C>(rH + b0, pH.v);
            store_ints<C>(rH + hplane + b0, nF1.v);
            store_ints<C>(rH + 2 * hplane + b0, nF2.v);
          } else {
#pragma unroll
            for (int c = 0; c < C; ++c) {
              if (b0 + c < wlive) {
                rH[b0 + c] = pH[c];
                rH[hplane + b0 + c] = nF1[c];
                rH[2 * hplane + b0 + c] = nF2[c];
              }
            }
          }
        }
      } else {
        for (int c = 0; c < nc && b0 + c < wlive; ++c) {
          H[row + b0 + c] = pH[c];
          dirs[row + b0 + c] = (int16_t)code[c];
          if constexpr (kDag) {
            int* rH = hH + (size_t)v * stride + b0 + c;
            rH[0] = pH[c];
            rH[hplane] = nF1[c];
            rH[2 * hplane] = nF2[c];
          }
        }
      }
      if (bL >= 0 && bL < B) {
#pragma unroll
        for (int c = 0; c < nc; ++c)
          if (b0 + c == bL) ends[pN + v] = pH[c];
      } else if (G == 0) {
        ends[pN + v] = kNeg;
      }
#pragma unroll
      for (int c = 0; c < nc; ++c) {
        pF1[c] = nF1[c];
        pF2[c] = nF2[c];
      }
      off_prev = off_v;
    }
  }
  // no CTA leaves while another may still push into its shared memory
  cl.sync();
}

// ------------------------------------------------------------ linear

struct LinearSmem {
  int base[kNodeTile];          // base << 1 | source
  int4 pr[kNodeTile];           // predecessor slots (-1: NEG rows)
  int pub[2][kMaxWarps];        // each warp's total of h0 + gap j
  int tot[2][kClusterMax];      // each earlier CTA's total (pushed)
};

// poa_linear_cluster_kernel<C, kReg, kThreads>: the one problem's live
// columns [0, L + 1) over one cluster, C cells a lane in registers (kReg)
// or `cells` in `scratch` (kLinearPlanes, lanes * cells); rows of stride
// Lq + 1.
template <int C, bool kReg, int kThreads>
__global__ void __launch_bounds__(kThreads)
poa_linear_cluster_kernel(const uint8_t* __restrict__ bases,
                          const int* __restrict__ preds,
                          const uint8_t* __restrict__ q, int n, int Lq,
                          int L, int cells, int gap, int match, int mismatch,
                          int* H, uint8_t* __restrict__ dirs,
                          int* __restrict__ ends, int* scratch) {
  constexpr int K = C;                // cells a chunk of pass 1
  cg::cluster_group cl = cg::this_cluster();
  __shared__ LinearSmem s;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int T = blockDim.x;
  const int nw = T >> 5;
  const int rank = (int)cl.block_rank();
  const int ctas = (int)cl.num_blocks();
  const int nc = kReg ? C : cells;
  const int lanes = ctas * T;
  const int G = rank * T + t;
  const int b0 = G * nc;              // the lane's first column
  const int bw = (G - lane) * nc;     // its warp's
  const size_t W = (size_t)Lq + 1;    // row stride
  Cells<C, kReg, int> pH, h0, code;
  if constexpr (!kReg) {
    const size_t pl = (size_t)lanes * nc;
    int* base = scratch + G;
    pH.bind(base, lanes);
    h0.bind(base + pl, lanes);
    code.bind(base + 2 * pl, lanes);
  }
  // the lane's query codes (the same columns at every node): registers,
  // or read at each node in the global-scratch instance
  int qc[kReg ? C : 1];
  if constexpr (kReg) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = b0 + c;
      qc[c] = j >= 1 && j <= L ? q[j - 1] : 5;
    }
  }
#pragma unroll
  for (int c = 0; c < nc; ++c) pH[c] = kNeg;
  int xl = kNeg;    // the previous row's cell left of the warp's first
  cl.sync();

  for (int v0 = 0; v0 < n; v0 += kNodeTile) {
    __syncthreads();
    for (int i = t; i < kNodeTile; i += T) {
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
      s.base[i] = w;
      s.pr[i] = pr;
    }
    __syncthreads();
    const int vend = imin(kNodeTile, n - v0);
    for (int i = 0; i < vend; ++i) {
      const int v = v0 + i;
      const int par = v & 1;
      const int wd = s.base[i];
      const int4 pr4 = s.pr[i];
      const bool src = wd & 1;
      const int base = wd >> 1;
      const int prk[kMaxPreds] = {pr4.x, pr4.y, pr4.z, pr4.w};
      // the previous row's cell left of the lane's first cell
      int hl = __shfl_up_sync(kFull, pH[nc - 1], 1);
      if (lane == 0) hl = xl;
      // the lowest slot that reads NEG rows stands for every such slot; a
      // source's slot 0 reads the virtual start row -gap j
      int kmin = kMaxPreds;
#pragma unroll
      for (int k = kMaxPreds - 1; k >= 0; --k)
        if (prk[k] < 0 && !(src && k == 0)) kmin = k;
      // pass 1, by chunks of K cells (the lane's C in registers): each
      // slot's cells of a chunk are read together, then used
      int agg = INT_MIN;
      for (int c0 = 0; c0 < nc; c0 += K) {
        int sc[K], cd[K], cg[K];   // scores; packed diag and deletion maxima
#pragma unroll
        for (int x = 0; x < K; ++x) {
          const int j = b0 + c0 + x;
          int qj;
          if constexpr (kReg) {
            qj = qc[c0 + x];
          } else {
            qj = j >= 1 && j <= L ? q[j - 1] : 5;
          }
          sc[x] = qj == base ? match : mismatch;
          if (kmin < kMaxPreds) {
            cd[x] = pack(j > 0 ? kNeg + sc[x] : kNeg, kmin);
            cg[x] = pack(kNeg - gap, kmin);
          } else {
            cd[x] = cg[x] = INT_MIN;
          }
          if (src) {
            cd[x] = imax(cd[x],
                         pack(j > 0 ? -gap * (j - 1) + sc[x] : kNeg, 0));
            cg[x] = imax(cg[x], pack(-gap * j - gap, 0));
          }
        }
#pragma unroll
        for (int k = 0; k < kMaxPreds; ++k) {
          const int pk = prk[k];
          if (pk < 0) continue;
          // the predecessor row at the chunk's columns - 1 .. + K - 1
          int hw[K + 1];
          if (pk == v - 1) {
            hw[0] = c0 > 0 ? pH[c0 - 1] : hl;
#pragma unroll
            for (int x = 0; x < K; ++x)
              hw[x + 1] = kReg || c0 + x < nc ? pH[c0 + x] : kNeg;
          } else {
            const int* prow = H + (size_t)pk * W;
#pragma unroll
            for (int y = 0; y <= K; ++y) {
              const int j = b0 + c0 - 1 + y;
              hw[y] = j >= 0 && j <= L ? prow[j] : kNeg;
            }
          }
#pragma unroll
          for (int x = 0; x < K; ++x) {
            const int j = b0 + c0 + x;
            cd[x] = imax(cd[x], pack(j > 0 ? hw[x] + sc[x] : kNeg, k));
            cg[x] = imax(cg[x], pack(hw[x + 1] - gap, k));
          }
        }
#pragma unroll
        for (int x = 0; x < K; ++x) {
          const int c = c0 + x;
          if (!kReg && c >= nc) break;
          const int bd = cd[x] >> 2, bl = cg[x] >> 2;
          const int hh = imax(bd, bl);
          h0[c] = hh;
          code[c] = bd >= bl ? ((3 - (cd[x] & 3)) << 2)
                             : (1 | ((3 - (cg[x] & 3)) << 2));
          agg = imax(agg, hh + gap * (b0 + c));
        }
      }
      // the row's exchange: the warp's scan, its total, the block barrier,
      // warp 0's pushes of the CTA's total, the cluster barrier
      int r = agg;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(kFull, r, o);
        if (lane >= o) r = imax(r, x);
      }
      int x = __shfl_up_sync(kFull, r, 1);
      if (lane == 0) x = INT_MIN;
      if (lane == 31) s.pub[par][warp] = r;
      __syncthreads();
      if (warp == 0) {
        const int tt = warp_max(lane < nw ? s.pub[par][lane] : INT_MIN);
        if (lane < ctas && lane > rank)
          *cl.map_shared_rank(&s.tot[par][rank], lane) = tt;
      }
      // release / acquire: the pushes above (and every CTA's H rows of the
      // nodes before) are visible after it
      cl.sync();
      int cw = INT_MIN;
      for (int u = 0; u < rank; ++u) cw = imax(cw, s.tot[par][u]);
      for (int u = 0; u < warp; ++u) cw = imax(cw, s.pub[par][u]);
      // the cell left of the warp's first, final, for the next node
      if (bw > 0) xl = cw - gap * (bw - 1);
      // pass 2: the insertion chain y[j] = max_{k <= j} h0[k] + gap k
      // minus gap j
      int rr = imax(cw, x);
#pragma unroll
      for (int c = 0; c < nc; ++c) {
        const int j = b0 + c;
        const int hh = h0[c];
        rr = imax(rr, hh + gap * j);
        const int y = rr - gap * j;
        if (y != hh) code[c] = (code[c] & ~3) | 2;
        pH[c] = y;
      }
      int* hrow = H + (size_t)v * W;
      uint8_t* drow = dirs + (size_t)v * W;
      const size_t at = (size_t)v * W + b0;
      if (kReg && b0 + nc - 1 <= L && (at & 3) == 0) {
        // vectors where the row lets them align: 16 bytes of H and 4 of
        // codes every 4 cells
#pragma unroll
        for (int c = 0; c < nc; c += 4) {
          *reinterpret_cast<int4*>(hrow + b0 + c) =
              make_int4(pH[c], pH[c + 1], pH[c + 2], pH[c + 3]);
          *reinterpret_cast<unsigned*>(drow + b0 + c) =
              (unsigned)(code[c] & 0xff) |
              ((unsigned)(code[c + 1] & 0xff) << 8) |
              ((unsigned)(code[c + 2] & 0xff) << 16) |
              ((unsigned)(code[c + 3] & 0xff) << 24);
        }
      } else {
#pragma unroll
        for (int c = 0; c < nc; ++c) {
          if (b0 + c <= L) {
            hrow[b0 + c] = pH[c];
            drow[b0 + c] = (uint8_t)code[c];
          }
        }
      }
      if (L == Lq && b0 <= Lq && Lq < b0 + nc) {
#pragma unroll
        for (int c = 0; c < nc; ++c)
          if (b0 + c == Lq) ends[v] = pH[c];
      }
    }
  }
  cl.sync();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The cluster a wide launch takes for max_live W (poa_shape), at most
// max_ctas CTAs when it is above 0: out[0..4] = CTAs, threads a CTA,
// cells a lane, 1 where a lane's cells live in registers, and the int32
// words of global scratch a problem's lanes need (0 in registers; linear:
// poa_linear's kernel, else poa_affine's and poa_chain's).
int poa_cluster_shape(int W, int max_ctas, int linear, void* out) {
  if (W < 1) return (int)cudaErrorInvalidValue;
  const PoaShape ps = poa_shape(W, max_ctas);
  const ClusterShape& sh = ps.sh;
  const bool reg = ps.reg;
  long long* o = static_cast<long long*>(out);
  o[0] = sh.ctas;
  o[1] = sh.threads;
  o[2] = sh.cells;
  o[3] = reg;
  o[4] = reg ? 0
             : (long long)(linear ? kLinearPlanes : kAffinePlanes) * sh.ctas *
                   sh.threads * sh.cells;
  return 0;
}

// The wide route of poa_affine (chain 0: any DAG, history rows in hist,
// (P, 3, N, stride)) and poa_chain (chain 1, no history): one cluster a
// problem on the live rows, whose widest is W = max_live.  `scratch`
// (poa_cluster_shape's words a problem) is needed where the lanes' cells
// outgrow registers.
int poa_wide_launch(const void* bases, const void* preds, const void* off,
                    const void* q_ext, const void* l_len, const void* n_nodes,
                    const void* submat, int P, int N, int Lq, int B, int W,
                    int max_ctas, int chain, int stride, int o1, int e1,
                    int o2, int e2, void* H, void* dirs, void* ends,
                    void* hist, void* scratch, void* stream) {
  if (P <= 0 || N <= 0) return 0;
  if (W < 1 || W > B) return (int)cudaErrorInvalidValue;
  const PoaShape ps = poa_shape(W, max_ctas);
  const ClusterShape& sh = ps.sh;
  const bool reg = ps.reg;
  if (!reg && scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (!chain && (hist == nullptr || stride < W || stride % 4 != 0))
    return (int)cudaErrorInvalidValue;
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
  auto* sc = static_cast<int*>(scratch);
  // the DAG register instance's staged windows (stage_window)
  const int slice = sh.threads * sh.cells;
  const size_t staged = (size_t)kMaxPreds * 3 * (slice + slice / 32 + 1) * 4;
#define POA_WIDE_RUN(REG, DAG, THREADS)                                      \
  {                                                                          \
    static size_t allowed = 0;                                               \
    return (int)launch_cluster(                                              \
        poa_cluster_kernel<kCells, REG, DAG, THREADS>, sh, P,                \
        REG && DAG ? staged : 0, &allowed, st, bs, pr, of, q, ll, nn, sm, N, \
        Lq, B, stride, sh.cells, g, h, d, e, hs, sc);                        \
  }
  if (reg) {
    if (chain) POA_WIDE_RUN(true, false, kRegThreads)
    POA_WIDE_RUN(true, true, kRegThreads)
  }
  if (chain) POA_WIDE_RUN(false, false, kScratchThreads)
  POA_WIDE_RUN(false, true, kScratchThreads)
#undef POA_WIDE_RUN
}

// The wide route of poa_linear: the live cells (nodes v < n, columns
// j <= L) of one problem whose rows have stride Lq + 1, over one cluster.
int poa_linear_wide_launch(const void* bases, const void* preds,
                           const void* q, int n, int Lq, int L, int max_ctas,
                           int gap, int match, int mismatch, void* H,
                           void* dirs, void* ends, void* scratch,
                           void* stream) {
  if (n <= 0) return 0;
  if (L < 0 || L > Lq) return (int)cudaErrorInvalidValue;
  const PoaShape ps = poa_shape(L + 1, max_ctas);
  const ClusterShape& sh = ps.sh;
  const bool reg = ps.reg;
  if (!reg && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* bs = static_cast<const uint8_t*>(bases);
  const auto* pr = static_cast<const int*>(preds);
  const auto* qq = static_cast<const uint8_t*>(q);
  auto* h = static_cast<int*>(H);
  auto* d = static_cast<uint8_t*>(dirs);
  auto* e = static_cast<int*>(ends);
  auto* sc = static_cast<int*>(scratch);
  if (reg) {
    static size_t allowed = 48 * 1024;
    return (int)launch_cluster(
        poa_linear_cluster_kernel<kCells, true, kRegThreads>, sh, 1,
        0, &allowed, st, bs, pr, qq, n, Lq, L, sh.cells, gap, match,
        mismatch, h, d, e, sc);
  }
  static size_t allowed = 48 * 1024;
  return (int)launch_cluster(
      poa_linear_cluster_kernel<kCells, false, kScratchThreads>, sh, 1,
      0, &allowed, st, bs, pr, qq, n, Lq, L, sh.cells, gap, match, mismatch,
      h, d, e, sc);
}

}  // extern "C"
