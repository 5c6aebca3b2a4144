// What the POA sources (poa.cu: the team kernels; poa_cluster.cu: the
// wide route's thread-block clusters) share: the contract's constants,
// the convex gaps' virtual start row, a cell's packed first-maximum
// candidates and its two passes, and a lane's stores of live cells.
// Each source includes it into its own anonymous namespace;
// ops/cuda_build.py hashes every csrc/*.cuh with each source, so an edit
// here rebuilds both.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kNeg = -(1 << 28);   // poa.py NEG
constexpr int kMaxPreds = 4;       // poa.py MAX_PREDS
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


__device__ __forceinline__ int ext_bits(int E1, int E2, int pE1, int pE2,
                                        const Gaps& g) {
  return ((E1 == pE1 - g.e1) ? 2048 : 0) | ((E2 == pE2 - g.e2) ? 4096 : 0);
}

// Pass 1 of a cell from packed candidates.  A candidate is
// value * 4 + 3 - slot, so one integer max keeps the larger value and, on
// a tie, the lower slot: the contract's first maximum over slots 0..3.
// Opens (H - o - e) and extends (F - e) are kept apart, since opens come
// first in the contract's order; diag is Hd + s.  Values stay within
// 2^29 of 0 (H >= NEG on every cell a live cell reads, F >= NEG - o - e),
// so the packed ints do not overflow there.  The kernels keep no NEG
// mask past the query: such cells are not live and no live cell reads
// them (see poa.cu's header), so pass 1 and 2 skip the mask.
struct Cands {
  int o1, o2, x1, x2, d;
};

__device__ __forceinline__ int pack(int v, int k) { return v * 4 + 3 - k; }

// the empty slot k (NEG rows): of equal empty slots only the lowest can
// be a first maximum, so it stands for them all
__device__ __forceinline__ void cands_empty(Cands& c, int k, int s,
                                            const Gaps& g) {
  c.o1 = pack(kNeg - g.o1 - g.e1, k);
  c.o2 = pack(kNeg - g.o2 - g.e2, k);
  c.x1 = pack(kNeg - g.e1, k);
  c.x2 = pack(kNeg - g.e2, k);
  c.d = pack(kNeg + s, k);
}

__device__ __forceinline__ void cands_none(Cands& c) {
  c.o1 = c.o2 = c.x1 = c.x2 = c.d = INT_MIN;
}

// slot k's predecessor cells: H and F at the cell's column, H left of it
__device__ __forceinline__ void cands_slot(Cands& c, int k, int H, int F1,
                                           int F2, int Hd, int s,
                                           const Gaps& g) {
  c.o1 = imax(c.o1, pack(H - g.o1 - g.e1, k));
  c.o2 = imax(c.o2, pack(H - g.o2 - g.e2, k));
  c.x1 = imax(c.x1, pack(F1 - g.e1, k));
  c.x2 = imax(c.x2, pack(F2 - g.e2, k));
  c.d = imax(c.d, pack(Hd + s, k));
}

// h0, F1, F2 and the direction code without its E bits: bits 0-2 hold
// the first of (diag, F1, F2) equal to h0, the move whenever H == h0
__device__ __forceinline__ void cands_cell(const Cands& c, int& h0, int& F1,
                                           int& F2, int& code) {
  const bool open1 = (c.o1 >> 2) >= (c.x1 >> 2);
  const bool open2 = (c.o2 >> 2) >= (c.x2 >> 2);
  const int p1 = open1 ? c.o1 : c.x1;
  const int p2 = open2 ? c.o2 : c.x2;
  F1 = p1 >> 2;
  F2 = p2 >> 2;
  const int diag = c.d >> 2;
  h0 = imax(diag, imax(F1, F2));
  const int move = diag == h0 ? 0 : (F1 == h0 ? 1 : 2);
  code = move | ((3 - (c.d & 3)) << 3) | ((3 - (p1 & 3)) << 5) |
         (open1 ? 0 : 128) | ((3 - (p2 & 3)) << 8) | (open2 ? 0 : 1024);
}

// Pass 2 of a cell: r1/r2 are the exclusive prefix maxima of Z_k before
// cell b.  Returns H and E1/E2, and completes the move (no mask past the
// query: such cells are not live)
__device__ __forceinline__ void cell_pass2_live(int h0, int& code, int r1,
                                                int r2, int b, const Gaps& g,
                                                int& H, int& E1, int& E2) {
  E1 = imax(kNeg, r1 - g.o1 - g.e1 * b);
  E2 = imax(kNeg, r2 - g.o2 - g.e2 * b);
  H = imax(h0, imax(E1, E2));
  if (H != h0) code = (code & ~7) | (H == E1 ? 3 : 4);
}

// H and the E states of an edge cell from what its warp (or CTA)
// published before the node's barrier: the exclusive prefix maxima r1/r2
// before cell b and its pass-1 h0.
__device__ __forceinline__ void edge_cell(int h0, int r1, int r2, int b,
                                          const Gaps& g, int& H, int& E1,
                                          int& E2) {
  int code = 0;
  cell_pass2_live(h0, code, r1, r2, b, g, H, E1, E2);
}

// A lane's C ints as one or two vector stores (C = 2, 4 or 8; dst and the
// lane's first cell aligned to 4 C bytes).
template <int C>
__device__ __forceinline__ void store_ints(int* dst, const int (&x)[C]) {
  if constexpr (C == 2) {
    *reinterpret_cast<int2*>(dst) = make_int2(x[0], x[1]);
  } else {
#pragma unroll
    for (int c = 0; c < C; c += 4)
      *reinterpret_cast<int4*>(dst + c) =
          make_int4(x[c], x[c + 1], x[c + 2], x[c + 3]);
  }
}

// H and dirs of one problem's lane cells on the live cells only
// (b <= L - off_v, wlive = L - off_v + 1), as vector stores when the
// lane's cells are all live.
template <int C>
__device__ __forceinline__ void store_cells(int* hrow, int16_t* drow,
                                            const int (&Hc)[C],
                                            const int (&code)[C], int b0,
                                            int wlive) {
  if (b0 + C <= wlive) {
    store_ints<C>(hrow + b0, Hc);
    int w[C / 2];
#pragma unroll
    for (int c = 0; c < C; c += 2)
      w[c / 2] = (int)((unsigned)(uint16_t)code[c] |
                       ((unsigned)(uint16_t)code[c + 1] << 16));
    if constexpr (C == 2) {
      *reinterpret_cast<int*>(drow + b0) = w[0];
    } else {
      store_ints<C / 2>(reinterpret_cast<int*>(drow + b0), w);
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (b0 + c < wlive) {
        hrow[b0 + c] = Hc[c];
        drow[b0 + c] = (int16_t)code[c];
      }
    }
  }
}

}  // namespace
