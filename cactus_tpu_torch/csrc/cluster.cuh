// What the cluster sources (pairhmm.cu, pairhmm5.cu and poa_cluster.cu)
// share: the pair-HMMs' live window of a banded row, its state rows'
// layout and a lane's window cells in registers or in global scratch, and
// for all three the launch of one thread-block cluster a pair (a POA
// problem) once the card has said it can schedule it.  Each source
// includes it into its own anonymous namespace; ops/cuda_build.py hashes
// every csrc/*.cuh with each source, so an edit here rebuilds them all.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <mutex>

namespace {

// window cell k -> word of a state row: one pad word every 32 cells
__device__ __forceinline__ int pix(int k) { return k + (k >> 5); }

__host__ __device__ inline int row_words(int cells) {
  return cells + (cells >> 5) + 1;
}

// the live window of row i: first column jlo and width (0: none)
struct Window {
  int jlo, wd;
};

__device__ __forceinline__ Window window(int i, int n, int lo, int B) {
  const int jlo = max(0, i + lo);
  const int jhi = min(n, i + lo + B - 1);
  return Window{jlo, max(0, jhi - jlo + 1)};
}

// A lane's cells of the row being computed (V: float for the pair-HMMs'
// windows, int for the POA rows): in registers (C of them), or, for the
// global-scratch instance, in the pair's (problem's) scratch at cell c of
// lane L -> c * lanes + L.
template <int C, bool kReg, typename V = float>
struct Cells {
  V v[C];
  __device__ __forceinline__ V& operator[](int c) { return v[c]; }
  __device__ __forceinline__ void bind(V*, int) {}
};

template <int C, typename V>
struct Cells<C, false, V> {
  V* p;
  int stride;
  __device__ __forceinline__ V& operator[](int c) {
    return p[(size_t)c * stride];
  }
  __device__ __forceinline__ void bind(V* base, int s) {
    p = base;
    stride = s;
  }
};

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

// A cluster launch: CTAs a cluster (one cluster a pair), threads a CTA,
// window cells a lane, and whether the state rows live in the CTAs'
// shared memory (else in the pair's global scratch).
struct ClusterShape {
  int ctas, threads, cells, smem;
};

// Whether the card schedules a cluster of this shape, asked once per
// kernel and shape (cudaOccupancyMaxActiveClusters).
cudaError_t cluster_fits(const void* kernel, const cudaLaunchConfig_t& cfg) {
  struct Seen {
    const void* kernel;
    unsigned ctas, threads;
    size_t smem;
    int clusters;
  };
  static std::mutex mu;
  static Seen seen[64];
  static int n_seen = 0;
  const unsigned ctas = cfg.attrs[0].val.clusterDim.x;
  std::lock_guard<std::mutex> lock(mu);
  for (int k = 0; k < n_seen; ++k) {
    const Seen& s = seen[k];
    if (s.kernel == kernel && s.ctas == ctas && s.threads == cfg.blockDim.x &&
        s.smem == cfg.dynamicSmemBytes)
      return s.clusters > 0 ? cudaSuccess : cudaErrorLaunchOutOfResources;
  }
  int clusters = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (n_seen < 64)
    seen[n_seen++] = Seen{kernel, ctas, cfg.blockDim.x, cfg.dynamicSmemBytes,
                          clusters};
  return clusters > 0 ? cudaSuccess : cudaErrorLaunchOutOfResources;
}

// P clusters of sh.ctas CTAs (one a pair) on `stream`; an error where the
// card cannot schedule the cluster.
template <typename... Params, typename... Actual>
cudaError_t launch_cluster(void (*kernel)(Params...), const ClusterShape& sh,
                           int P, size_t smem, size_t* allowed,
                           cudaStream_t stream, Actual... args) {
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  if (sh.ctas > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sh.ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)P * sh.ctas);
  cfg.blockDim = dim3(sh.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cluster_fits(reinterpret_cast<const void*>(kernel), cfg);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
