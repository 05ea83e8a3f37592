// Scaffolding shared by the fused-MLP cluster kernels (mlp_bf16_tc.cu,
// mlp_int8.cu): a CTA's column slice of a layer, the checks on a padded
// stack's shapes, and the cluster launch itself (kernel attributes, the
// card's count of resident clusters, cudaLaunchKernelEx). Each source is
// its own library, so the statics below are per kernel.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#define MLP_MAX_LAYERS 16
#define MLP_MAX_CLUSTER 16  // above 8 is a non-portable cluster size

// the units of a layer with np padded columns that CTA `rank` of a C-CTA
// cluster owns: ceil(units / C) consecutive units per CTA
struct Slice {
  int u0;  // first unit
  int nu;  // how many
};
template <int UNIT>
__device__ __forceinline__ Slice slice_of(int np, int rank, int C) {
  const int units = np / UNIT;
  const int per = (units + C - 1) / C;
  Slice s;
  s.u0 = rank * per;
  s.nu = max(0, min(per, units - s.u0));
  return s;
}

// the shapes a launch takes: 1..MLP_MAX_LAYERS layers, clusters of
// 1..MLP_MAX_CLUSTER CTAs, every K a multiple of `kc` and every N of
// `unit`, each K the previous layer's N, the first K covering d_in, and at
// most `max_units` units of a layer per CTA
static bool stack_ok(int n_rows, int n_layers, int d_in, const int* kp, const int* np,
                     int cluster, int kc, int unit, int max_units) {
  if (n_layers < 1 || n_layers > MLP_MAX_LAYERS || n_rows < 0 || d_in < 1 || cluster < 1 ||
      cluster > MLP_MAX_CLUSTER || d_in > kp[0]) {
    return false;
  }
  for (int l = 0; l < n_layers; ++l) {
    if (kp[l] < kc || kp[l] % kc || np[l] < unit || np[l] % unit ||
        (l > 0 && kp[l] != np[l - 1]) || (np[l] / unit + cluster - 1) / cluster > max_units) {
      return false;
    }
  }
  return true;
}

static cudaLaunchConfig_t cluster_config(int threads, int grid, int C, size_t smem,
                                         cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// opt `kernel` into `smem` bytes of dynamic shared memory and into
// non-portable cluster sizes, once per device and size
template <typename Kernel>
static cudaError_t set_cluster_attributes(Kernel kernel, size_t smem) {
  static size_t granted[64];  // per device: the most bytes already set
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && smem <= granted[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess && dev < 64) granted[dev] = smem;
  return e;
}

// how many clusters of `cluster` CTAs of `kernel` with smem_bytes of
// dynamic shared memory each can be resident at once on the current device
// (0: the configuration cannot run); a negative value is -cudaError
template <typename Kernel>
static int max_active_clusters(Kernel kernel, int threads, int cluster, int smem_bytes) {
  cudaError_t e = set_cluster_attributes(kernel, (size_t)smem_bytes);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(threads, cluster, cluster, (size_t)smem_bytes, 0, attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -(int)e;
  }
  return n;
}

// launch `kernel` over ceil(n_rows / rows_per_tile) row tiles, each a
// cluster of `cluster` CTAs, on `stream`; returns cudaGetLastError()
template <typename Kernel, typename... Args>
static cudaError_t launch_clusters(Kernel kernel, int threads, int n_rows, int rows_per_tile,
                                   int cluster, size_t smem, void* stream, Args... args) {
  cudaError_t e = set_cluster_attributes(kernel, smem);
  if (e != cudaSuccess) return e;
  const int tiles = (n_rows + rows_per_tile - 1) / rows_per_tile;
  if (tiles > 0) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(threads, tiles * cluster, cluster, smem,
                                                  static_cast<cudaStream_t>(stream), attr);
    e = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}
