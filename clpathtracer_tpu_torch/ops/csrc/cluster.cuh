// Thread-block cluster helpers for the walks that spread one unit of work
// over the C blocks of a cluster: K1, K1', K1's kcap form and K2
// (plist_super.cu: a 512-ray gate or bundle) and the kd walks K3/K4, K5,
// K6a, K6b, K7, K8 and K9 (packet_stream.cu, packet_queue.cu,
// packet_v1.cu, packet_stream2.cu, packet_mxu.cu: a packet tile).
//
// Each block of a cluster owns a disjoint slice of the unit's lanes and
// runs the same unit-uniform control flow (K1's list walk and break, K3's
// stack walk and window survival scans). Every decision of that flow is
// taken from a value reduced over the whole cluster (cluster_reduce), at
// exactly the points where a one-block kernel reduces over its block, so
// every block takes the decision the single block took: the windows
// tested, their order and the stats do not depend on C.
//
// cluster_reduce: min, max or sum of N values per thread over every thread
//   of the cluster. Each warp reduces with shuffles and its lane 0 writes
//   the warp's values into this block's slots; one cluster barrier; then
//   every warp reads all blocks' slots through distributed shared memory
//   (map_shared_rank) and reduces them. The slots alternate between two
//   rounds (parity), so a fast block that writes round i + 2 cannot
//   overwrite a value a slow peer still reads in round i: the barrier of
//   round i + 1 lies between. min and max are exact in any order; the sums
//   are of lane counts (at most 4096), exact in f32.
// cluster_end: the last barrier of a cluster kernel: no block leaves while
//   a peer may still read its shared memory.

#pragma once

#include <cmath>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace clpt {

constexpr int kSlotWarps = 32;  // warps of the largest block (1024 threads)

// Two rounds of slots for N values per warp.
template <int N>
struct ClusterSlots {
  float v[2][kSlotWarps * N];
};

struct MinOp {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};
struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct SumOp {
  __device__ float operator()(float a, float b) const {
    return __fadd_rn(a, b);
  }
};

// Reduce v[0..N) over every thread of the cluster by op; every thread gets
// the results in v. `identity` is op's neutral value. Every thread of every
// block calls it (cluster-uniform). `par`: the thread's round parity, 0 at
// the first call, flipped by each call (every thread makes the same calls).
template <int N, class Op>
__device__ __forceinline__ void cluster_reduce(float* v, ClusterSlots<N>& s,
                                               int& par, Op op,
                                               float identity) {
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i)
    for (int off = 16; off > 0; off >>= 1)
      v[i] = op(v[i], __shfl_xor_sync(0xffffffffu, v[i], off));
  float* mine = s.v[par];
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) mine[(threadIdx.x >> 5) * N + i] = v[i];
  }
  cluster.sync();  // every block's round `par` is written
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = identity;
  const int n = (int)cluster.num_blocks() * nw;
  for (int e = lane; e < n; e += 32) {
    const float* p = cluster.map_shared_rank(mine, e / nw) + (e % nw) * N;
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = op(acc[i], p[i]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    for (int off = 16; off > 0; off >>= 1)
      acc[i] = op(acc[i], __shfl_xor_sync(0xffffffffu, acc[i], off));
    v[i] = acc[i];
  }
  par ^= 1;
}

// This block's rank in its cluster (1-D clusters of consecutive blocks: the
// unit of block b is b / C).
__device__ __forceinline__ int cluster_rank() {
  return (int)cooperative_groups::this_cluster().block_rank();
}

__device__ __forceinline__ void cluster_end() {
  cooperative_groups::this_cluster().sync();
}

// The launch configuration of `blocks` blocks of `threads` in clusters of
// c blocks (blocks a multiple of c), with `smem` bytes of dynamic shared
// memory. attr: storage for the cluster attribute.
inline cudaLaunchConfig_t cluster_config(int c, int blocks, int threads,
                                         size_t smem, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Raise the kernel's dynamic shared memory limit where it needs more than
// the default 48 KB.
template <typename... Params>
cudaError_t allow_smem(void (*kernel)(Params...), size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// Launch `kernel` in clusters of c blocks. Returns the launch's error, else
// cudaGetLastError(): a cluster launch that the card refuses (resources a
// plain launch would accept, a grid not a multiple of c) shows there.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), int c, int blocks, int threads,
                   size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(c, blocks, threads, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The shape of a cluster launch of `kernel`, for the record: out[0] blocks
// per cluster, out[1] threads per block, out[2] the clusters that can be
// resident on the card at once (cudaOccupancyMaxActiveClusters), out[3]
// registers per thread, out[4] static and out[5] dynamic shared memory
// bytes per block. Returns the first CUDA error, else 0.
template <typename... Params>
int cluster_shape(void (*kernel)(Params...), int c, int threads, size_t smem,
                  int* out) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(c, c, threads, smem, nullptr, &attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  out[0] = c;
  out[1] = threads;
  out[2] = n;
  out[3] = fa.numRegs;
  out[4] = (int)fa.sharedSizeBytes;
  out[5] = (int)smem;
  return 0;
}

}  // namespace clpt
