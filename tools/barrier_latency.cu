// Latency of the barriers the PCG kernels of navierstokes_tpu_torch are
// built from, on one card: a thread-block cluster barrier (as
// cooperative_groups' cluster.sync() runs it, with a relaxed arrive, and
// with one thread's cluster fence after a block barrier, which is what
// csrc/band.cu's cluster_barrier() does), a cluster reduction that pushes
// every warp's partial to every CTA, a block barrier, and a cooperative
// grid barrier.  Each figure is the mean over 2,000 back-to-back barriers
// inside one launch.
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//         -o barrier_latency tools/barrier_latency.cu && ./barrier_latency

#include <cooperative_groups.h>
#include <cstdio>

namespace cg = cooperative_groups;

__global__ void cluster_sync(int iters, float* out) {
  cg::cluster_group c = cg::this_cluster();
  for (int i = 0; i < iters; ++i) c.sync();
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = 1;
}

__global__ void cluster_relaxed(int iters, float* out) {
  for (int i = 0; i < iters; ++i) {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  }
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = 1;
}

__global__ void cluster_one_fence(int iters, float* out) {
  for (int i = 0; i < iters; ++i) {
    __syncthreads();
    if (threadIdx.x == 0) asm volatile("fence.acq_rel.cluster;" ::: "memory");
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  }
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = 1;
}

// Every warp pushes its partial to every CTA, cluster.sync(), every warp
// sums all partials from its own shared memory.
__global__ void cluster_reduce(int iters, float* out) {
  cg::cluster_group c = cg::this_cluster();
  __shared__ float red[3][512];
  float v = threadIdx.x;
  const int lane = threadIdx.x & 31, C = c.num_blocks(), W = blockDim.x / 32;
  const int rank = c.block_rank();
  for (int i = 0; i < iters; ++i) {
    const int slot = i % 3;
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
    if (lane < C)
      *c.map_shared_rank(&red[slot][rank * W + (threadIdx.x >> 5)], lane) = v;
    c.sync();
    float acc = 0;
    const int per = C * W / 32;
    for (int e = 0; e < per; ++e) acc += red[slot][lane * per + e];
    for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(~0u, acc, o);
    v = acc * 1e-3f;
  }
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = v;
  c.sync();
}

__global__ void block_sync(int iters, float* out) {
  for (int i = 0; i < iters; ++i) __syncthreads();
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = 1;
}

__global__ void grid_sync(int iters, float* out) {
  cg::grid_group g = cg::this_grid();
  for (int i = 0; i < iters; ++i) g.sync();
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = 1;
}

// Microseconds per barrier: one launch of `iters` barriers, after a short
// warm-up launch.
template <class F>
float per_barrier_us(F launch, int iters) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  launch(10);
  cudaDeviceSynchronize();
  cudaEventRecord(a);
  launch(iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0;
  cudaEventElapsedTime(&ms, a, b);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) printf("error: %s\n", cudaGetErrorString(err));
  return ms * 1e3f / iters;
}

void launch_cluster(const void* kernel, int C, int threads, int iters,
                    float* out) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                       1);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(threads);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  void* args[] = {&iters, &out};
  const cudaError_t err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) printf("launch: %s\n", cudaGetErrorString(err));
}

int main() {
  setvbuf(stdout, NULL, _IONBF, 0);
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("%s, %d SMs; microseconds per barrier\n", prop.name,
         prop.multiProcessorCount);
  float* out;
  cudaMalloc(&out, 16);
  const int n = 2000;
  for (int C : {8, 16}) {
    for (int T : {512, 1024}) {
      printf("cluster of %2d x %4d threads:", C, T);
      printf(" cluster.sync %.3f", per_barrier_us([&](int it) {
               launch_cluster((const void*)cluster_sync, C, T, it, out);
             }, n));
      printf(", relaxed %.3f", per_barrier_us([&](int it) {
               launch_cluster((const void*)cluster_relaxed, C, T, it, out);
             }, n));
      printf(", one fence %.3f", per_barrier_us([&](int it) {
               launch_cluster((const void*)cluster_one_fence, C, T, it, out);
             }, n));
      if (C * T / 32 <= 512)
        printf(", reduction %.3f", per_barrier_us([&](int it) {
                 launch_cluster((const void*)cluster_reduce, C, T, it, out);
               }, n));
      printf("\n");
    }
  }
  for (int T : {512, 1024})
    printf("block of %4d threads: __syncthreads %.3f\n", T,
           per_barrier_us([&](int it) { block_sync<<<1, T>>>(it, out); }, n));
  for (int G : {16, 64, 128, 132}) {
    printf("cooperative grid of %3d x 1024 threads: grid.sync %.3f\n", G,
           per_barrier_us([&](int it) {
             void* args[] = {&it, &out};
             cudaLaunchCooperativeKernel((const void*)grid_sync, dim3(G),
                                         dim3(1024), args, 0, 0);
           }, n));
  }
  cudaFree(out);
  return 0;
}
