// Device helpers shared by the kernel sources (band.cu, amg_pcg.cu,
// spectral_modal.cu).  Each source includes this header before its own
// code; everything here is forced inline, so a kernel compiles as if the
// helper were written in its own source.

#pragma once

#include <cuda_runtime.h>

namespace {

// |v| > 0, false for NaN (the guard of torch.where(abs(v) > 0, ...)).
template <typename T>
__device__ __forceinline__ bool nonzero(T v) {
  return v > T(0) || v < T(0);
}

// Round-to-nearest arithmetic that the compiler never contracts to an fma:
// a value recomputed by another thread or CTA gets the owner's bits.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}

template <typename T>
struct PairOf;
template <>
struct PairOf<float> {
  using type = float2;
};
template <>
struct PairOf<double> {
  using type = double2;
};
// (z, p) of one row: a matvec reads both with one load.
template <typename T>
using Pair = typename PairOf<T>::type;

// Sum over a warp, bit-identical in every lane: a butterfly in which two
// partners add the same two values (a + b == b + a exactly).
template <typename T>
__device__ __forceinline__ T warp_total(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// cluster.sync() with the release done by one thread after a block
// barrier: the fence covers every write of the CTA that the block barrier
// ordered before it (shared memory, its own and remote), at about two
// thirds of the cost of a releasing arrive by every thread.
__device__ __forceinline__ void cluster_barrier() {
  __syncthreads();
  if (threadIdx.x == 0) asm volatile("fence.acq_rel.cluster;" ::: "memory");
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// A shared-memory address as the 32-bit operand of PTX.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// An mbarrier that one arrival completes, together with the bytes that
// asynchronous copies or stores announce to it (mbar_expect); mbar_wait
// spins until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

}  // namespace
