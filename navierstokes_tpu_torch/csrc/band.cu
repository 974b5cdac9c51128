// Circulant band kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Both kernels contract a CirculantBand row by row,
//
//     y[b, i] = sum_k band[k, i] * x[b, (i + off_k) mod N],
//
// through the one __device__ function band_row() below.
//
// A. circulant_apply_kernel replaces the Pallas kernel
//    navierstokes_tpu/assembly/pallas_band.py::circulant_apply
//    (_build_call / _make_kernel / _band_contract).  One thread computes
//    one output element, grid-stride over B*N.
//    Bound: device-memory bandwidth.  Each output reads K band values and
//    K operand values and writes one: (K + 2) streams of N elements, with
//    neighbouring threads on neighbouring addresses for every stream (the
//    window of offset k for threads i..i+31 is x[i+o_k .. i+31+o_k]).  The
//    operand windows overlap, so after the first offset they come from
//    L1/L2; at 128^2 the whole working set (velocity band 23 x 65,536 x
//    4 B = 6 MB in f32) fits in the 50 MB L2.  The TPU kernel's 128-lane
//    residue grouping and VMEM budget are TPU artefacts and are not
//    carried over: any N and any batch B >= 1 work here.
//
// B. circulant_pcg_kernel replaces the Pallas kernel
//    navierstokes_tpu/assembly/pallas_band.py::circulant_pcg
//    (_build_cg_call / _make_cg_kernel): a fixed number of Jacobi-PCG
//    iterations on  A'v = m*A(m*v) + (1-m)*v  with r <- m*r and an optional
//    mean subtraction, returning (x, r).
//    Bound: on the TPU the whole solve ran in one program to save ~60
//    launches per solve; on this card the same holds, and what bounds a
//    solve at these sizes is latency -- each iteration needs two global
//    dot products.  The design is one persistent cooperative launch
//    (cudaLaunchCooperativeKernel): the grid is sized to be co-resident,
//    and cooperative_groups::this_grid().sync() separates the phases of an
//    iteration, so a solve costs one launch and 3 grid barriers per
//    iteration (4 with the mean subtraction) instead of ~8 launches per
//    iteration.  The state vectors (x, r, p, Ap) live in device memory
//    (L2-resident at these sizes).
//    Determinism: every block writes its partial sum into its own slot of
//    a scratch buffer and, after the barrier, every block sums all the
//    slots in the same fixed order, so every block computes bit-identical
//    alpha and beta.  No atomics.  The three reductions of an iteration use
//    three different slot rows, so a fast block cannot overwrite a row
//    that a slow block is still reading.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOffsets = 96;  // build_operator's circulant_cap

// Row i of the band contraction of one plane x (length n); with m != null
// the operand is m * x (the masked operator's inner product).  The
// offsets lie in [0, n), so one conditional subtraction wraps them.
template <typename T>
__device__ __forceinline__ T band_row(const T* __restrict__ band,
                                      const int* offs, int K, const T* x,
                                      const T* m, long long n, long long i) {
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    long long j = i + offs[k];
    j -= (j >= n) ? n : 0;
    const T xj = m ? m[j] * x[j] : x[j];
    acc += band[(long long)k * n + i] * xj;
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
circulant_apply_kernel(const T* __restrict__ band,
                       const int* __restrict__ offs_g, int K,
                       const T* __restrict__ x, T* __restrict__ y,
                       long long n, long long total) {
  __shared__ int offs[kMaxOffsets];
  for (int k = threadIdx.x; k < K; k += blockDim.x) offs[k] = offs_g[k];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long b = t / n;
    const long long i = t - b * n;
    y[t] = band_row<T>(band, offs, K, x + b * n, nullptr, n, i);
  }
}

template <typename T>
struct PcgArgs {
  const T* band;
  const int* offs;
  int K;
  long long n;      // plane length N
  long long total;  // B * N
  const T* b;
  const T* x0;
  const T* invd;
  long long invd_stride;  // 0: one (N,) row shared by all planes
  const T* mask;          // null: no mask (maskv == 1.0)
  long long mask_stride;
  int iters;
  int meanfree;
  T* x;
  T* r;
  T* p;
  T* ap;
  T* partial;  // 3 rows of gridDim.x block partials
};

// |v| > 0, false for NaN (the guard of jnp.where(jnp.abs(v) > 0, ...)).
template <typename T>
__device__ __forceinline__ bool nonzero(T v) {
  return v > T(0) || v < T(0);
}

// Sum of v over the block in a fixed order (valid in thread 0).
template <typename T>
__device__ T block_sum(T v, T* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T s = T(0);
  if (warp == 0) {
    s = lane < (int)(blockDim.x >> 5) ? red[lane] : T(0);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  }
  __syncthreads();
  return s;
}

// Store this block's partial into row[blockIdx.x], barrier the grid, and
// return the sum of the whole row -- the same value, bit for bit, in every
// thread of every block.
template <typename T>
__device__ T grid_sum(T v, T* row, T* red, T* bcast, cg::grid_group& grid) {
  const T s = block_sum(v, red);
  if (threadIdx.x == 0) row[blockIdx.x] = s;
  grid.sync();
  T acc = T(0);
  for (int g = threadIdx.x; g < (int)gridDim.x; g += blockDim.x)
    acc += row[g];
  const T tot = block_sum(acc, red);
  if (threadIdx.x == 0) *bcast = tot;
  __syncthreads();
  const T out = *bcast;
  __syncthreads();
  return out;
}

template <typename T>
__device__ __forceinline__ T masked_matvec(const PcgArgs<T>& a,
                                           const int* offs, const T* v,
                                           long long b, long long i) {
  const T* vb = v + b * a.n;
  if (a.mask) {
    const T* mb = a.mask + b * a.mask_stride;
    const T w = band_row<T>(a.band, offs, a.K, vb, mb, a.n, i);
    const T mi = mb[i];
    return mi * w + (T(1) - mi) * vb[i];
  }
  return band_row<T>(a.band, offs, a.K, vb, nullptr, a.n, i);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
circulant_pcg_kernel(PcgArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int offs[kMaxOffsets];
  __shared__ T red[kThreads / 32];
  __shared__ T bcast;
  for (int k = threadIdx.x; k < a.K; k += blockDim.x) offs[k] = a.offs[k];
  __syncthreads();

  const long long n = a.n, total = a.total;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  T* row_pap = a.partial;
  T* row_sum = a.partial + gridDim.x;
  T* row_rz = a.partial + 2 * gridDim.x;
  const T inv_total = T(1) / T(total);

  // r0 = project(b - A' x0), x = x0
  T part = T(0);
  for (long long t = start; t < total; t += stride) {
    const long long b = t / n, i = t - b * n;
    T ri = a.b[t] - masked_matvec(a, offs, a.x0, b, i);
    if (a.mask) ri *= a.mask[b * a.mask_stride + i];
    a.r[t] = ri;
    a.x[t] = a.x0[t];
    part += ri;
  }
  T mean = T(0);
  if (a.meanfree) mean = grid_sum(part, row_sum, red, &bcast, grid) * inv_total;
  // z0 = invd * r0, p = z0
  part = T(0);
  for (long long t = start; t < total; t += stride) {
    const long long b = t / n, i = t - b * n;
    T ri = a.r[t];
    if (a.meanfree) {
      ri -= mean;
      a.r[t] = ri;
    }
    const T zi = a.invd[b * a.invd_stride + i] * ri;
    a.p[t] = zi;
    part += ri * zi;
  }
  T rz = grid_sum(part, row_rz, red, &bcast, grid);

  for (int it = 0; it < a.iters; ++it) {
    // (1) Ap and p.Ap
    part = T(0);
    for (long long t = start; t < total; t += stride) {
      const long long b = t / n, i = t - b * n;
      const T api = masked_matvec(a, offs, a.p, b, i);
      a.ap[t] = api;
      part += a.p[t] * api;
    }
    // (2) alpha
    const T denom = grid_sum(part, row_pap, red, &bcast, grid);
    const T alpha = nonzero(denom) ? rz / denom : T(0);
    // (3) x += alpha p, r <- m (r - alpha Ap); (5) z = invd r, r.z
    T rsum = T(0);
    part = T(0);
    for (long long t = start; t < total; t += stride) {
      const long long b = t / n, i = t - b * n;
      a.x[t] += alpha * a.p[t];
      T ri = a.r[t] - alpha * a.ap[t];
      if (a.mask) ri *= a.mask[b * a.mask_stride + i];
      a.r[t] = ri;
      if (a.meanfree) {
        rsum += ri;
      } else {
        part += ri * (a.invd[b * a.invd_stride + i] * ri);
      }
    }
    if (a.meanfree) {
      // (4) subtract the mean, then (5)
      mean = grid_sum(rsum, row_sum, red, &bcast, grid) * inv_total;
      for (long long t = start; t < total; t += stride) {
        const long long b = t / n, i = t - b * n;
        const T ri = a.r[t] - mean;
        a.r[t] = ri;
        part += ri * (a.invd[b * a.invd_stride + i] * ri);
      }
    }
    // (6) beta
    const T rz_new = grid_sum(part, row_rz, red, &bcast, grid);
    const T beta = nonzero(rz) ? rz_new / rz : T(0);
    // (7) p = z + beta p
    for (long long t = start; t < total; t += stride) {
      const long long b = t / n, i = t - b * n;
      a.p[t] = a.invd[b * a.invd_stride + i] * a.r[t] + beta * a.p[t];
    }
    rz = rz_new;
    // (8) the next matvec reads neighbours of p that other blocks wrote
    grid.sync();
  }
}

template <typename T>
int apply_launch(const T* band, const int* offs, int K, const T* x, T* y,
                 long long n, long long batch, cudaStream_t stream) {
  if (K < 1 || K > kMaxOffsets || n < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  const long long total = n * batch;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride covers rest
  circulant_apply_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      band, offs, K, x, y, n, total);
  return (int)cudaGetLastError();
}

template <typename T>
int pcg_grid(long long total, int* grid) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, circulant_pcg_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const long long need = (total + kThreads - 1) / kThreads;
  long long g = (long long)per_sm * sms;
  if (g > need) g = need;
  *grid = g < 1 ? 1 : (int)g;
  return 0;
}

template <typename T>
int pcg_launch(const T* band, const int* offs, int K, long long n,
               long long batch, const T* b, const T* x0, const T* invd,
               long long invd_stride, const T* mask, long long mask_stride,
               int iters, int meanfree, T* x, T* r, T* p, T* ap, T* partial,
               int grid, cudaStream_t stream) {
  if (K < 1 || K > kMaxOffsets || n < 1 || batch < 1 || iters < 0 ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  PcgArgs<T> a{band, offs,        K,     n,    n * batch, b,        x0,
               invd, invd_stride, mask,  mask_stride, iters, meanfree,
               x,    r,           p,     ap,   partial};
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)circulant_pcg_kernel<T>, dim3(grid), dim3(kThreads), args,
      0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ns_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int ns_circulant_apply_f32(const float* band, const int* offs, int K,
                           const float* x, float* y, long long n,
                           long long batch, void* stream) {
  return apply_launch<float>(band, offs, K, x, y, n, batch,
                             (cudaStream_t)stream);
}

int ns_circulant_apply_f64(const double* band, const int* offs, int K,
                           const double* x, double* y, long long n,
                           long long batch, void* stream) {
  return apply_launch<double>(band, offs, K, x, y, n, batch,
                              (cudaStream_t)stream);
}

int ns_circulant_pcg_grid_f32(long long total, int* grid) {
  return pcg_grid<float>(total, grid);
}

int ns_circulant_pcg_grid_f64(long long total, int* grid) {
  return pcg_grid<double>(total, grid);
}

int ns_circulant_pcg_f32(const float* band, const int* offs, int K,
                         long long n, long long batch, const float* b,
                         const float* x0, const float* invd,
                         long long invd_stride, const float* mask,
                         long long mask_stride, int iters, int meanfree,
                         float* x, float* r, float* p, float* ap,
                         float* partial, int grid, void* stream) {
  return pcg_launch<float>(band, offs, K, n, batch, b, x0, invd, invd_stride,
                           mask, mask_stride, iters, meanfree, x, r, p, ap,
                           partial, grid, (cudaStream_t)stream);
}

int ns_circulant_pcg_f64(const double* band, const int* offs, int K,
                         long long n, long long batch, const double* b,
                         const double* x0, const double* invd,
                         long long invd_stride, const double* mask,
                         long long mask_stride, int iters, int meanfree,
                         double* x, double* r, double* p, double* ap,
                         double* partial, int grid, void* stream) {
  return pcg_launch<double>(band, offs, K, n, batch, b, x0, invd,
                            invd_stride, mask, mask_stride, iters, meanfree,
                            x, r, p, ap, partial, grid, (cudaStream_t)stream);
}

}  // extern "C"
