// The per-mode work of the spectral projection step in three launches, for
// Hopper (sm_90a), bound to Python with ctypes (structured/cuda_modal.py).
// Built into the kernel library with the other sources (cudalib.py).
//
// structured/spectral.py::_modal_update advances every Fourier mode of the
// periodic box on its own, from the split-complex (re, im) blocks that
// SpectralOperators holds per mode: the mass symbol M and the eigenbasis P
// (NB x NB, NB = 2^dim node classes), the gradient G and divergence D
// couplings (NB x d), the eigenvalues lam (NB) and the P1 Laplacian's
// pseudo-inverse Linv (a scalar).  With c1 = -(a1/k), c2 = -(a2/k):
//
//   helmholtz:   Bh = M (c1 Uh + c2 Uh_old) - Ch - G Ph
//                U* = P diag(1 / (a0/k + nu lam)) P^H Bh
//   poisson:     Phi = Linv (a0/k) (D . U*)
//   correction:  Uh_new = U* - (k/a0) P P^H (G Phi),  Ph_new = Ph + Phi,
//                Ph_new of mode 0 zeroed where the arrays hold that mode.
//
// It replaces no Pallas kernel: the JAX package leaves these block products
// to XLA.  Eager torch ran each product as a broadcast multiply and a sum
// over a (modes, NB, NB, d) temporary: at 48^3 (110,592 modes, f32) 84.9 MB
// written and read again per real product, 24 of them a step.
//
// Bounds: each per-mode array read once and each output written once at
// 3.35 TB/s.  Bytes per mode, at 48^3 f32 [128^2 f32, 16,384 modes]:
//   helmholtz   2,024 B: 223.8 MB, 66.8 us [600 B: 9.8 MB, 2.9 us]
//   poisson       396 B:  43.8 MB, 13.1 us [140 B: 2.3 MB, 0.7 us]
//   correction  1,112 B: 123.0 MB, 36.7 us [344 B: 5.6 MB, 1.7 us]
// The products are about 1 GFLOP a step at 48^3, 16 us at 67 TFLOP/s f32:
// the work is bound by bytes.
//
// Design:
// * Persistent CTAs, as many as the card holds at once, walk tiles of kModes
//   consecutive modes.  Every per-mode array is contiguous over the modes,
//   so one tile of an operand is one contiguous run: thread 0 copies it into
//   shared memory with one cp.async.bulk per operand, completing on the
//   stage's mbarrier, and keeps the next tile's copies in flight while the
//   CTA computes the current one (two stages, about 58 KB each in 3D f32).
//   The per-mode scalars (Ph, Phi, Linv: 4-8 B of a mode's 140-2,024) are
//   read by plain loads, coalesced over the modes.
// * NB threads per mode, thread r forming row r of each product from shared
//   memory with FMAs in T; a warp holds whole modes.  A block that every row
//   needs whole (the right-hand side of the next product) goes through a
//   padded exchange area in shared memory, ordered by __syncwarp.  Each
//   thread walks its row (its column, for P^H) from a lane-dependent start,
//   so that the 32 lanes of a warp read 32 banks.
// * P^H is P's columns, conjugated: the same numbers as the PH that
//   SpectralOperators also holds, which is not read.
// * Every output is a fresh array written from registers; no operand is
//   updated in place (the old state's tensors stay intact).
// * No fast-math: the scale 1 / (a0/k + nu lam) is an IEEE divide.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

// 256 threads a CTA in f32, 128 in f64 (the same bytes a stage), NB a mode.
template <typename T, int NB>
struct Tiling {
  static constexpr int kThreads = sizeof(T) == 4 ? 256 : 128;
  static constexpr int kModes = kThreads / NB;
};

// One mode's exchange block: re and im of an (NB, D) block, padded so that
// the reads and writes of a warp fall in distinct banks (f32).
template <int NB, int D>
struct Exchange {
  static constexpr int kStride = 2 * NB * D + 8;
};

// The streamed operands of each kernel in the order of a stage: (re, im)
// pairs and lam, with their elements per mode.
template <int NB, int D>
struct HelmholtzOps {
  enum { kUh = 0, kUo = 2, kCh = 4, kM = 6, kG = 8, kP = 10, kLam = 12,
         kOps = 13 };
  __host__ __device__ static constexpr int per(int k) {
    return k == kLam ? NB
           : (k == kM || k == kM + 1 || k == kP || k == kP + 1) ? NB * NB
                                                                 : NB * D;
  }
};

template <int NB, int D>
struct PoissonOps {
  enum { kUs = 0, kD = 2, kOps = 4 };
  __host__ __device__ static constexpr int per(int) { return NB * D; }
};

template <int NB, int D>
struct CorrectionOps {
  enum { kUs = 0, kG = 2, kP = 4, kOps = 6 };
  __host__ __device__ static constexpr int per(int k) {
    return k >= kP ? NB * NB : NB * D;
  }
};

// Offset of operand k in a stage of kModes modes, in elements.
template <class L, int kModes>
__host__ __device__ constexpr int stage_offset(int k) {
  int o = 0;
  for (int j = 0; j < k; ++j) o += kModes * L::per(j);
  return o;
}

// Dynamic shared memory: two stages, then the exchange blocks.
template <typename T, int NB, int D, class L>
constexpr int smem_bytes() {
  constexpr int kModes = Tiling<T, NB>::kModes;
  return (2 * stage_offset<L, kModes>(L::kOps) +
          kModes * Exchange<NB, D>::kStride) *
         (int)sizeof(T);
}

// A launch's operands and coefficients, by value.
//   helmholtz:  scalar Ph (re, im); out U* (re, im); coef c1, c2, a0/k, nu
//   poisson:    scalar Linv; out Phi (re, im); coef a0/k
//   correction: scalar Phi (re, im), Ph (re, im); out Uh_new (re, im),
//               Ph_new (re, im); coef -(k/a0); zero_mode
template <typename T, int kOps>
struct ModalArgs {
  const T* in[kOps];  // streamed, 16-byte aligned
  const T* scalar[4];
  T* out[4];
  long long modes;
  T coef[4];
  int zero_mode;
};

__device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The tiles of blockIdx.x, gridDim.x apart: body(stage, first mode, modes
// in the tile) runs on each once its operands have landed, while thread 0
// streams the next tile into the other stage.
template <typename T, class L, int kModes, class Body>
__device__ __forceinline__ void walk_tiles(const T* const* in,
                                           long long modes, T* stages,
                                           unsigned long long* bars,
                                           Body&& body) {
  constexpr int kStage = stage_offset<L, kModes>(L::kOps);
  const long long tiles = (modes + kModes - 1) / kModes;
  const unsigned bar0 = smem_u32(&bars[0]);  // stage s: bar0 + 8 s
  auto count = [&](long long tile) {
    const long long left = modes - tile * kModes;
    return left < kModes ? (int)left : kModes;
  };
  auto load_tile = [&](long long tile, int s) {
    const int n = count(tile);
    const long long first = tile * kModes;
    T* dst = stages + s * kStage;
    unsigned bytes = 0;
#pragma unroll
    for (int k = 0; k < L::kOps; ++k) bytes += n * L::per(k) * sizeof(T);
    // the stage's last reads (generic proxy) before the copies (async)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_expect(bar0 + 8 * s, bytes);
#pragma unroll
    for (int k = 0; k < L::kOps; ++k)
      bulk_load(smem_u32(dst + stage_offset<L, kModes>(k)),
                in[k] + first * L::per(k), n * L::per(k) * sizeof(T),
                bar0 + 8 * s);
  };
  if (threadIdx.x == 0) {
    mbar_init(bar0);
    mbar_init(bar0 + 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  long long tile = blockIdx.x;
  if (threadIdx.x == 0 && tile < tiles) load_tile(tile, 0);
  for (unsigned i = 0; tile < tiles; ++i, tile += gridDim.x) {
    // the other stage was read in the previous tile, before its barrier
    const long long next = tile + gridDim.x;
    if (threadIdx.x == 0 && next < tiles) load_tile(next, (i + 1) & 1);
    mbar_wait(bar0 + 8 * (i & 1), (i >> 1) & 1);
    body(stages + (i & 1) * kStage, tile * kModes, count(tile));
    __syncthreads();
  }
}

// A thread's mode in the tile, its row, and where it starts its walks: the
// lanes whose rows (columns) of an NB x NB block start in the same bank
// start at different columns (rows).
template <int NB>
struct Lane {
  int mt, r, rot, rot2;
  __device__ Lane() {
    mt = threadIdx.x / NB;
    r = threadIdx.x % NB;
    const int lane = threadIdx.x & 31;
    rot = lane * NB / 32;
    constexpr int q = 32 / (NB * NB);
    rot2 = (lane / NB) / (q > 0 ? q : 1);
  }
};

// Row r of S X: sum_c S[r, c] X[c, :], S an NB x NB block (re, im; row
// major), X an (NB, D) block (re, im) of the exchange area.
template <typename T, int NB, int D>
__device__ __forceinline__ void row_product(const T* sr, const T* si,
                                            const T* xr, const T* xi, int r,
                                            int rot, T (&yr)[D],
                                            T (&yi)[D]) {
#pragma unroll
  for (int e = 0; e < D; ++e) yr[e] = yi[e] = T(0);
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    const int cc = (c + rot) & (NB - 1);
    const T a = sr[r * NB + cc], b = si[r * NB + cc];
#pragma unroll
    for (int e = 0; e < D; ++e) {
      const T x = xr[cc * D + e], y = xi[cc * D + e];
      yr[e] = fma(a, x, yr[e]);
      yr[e] = fma(-b, y, yr[e]);
      yi[e] = fma(a, y, yi[e]);
      yi[e] = fma(b, x, yi[e]);
    }
  }
}

// Row r of S^H X: sum_j conj(S[j, r]) X[j, :].
template <typename T, int NB, int D>
__device__ __forceinline__ void column_product(const T* sr, const T* si,
                                               const T* xr, const T* xi,
                                               int r, int rot2, T (&yr)[D],
                                               T (&yi)[D]) {
#pragma unroll
  for (int e = 0; e < D; ++e) yr[e] = yi[e] = T(0);
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int jj = (j + rot2) & (NB - 1);
    const T a = sr[jj * NB + r], b = si[jj * NB + r];
#pragma unroll
    for (int e = 0; e < D; ++e) {
      const T x = xr[jj * D + e], y = xi[jj * D + e];
      yr[e] = fma(a, x, yr[e]);
      yr[e] = fma(b, y, yr[e]);
      yi[e] = fma(a, y, yi[e]);
      yi[e] = fma(-b, x, yi[e]);
    }
  }
}

// Row r of an (NB, D) block into the exchange area; the caller orders it
// with __syncwarp against the reads of the block it replaces and of itself.
template <typename T, int D>
__device__ __forceinline__ void put_row(T* xr, T* xi, int r,
                                        const T (&vr)[D], const T (&vi)[D]) {
#pragma unroll
  for (int e = 0; e < D; ++e) {
    xr[r * D + e] = vr[e];
    xi[r * D + e] = vi[e];
  }
}

template <typename T, int NB, int D>
__global__ void __launch_bounds__(Tiling<T, NB>::kThreads)
    spectral_helmholtz_kernel(
        const __grid_constant__ ModalArgs<T, HelmholtzOps<NB, D>::kOps> a) {
  using L = HelmholtzOps<NB, D>;
  constexpr int kModes = Tiling<T, NB>::kModes, V = NB * D;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ unsigned long long bars[2];
  T* stages = reinterpret_cast<T*>(smem_raw);
  const Lane<NB> ln;
  const int r = ln.r;
  T* xr = stages + 2 * stage_offset<L, kModes>(L::kOps) +
          ln.mt * Exchange<NB, D>::kStride;
  T* xi = xr + V;
  const T c1 = a.coef[0], c2 = a.coef[1], a0k = a.coef[2], visc = a.coef[3];
  walk_tiles<T, L, kModes>(a.in, a.modes, stages, bars, [&](const T* st,
                                                            long long first,
                                                            int count) {
    auto at = [&](int k) {
      return st + stage_offset<L, kModes>(k) + ln.mt * L::per(k);
    };
    const T *uh_re = at(L::kUh), *uh_im = at(L::kUh + 1);
    const T *uo_re = at(L::kUo), *uo_im = at(L::kUo + 1);
    const T *ch_re = at(L::kCh), *ch_im = at(L::kCh + 1);
    const T *m_re = at(L::kM), *m_im = at(L::kM + 1);
    const T *g_re = at(L::kG), *g_im = at(L::kG + 1);
    const T *p_re = at(L::kP), *p_im = at(L::kP + 1);
    const T* lam = at(L::kLam);
    const long long mode = first + ln.mt;
    const bool valid = ln.mt < count;
    // M's right-hand side, c1 Uh + c2 Uh_old
    T vr[D], vi[D];
#pragma unroll
    for (int e = 0; e < D; ++e) {
      vr[e] = c1 * uh_re[r * D + e] + c2 * uo_re[r * D + e];
      vi[e] = c1 * uh_im[r * D + e] + c2 * uo_im[r * D + e];
    }
    put_row<T, D>(xr, xi, r, vr, vi);
    __syncwarp();
    // Bh = M (c1 Uh + c2 Uh_old) - Ch - G Ph
    T br[D], bi[D];
    row_product<T, NB, D>(m_re, m_im, xr, xi, r, ln.rot, br, bi);
    const T pr = valid ? a.scalar[0][mode] : T(0);
    const T pi = valid ? a.scalar[1][mode] : T(0);
#pragma unroll
    for (int e = 0; e < D; ++e) {
      const T gr = g_re[r * D + e], gi = g_im[r * D + e];
      br[e] = br[e] - ch_re[r * D + e] - (gr * pr - gi * pi);
      bi[e] = bi[e] - ch_im[r * D + e] - (gr * pi + gi * pr);
    }
    __syncwarp();
    put_row<T, D>(xr, xi, r, br, bi);
    __syncwarp();
    // t = diag(1 / (a0/k + nu lam)) P^H Bh
    T tr[D], ti[D];
    column_product<T, NB, D>(p_re, p_im, xr, xi, r, ln.rot2, tr, ti);
    const T s = T(1) / (a0k + visc * lam[r]);
#pragma unroll
    for (int e = 0; e < D; ++e) {
      tr[e] *= s;
      ti[e] *= s;
    }
    __syncwarp();
    put_row<T, D>(xr, xi, r, tr, ti);
    __syncwarp();
    // U* = P t
    T ur[D], ui[D];
    row_product<T, NB, D>(p_re, p_im, xr, xi, r, ln.rot, ur, ui);
    if (valid) {
      T* o_re = a.out[0] + (mode * NB + r) * D;
      T* o_im = a.out[1] + (mode * NB + r) * D;
#pragma unroll
      for (int e = 0; e < D; ++e) {
        o_re[e] = ur[e];
        o_im[e] = ui[e];
      }
    }
  });
}

template <typename T, int NB, int D>
__global__ void __launch_bounds__(Tiling<T, NB>::kThreads)
    spectral_poisson_kernel(
        const __grid_constant__ ModalArgs<T, PoissonOps<NB, D>::kOps> a) {
  using L = PoissonOps<NB, D>;
  constexpr int kModes = Tiling<T, NB>::kModes;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ unsigned long long bars[2];
  T* stages = reinterpret_cast<T*>(smem_raw);
  const Lane<NB> ln;
  const int r = ln.r;
  const T a0k = a.coef[0];
  walk_tiles<T, L, kModes>(a.in, a.modes, stages, bars, [&](const T* st,
                                                            long long first,
                                                            int count) {
    auto at = [&](int k) {
      return st + stage_offset<L, kModes>(k) + ln.mt * L::per(k);
    };
    const T *us_re = at(L::kUs), *us_im = at(L::kUs + 1);
    const T *d_re = at(L::kD), *d_im = at(L::kD + 1);
    // row r's share of D . U*, then the sum over the mode's NB lanes
    T sr = T(0), si = T(0);
#pragma unroll
    for (int e = 0; e < D; ++e) {
      const T dr = d_re[r * D + e], di = d_im[r * D + e];
      const T ur = us_re[r * D + e], ui = us_im[r * D + e];
      sr = fma(dr, ur, sr);
      sr = fma(-di, ui, sr);
      si = fma(dr, ui, si);
      si = fma(di, ur, si);
    }
#pragma unroll
    for (int o = NB / 2; o > 0; o >>= 1) {
      sr += __shfl_xor_sync(0xffffffffu, sr, o);
      si += __shfl_xor_sync(0xffffffffu, si, o);
    }
    const long long mode = first + ln.mt;
    if (ln.mt < count && r == 0) {
      const T l = a.scalar[0][mode];
      a.out[0][mode] = l * (a0k * sr);
      a.out[1][mode] = l * (a0k * si);
    }
  });
}

template <typename T, int NB, int D>
__global__ void __launch_bounds__(Tiling<T, NB>::kThreads)
    spectral_correction_kernel(
        const __grid_constant__ ModalArgs<T, CorrectionOps<NB, D>::kOps> a) {
  using L = CorrectionOps<NB, D>;
  constexpr int kModes = Tiling<T, NB>::kModes, V = NB * D;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ unsigned long long bars[2];
  T* stages = reinterpret_cast<T*>(smem_raw);
  const Lane<NB> ln;
  const int r = ln.r;
  T* xr = stages + 2 * stage_offset<L, kModes>(L::kOps) +
          ln.mt * Exchange<NB, D>::kStride;
  T* xi = xr + V;
  const T mka0 = a.coef[0];
  walk_tiles<T, L, kModes>(a.in, a.modes, stages, bars, [&](const T* st,
                                                            long long first,
                                                            int count) {
    auto at = [&](int k) {
      return st + stage_offset<L, kModes>(k) + ln.mt * L::per(k);
    };
    const T *us_re = at(L::kUs), *us_im = at(L::kUs + 1);
    const T *g_re = at(L::kG), *g_im = at(L::kG + 1);
    const T *p_re = at(L::kP), *p_im = at(L::kP + 1);
    const long long mode = first + ln.mt;
    const bool valid = ln.mt < count;
    // G Phi
    const T fr = valid ? a.scalar[0][mode] : T(0);
    const T fi = valid ? a.scalar[1][mode] : T(0);
    T vr[D], vi[D];
#pragma unroll
    for (int e = 0; e < D; ++e) {
      const T gr = g_re[r * D + e], gi = g_im[r * D + e];
      vr[e] = gr * fr - gi * fi;
      vi[e] = gr * fi + gi * fr;
    }
    put_row<T, D>(xr, xi, r, vr, vi);
    __syncwarp();
    // M^{-1} G Phi = P P^H G Phi
    T tr[D], ti[D];
    column_product<T, NB, D>(p_re, p_im, xr, xi, r, ln.rot2, tr, ti);
    __syncwarp();
    put_row<T, D>(xr, xi, r, tr, ti);
    __syncwarp();
    T yr[D], yi[D];
    row_product<T, NB, D>(p_re, p_im, xr, xi, r, ln.rot, yr, yi);
    if (valid) {
      T* o_re = a.out[0] + (mode * NB + r) * D;
      T* o_im = a.out[1] + (mode * NB + r) * D;
#pragma unroll
      for (int e = 0; e < D; ++e) {
        o_re[e] = us_re[r * D + e] + mka0 * yr[e];
        o_im[e] = us_im[r * D + e] + mka0 * yi[e];
      }
      if (r == 0) {
        const bool zero = a.zero_mode && mode == 0;
        a.out[2][mode] = zero ? T(0) : a.scalar[2][mode] + fr;
        a.out[3][mode] = zero ? T(0) : a.scalar[3][mode] + fi;
      }
    }
  });
}

constexpr int kMaxDevices = 64;

// The CTAs of `kernel` that the current device holds at once with `smem`
// bytes of dynamic shared memory each (opted in first); `cache` keeps the
// answer per device.
template <typename K>
cudaError_t resident_ctas(K kernel, int threads, int smem, int* cache,
                          int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    cache[dev] = sms * per_sm;
  }
  *out = cache[dev];
  return cudaSuccess;
}

template <typename T, int NB, int D, class L, typename K>
int launch(K kernel, const ModalArgs<T, L::kOps>& a, int* cache,
           cudaStream_t stream) {
  constexpr int kThreads = Tiling<T, NB>::kThreads;
  constexpr int kModes = Tiling<T, NB>::kModes;
  constexpr int smem = smem_bytes<T, NB, D, L>();
  if (a.modes < 1) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < L::kOps; ++k)
    if (reinterpret_cast<std::uintptr_t>(a.in[k]) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  int ctas = 0;
  const cudaError_t err =
      resident_ctas(kernel, kThreads, smem, cache, &ctas);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (a.modes + kModes - 1) / kModes;
  kernel<<<(int)(tiles < ctas ? tiles : ctas), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int NB, int D>
int helmholtz_launch(const ModalArgs<T, 13>& a, cudaStream_t stream) {
  static int cache[kMaxDevices];
  return launch<T, NB, D, HelmholtzOps<NB, D>>(
      spectral_helmholtz_kernel<T, NB, D>, a, cache, stream);
}

template <typename T, int NB, int D>
int poisson_launch(const ModalArgs<T, 4>& a, cudaStream_t stream) {
  static int cache[kMaxDevices];
  return launch<T, NB, D, PoissonOps<NB, D>>(spectral_poisson_kernel<T, NB, D>,
                                             a, cache, stream);
}

template <typename T, int NB, int D>
int correction_launch(const ModalArgs<T, 6>& a, cudaStream_t stream) {
  static int cache[kMaxDevices];
  return launch<T, NB, D, CorrectionOps<NB, D>>(
      spectral_correction_kernel<T, NB, D>, a, cache, stream);
}

static_assert(HelmholtzOps<4, 2>::kOps == 13 && HelmholtzOps<8, 3>::kOps == 13,
              "the Helmholtz operands");
static_assert(PoissonOps<8, 3>::kOps == 4 && CorrectionOps<8, 3>::kOps == 6,
              "the Poisson and correction operands");

template <typename T>
int helmholtz(int nb, int d, long long modes, const T* uh_re,
              const T* uh_im, const T* uo_re, const T* uo_im,
              const T* ch_re, const T* ch_im, const T* m_re, const T* m_im,
              const T* g_re, const T* g_im, const T* p_re, const T* p_im,
              const T* lam, const T* ph_re, const T* ph_im, double c1,
              double c2, double a0k, double visc, T* out_re, T* out_im,
              void* stream) {
  const ModalArgs<T, 13> a = {
      {uh_re, uh_im, uo_re, uo_im, ch_re, ch_im, m_re, m_im, g_re, g_im,
       p_re, p_im, lam},
      {ph_re, ph_im, nullptr, nullptr},
      {out_re, out_im, nullptr, nullptr},
      modes,
      {(T)c1, (T)c2, (T)a0k, (T)visc},
      0};
  const cudaStream_t s = (cudaStream_t)stream;
  if (nb == 4 && d == 2) return helmholtz_launch<T, 4, 2>(a, s);
  if (nb == 8 && d == 3) return helmholtz_launch<T, 8, 3>(a, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int poisson(int nb, int d, long long modes, const T* us_re, const T* us_im,
            const T* d_re, const T* d_im, const T* linv, double a0k,
            T* out_re, T* out_im, void* stream) {
  const ModalArgs<T, 4> a = {{us_re, us_im, d_re, d_im},
                             {linv, nullptr, nullptr, nullptr},
                             {out_re, out_im, nullptr, nullptr},
                             modes,
                             {(T)a0k, T(0), T(0), T(0)},
                             0};
  const cudaStream_t s = (cudaStream_t)stream;
  if (nb == 4 && d == 2) return poisson_launch<T, 4, 2>(a, s);
  if (nb == 8 && d == 3) return poisson_launch<T, 8, 3>(a, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int correction(int nb, int d, long long modes, const T* us_re,
               const T* us_im, const T* g_re, const T* g_im, const T* p_re,
               const T* p_im, const T* phi_re, const T* phi_im,
               const T* ph_re, const T* ph_im, double mka0, int zero_mode,
               T* uh_re, T* uh_im, T* ph_new_re, T* ph_new_im,
               void* stream) {
  const ModalArgs<T, 6> a = {{us_re, us_im, g_re, g_im, p_re, p_im},
                             {phi_re, phi_im, ph_re, ph_im},
                             {uh_re, uh_im, ph_new_re, ph_new_im},
                             modes,
                             {(T)mka0, T(0), T(0), T(0)},
                             zero_mode};
  const cudaStream_t s = (cudaStream_t)stream;
  if (nb == 4 && d == 2) return correction_launch<T, 4, 2>(a, s);
  if (nb == 8 && d == 3) return correction_launch<T, 8, 3>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int ns_spectral_helmholtz_f32(int nb, int d, long long modes,
                              const float* uh_re, const float* uh_im,
                              const float* uo_re, const float* uo_im,
                              const float* ch_re, const float* ch_im,
                              const float* m_re, const float* m_im,
                              const float* g_re, const float* g_im,
                              const float* p_re, const float* p_im,
                              const float* lam, const float* ph_re,
                              const float* ph_im, double c1, double c2,
                              double a0k, double visc, float* out_re,
                              float* out_im, void* stream) {
  return helmholtz<float>(nb, d, modes, uh_re, uh_im, uo_re, uo_im, ch_re,
                          ch_im, m_re, m_im, g_re, g_im, p_re, p_im, lam,
                          ph_re, ph_im, c1, c2, a0k, visc, out_re, out_im,
                          stream);
}

int ns_spectral_helmholtz_f64(int nb, int d, long long modes,
                              const double* uh_re, const double* uh_im,
                              const double* uo_re, const double* uo_im,
                              const double* ch_re, const double* ch_im,
                              const double* m_re, const double* m_im,
                              const double* g_re, const double* g_im,
                              const double* p_re, const double* p_im,
                              const double* lam, const double* ph_re,
                              const double* ph_im, double c1, double c2,
                              double a0k, double visc, double* out_re,
                              double* out_im, void* stream) {
  return helmholtz<double>(nb, d, modes, uh_re, uh_im, uo_re, uo_im, ch_re,
                           ch_im, m_re, m_im, g_re, g_im, p_re, p_im, lam,
                           ph_re, ph_im, c1, c2, a0k, visc, out_re, out_im,
                           stream);
}

int ns_spectral_poisson_f32(int nb, int d, long long modes,
                            const float* us_re, const float* us_im,
                            const float* d_re, const float* d_im,
                            const float* linv, double a0k, float* out_re,
                            float* out_im, void* stream) {
  return poisson<float>(nb, d, modes, us_re, us_im, d_re, d_im, linv, a0k,
                        out_re, out_im, stream);
}

int ns_spectral_poisson_f64(int nb, int d, long long modes,
                            const double* us_re, const double* us_im,
                            const double* d_re, const double* d_im,
                            const double* linv, double a0k, double* out_re,
                            double* out_im, void* stream) {
  return poisson<double>(nb, d, modes, us_re, us_im, d_re, d_im, linv, a0k,
                         out_re, out_im, stream);
}

int ns_spectral_correction_f32(int nb, int d, long long modes,
                               const float* us_re, const float* us_im,
                               const float* g_re, const float* g_im,
                               const float* p_re, const float* p_im,
                               const float* phi_re, const float* phi_im,
                               const float* ph_re, const float* ph_im,
                               double mka0, int zero_mode, float* uh_re,
                               float* uh_im, float* ph_new_re,
                               float* ph_new_im, void* stream) {
  return correction<float>(nb, d, modes, us_re, us_im, g_re, g_im, p_re,
                           p_im, phi_re, phi_im, ph_re, ph_im, mka0,
                           zero_mode, uh_re, uh_im, ph_new_re, ph_new_im,
                           stream);
}

int ns_spectral_correction_f64(int nb, int d, long long modes,
                               const double* us_re, const double* us_im,
                               const double* g_re, const double* g_im,
                               const double* p_re, const double* p_im,
                               const double* phi_re, const double* phi_im,
                               const double* ph_re, const double* ph_im,
                               double mka0, int zero_mode, double* uh_re,
                               double* uh_im, double* ph_new_re,
                               double* ph_new_im, void* stream) {
  return correction<double>(nb, d, modes, us_re, us_im, g_re, g_im, p_re,
                            p_im, phi_re, phi_im, ph_re, ph_im, mka0,
                            zero_mode, uh_re, uh_im, ph_new_re, ph_new_im,
                            stream);
}

}  // extern "C"
