// Circulant band kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Every kernel contracts a CirculantBand row by row,
//
//     y[b, i] = sum_k band[k, i] * x[b, (i + off_k) mod N],
//
// with the wrap done as one conditional subtraction on 32-bit indices
// (offsets lie in [0, N); the launchers refuse N >= 2^30, B*N >= 2^31 and
// K*N >= 2^31).  Offsets travel by value in the kernel parameters and are
// copied to shared memory once per block.
//
// A. circulant_apply_kernel replaces the Pallas kernel
//    navierstokes_tpu/assembly/pallas_band.py::circulant_apply (:220,
//    pallas_call :106).
//    Bound: bytes.  The band (K x N) is the bulk of the traffic.  At 128^2
//    (velocity mass band 23 x 65,536 f32 on 2 planes) the least time is
//    7.08 MB / 3.35 TB/s = 2.1 us; at that size the call is bound in
//    practice by load latency, not by bandwidth.
//    Design: one thread owns one row for every plane (up to kPlanes planes
//    per pass, accumulated in registers), so the band is read once per
//    call whatever the batch; neighbouring threads read neighbouring
//    windows of x, which stay coalesced.  Several rows per thread with 8-
//    or 16-byte band loads measured slower on the card (fewer threads in
//    flight for a latency-bound call), so each thread takes one row.
//
// B. circulant_pcg replaces the Pallas kernel
//    navierstokes_tpu/assembly/pallas_band.py::circulant_pcg (:202,
//    pallas_call :183): a fixed number of Jacobi-PCG iterations on
//    A'v = m*A(m*v) + (1-m)*v with r <- m*r and an optional mean
//    subtraction, returning (x, r), in the update order of
//    solvers/planar_step.py::_pcg.
//    Bound: the bytes and FLOPs of a solve are small (Poisson at 128^2:
//    0.92 MB, 29 MFLOP, well under 1 us at the card's peaks); what bounds
//    it is the chain of dependent reductions: every iteration needs p.Ap
//    before it can update x and r, and r.z before the next search
//    direction exists, and each reduction is a barrier across the CTAs
//    (about 0.5-0.7 us for a cluster, 1.1 us for a cooperative grid on
//    this card).
//    Design:
//    * Two barriers per iteration (three with the mean subtraction), not
//      four: the update p = z + beta p is folded into the next matvec.
//      After the r.z barrier, z and p_old are final everywhere, so the
//      matvec computes every neighbour's p_new[j] = z[j] + beta p_old[j]
//      itself, and the owner of row j writes it to the other p buffer.
//      fold_p() evaluates that expression with explicit round-to-nearest
//      multiply and add (no contraction), so every block gets the owner's
//      bits and the result is the one of the unfolded loop.  z and p of a
//      row sit side by side, so a neighbour reads both with one load.
//    * Route A, circulant_pcg_cluster_kernel: a system whose band and
//      state fit in the shared memory of one 16-CTA thread-block cluster
//      (non-portable size) runs entirely there.  Each CTA owns a
//      power-of-two row range, loads its band slice and vectors once, and
//      reads neighbours' (z, p) and mask through distributed shared memory.
//      A reduction pushes every warp's partial into every CTA's shared
//      memory, then one cluster barrier, then every warp sums the partials
//      from its own shared memory.
//    * Route B, circulant_pcg_grid_kernel: everything else runs as one
//      cooperative grid of at most one CTA per SM.  Each CTA owns a
//      contiguous row range of every plane, keeps its band slice in shared
//      memory when it fits and streams it from global memory otherwise;
//      the (z, p) pairs go through L2 (read with ld.global.cg, past L1,
//      because other SMs write them).  A reduction is a cooperative-groups
//      grid barrier between writing the block partials and summing them.
//    Both routes run the same pcg_body() over a memory policy.
//    Determinism: every block reduces the same partials in the same fixed
//    order, so alpha and beta are bit-identical in every block.  No
//    atomics.  Consecutive reductions use different partial slots, so no
//    block overwrites a slot another still reads.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxOffsets = 96;  // build_operator's circulant_cap
constexpr int kApplyThreads = 256;
constexpr int kGridThreads = 1024;    // route B CTA
constexpr int kClusterThreads = 512;  // route A CTA
constexpr int kMaxCluster = 16;
// Route A runs with 512-thread CTAs only.  With 1024 threads it returned
// a wrong r for B >= 2 in one chip run, and the cause was never found
// (ClusterMem's layout and reductions read as independent of the block
// size); every route-A configuration that ships is held against the plain
// version on the card, B = 1 and B = 2, f32 and f64 (chip_smoke.py, phase
// kernels).  Change the size only together with those checks, and with
// cuda_band.CLUSTER_THREADS and SMEM_STATIC (red[] grows with it).
static_assert(kClusterThreads == 512,
              "route A is verified with 512-thread CTAs only");
constexpr int kClusterPartials = kMaxCluster * kClusterThreads / 32;

struct OffsetList {
  int K;
  int off[kMaxOffsets];
};

// --------------------------------------------------------------------------
// A. circulant_apply
// --------------------------------------------------------------------------

template <typename T, int kPlanes>
__global__ void __launch_bounds__(kApplyThreads)
circulant_apply_kernel(const T* __restrict__ band,
                       const __grid_constant__ OffsetList offs,
                       const T* __restrict__ x, T* __restrict__ y, int n,
                       int batch) {
  __shared__ int s_off[kMaxOffsets];
  const int K = offs.K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) s_off[k] = offs.off[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  for (int b0 = 0; b0 < batch; b0 += kPlanes) {
    const int nb = min(kPlanes, batch - b0);
    const T* xb = x + (size_t)b0 * n;
    T acc[kPlanes];
#pragma unroll
    for (int q = 0; q < kPlanes; ++q) acc[q] = T(0);
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const T bv = band[k * n + i];
      int j = i + s_off[k];
      j -= (j >= n) ? n : 0;
#pragma unroll
      for (int q = 0; q < kPlanes; ++q)
        if (q < nb) acc[q] += bv * xb[q * n + j];
    }
#pragma unroll
    for (int q = 0; q < kPlanes; ++q)
      if (q < nb) y[(size_t)(b0 + q) * n + i] = acc[q];
  }
}

// --------------------------------------------------------------------------
// B. circulant_pcg
// --------------------------------------------------------------------------

template <typename T>
struct PcgParams {
  const T* band;
  int K;
  int n;         // plane length N
  int batch;     // planes B
  int rows;      // rows of N owned by one CTA
  int resident;  // route B: the band slice sits in shared memory
  int off[kMaxOffsets];
  const T* b;
  const T* x0;
  const T* invd;
  int invd_stride;  // 0: one (N,) row shared by all planes, else N
  const T* mask;    // null: no mask
  int mask_stride;
  int iters;
  int meanfree;
  T* x;
  T* r;
  T* scratch;  // route B: (z, p) pairs of 2 buffers (2 x B*N), Ap (B*N),
               // 3 x gridDim.x block partials
};

// p_new = z + beta * p_old, rounded as the unfolded loop rounds it (never
// contracted to an fma): the owner of a row and every neighbour that
// recomputes it get the same bits.
template <typename T>
__device__ __forceinline__ T fold_p(T z, T beta, T p_old) {
  return add_rn(z, mul_rn(beta, p_old));
}

// Sum of v over the block in a fixed order, valid in warp 0.  The caller
// barriers before red is written again.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red) {
  v = warp_total(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T s = T(0);
  if (warp == 0)
    s = warp_total(lane < (int)(blockDim.x >> 5) ? red[lane] : T(0));
  return s;
}

// sum_k band(k, i) * val((i + off_k) mod n)
template <typename T, class Mem, class F>
__device__ __forceinline__ T contract(const Mem& m, const int* off, int K,
                                     int li, int i, int n, F val) {
  T acc = T(0);
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    int j = i + off[k];
    j -= (j >= n) ? n : 0;
    acc += m.band(k, li, i) * val(j);
  }
  return acc;
}

// The solve, over a memory policy Mem that says where each vector lives.
// A CTA's work items t < m.items map (m.item) to plane bb and own row li,
// i.e. row i = m.lo + li; m.zp(buf, bb, li) is the (z, p) pair of a row in
// one of the two p buffers.
template <typename T, bool masked, class Mem>
__device__ void pcg_body(const PcgParams<T>& a, Mem& m, const int* off) {
  using P = Pair<T>;
  const int K = a.K, n = a.n, lo = m.lo, items = m.items;
  const int tid = threadIdx.x, nt = blockDim.x;

  // r0 = project(b - A' x0), x = x0
  T part = T(0);
  for (int t = tid; t < items; t += nt) {
    int bb, li;
    if (!m.item(t, bb, li)) continue;
    const int i = lo + li;
    const T* x0b = a.x0 + bb * n;
    T w = contract<T>(m, off, K, li, i, n, [&](int j) {
      const T v = x0b[j];
      return masked ? m.mask_at(bb, j) * v : v;
    });
    const T x0i = x0b[i];
    T mi = T(1);
    if (masked) {
      mi = m.mask(bb, li);
      w = mi * w + (T(1) - mi) * x0i;
    }
    T ri = a.b[bb * n + i] - w;
    if (masked) ri *= mi;
    m.r(bb, li) = ri;
    m.x(bb, li) = x0i;
    part += ri;
  }
  T mean = T(0);
  if (a.meanfree) mean = m.total(part, 1) / T(n);
  // z0 = invd r0; p_old = 0 with beta = 0 makes the first p_new = z0
  part = T(0);
  for (int t = tid; t < items; t += nt) {
    int bb, li;
    if (!m.item(t, bb, li)) continue;
    T ri = m.r(bb, li);
    if (a.meanfree) {
      ri -= mean;
      m.r(bb, li) = ri;
    }
    const T zi = m.invd(bb, li) * ri;
    P zp;
    zp.x = zi;
    zp.y = T(0);
    m.zp(0, bb, li) = zp;
    part += ri * zi;
  }
  T rz = m.total(part, 2);
  T beta = T(0);
  int cur = 0;  // buffer of p_old

  for (int it = 0; it < a.iters; ++it) {
    const int nxt = cur ^ 1;
    // (1) p_new = z + beta p_old (at every row the matvec reads), Ap, p.Ap
    part = T(0);
    for (int t = tid; t < items; t += nt) {
      int bb, li;
      if (!m.item(t, bb, li)) continue;
      const int i = lo + li;
      const P own = m.zp(cur, bb, li);
      const T pi = fold_p(own.x, beta, own.y);
      m.zp(nxt, bb, li).y = pi;
      T api = contract<T>(m, off, K, li, i, n, [&](int j) {
        const P q = m.zp_at(cur, bb, j);
        const T pj = fold_p(q.x, beta, q.y);
        return masked ? m.mask_at(bb, j) * pj : pj;
      });
      if (masked) {
        const T mi = m.mask(bb, li);
        api = mi * api + (T(1) - mi) * pi;
      }
      m.ap(bb, li) = api;
      part += pi * api;
    }
    // (2) alpha
    const T denom = m.total(part, 0);
    const T alpha = nonzero(denom) ? rz / denom : T(0);
    // (3) x += alpha p, r <- m (r - alpha Ap); (4) mean; (5) z = invd r, r.z
    part = T(0);
    T rsum = T(0);
    for (int t = tid; t < items; t += nt) {
      int bb, li;
    if (!m.item(t, bb, li)) continue;
      m.x(bb, li) += alpha * m.zp(nxt, bb, li).y;
      T ri = m.r(bb, li) - alpha * m.ap(bb, li);
      if (masked) ri *= m.mask(bb, li);
      m.r(bb, li) = ri;
      if (a.meanfree) {
        rsum += ri;
      } else {
        const T zi = m.invd(bb, li) * ri;
        m.zp(nxt, bb, li).x = zi;
        part += ri * zi;
      }
    }
    if (a.meanfree) {
      mean = m.total(rsum, 1) / T(n);
      for (int t = tid; t < items; t += nt) {
        int bb, li;
    if (!m.item(t, bb, li)) continue;
        const T ri = m.r(bb, li) - mean;
        m.r(bb, li) = ri;
        const T zi = m.invd(bb, li) * ri;
        m.zp(nxt, bb, li).x = zi;
        part += ri * zi;
      }
    }
    cur = nxt;
    if (it + 1 == a.iters) break;  // the last beta is never used
    // (6) beta; the next matvec folds p = z + beta p
    const T rz_new = m.total(part, 2);
    beta = nonzero(rz) ? rz_new / rz : T(0);
    rz = rz_new;
  }
  m.finish();
}

// Route B: vectors in global memory, band slice in shared memory when it
// fits.  Pairs other blocks wrote in this launch are read past L1.
template <typename T>
struct GridMem {
  using P = Pair<T>;
  const PcgParams<T>& a;
  cg::grid_group& grid;
  T* red;
  T* bcast;
  int lo, rows_here, items, bstride;
  bool bres;
  const T* bandp;
  P *zp0_, *zp1_;
  T *ap_, *partial;

  __device__ GridMem(const PcgParams<T>& a_, cg::grid_group& g, T* red_,
                     T* bcast_, T* s_band)
      : a(a_), grid(g), red(red_), bcast(bcast_) {
    lo = blockIdx.x * a.rows;
    rows_here = max(0, min(a.rows, a.n - lo));
    items = a.batch * rows_here;
    const size_t plane = (size_t)a.batch * a.n;
    zp0_ = reinterpret_cast<P*>(a.scratch);
    zp1_ = zp0_ + plane;
    ap_ = a.scratch + 4 * plane;
    partial = a.scratch + 5 * plane;
    bres = a.resident != 0;
    if (bres) {
      for (int k = 0; k < a.K; ++k)
        for (int li = threadIdx.x; li < rows_here; li += blockDim.x)
          s_band[k * a.rows + li] = a.band[k * a.n + lo + li];
      bandp = s_band;
      bstride = a.rows;
    } else {
      bandp = a.band;
      bstride = a.n;
    }
  }
  __device__ T band(int k, int li, int i) const {
    return bandp[k * bstride + (bres ? li : i)];
  }
  // Work item t < items is row li of plane bb.
  __device__ bool item(int t, int& bb, int& li) const {
    bb = t / rows_here;
    li = t - bb * rows_here;
    return true;
  }
  __device__ int at(int bb, int li) const { return bb * a.n + lo + li; }
  __device__ T& x(int bb, int li) { return a.x[at(bb, li)]; }
  __device__ T& r(int bb, int li) { return a.r[at(bb, li)]; }
  __device__ T& ap(int bb, int li) { return ap_[at(bb, li)]; }
  __device__ P& zp(int buf, int bb, int li) {
    return (buf ? zp1_ : zp0_)[at(bb, li)];
  }
  __device__ T invd(int bb, int li) const {
    return a.invd[bb * a.invd_stride + lo + li];
  }
  __device__ T mask(int bb, int li) const {
    return a.mask[bb * a.mask_stride + lo + li];
  }
  __device__ P zp_at(int buf, int bb, int j) const {
    return __ldcg((buf ? zp1_ : zp0_) + bb * a.n + j);
  }
  __device__ T mask_at(int bb, int j) const {
    return a.mask[bb * a.mask_stride + j];
  }
  // Sum over the grid, bit-identical in every thread of every block.
  __device__ T total(T v, int slot) {
    T* row = partial + slot * gridDim.x;
    const T s = block_sum(v, red);
    if (threadIdx.x == 0) row[blockIdx.x] = s;
    grid.sync();
    if (threadIdx.x < 32) {
      T acc = T(0);
      for (int g = threadIdx.x; g < (int)gridDim.x; g += 32)
        acc += __ldcg(row + g);
      acc = warp_total(acc);
      if (threadIdx.x == 0) *bcast = acc;
    }
    __syncthreads();
    return *bcast;
  }
  __device__ void finish() {}
};

template <typename T, bool kMasked>
__global__ void __launch_bounds__(kGridThreads, 1)
circulant_pcg_grid_kernel(const __grid_constant__ PcgParams<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_off[kMaxOffsets];
  __shared__ T red[kGridThreads / 32];
  __shared__ T bcast;
  cg::grid_group grid = cg::this_grid();
  for (int k = threadIdx.x; k < a.K; k += blockDim.x) s_off[k] = a.off[k];
  GridMem<T> m(a, grid, red, &bcast, reinterpret_cast<T*>(smem_raw));
  __syncthreads();
  pcg_body<T, kMasked>(a, m, s_off);
}

// Shared-memory address helpers for the asynchronous reductions of
// route A: a remote st.async lands in another CTA's shared memory and
// completes bytes on that CTA's mbarrier, so the reader needs no
// cluster-wide fence, only its own mbarrier wait (common.cuh).
__device__ __forceinline__ unsigned map_rank(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_async(unsigned addr, float v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async(unsigned addr, double v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
      "[%2];" ::"r"(addr),
      "l"(__double_as_longlong(v)), "r"(bar)
      : "memory");
}

// Route A: everything in the cluster's shared memory.  Layout of one CTA,
// in elements of T, R = a.rows (a power of two), BR = B * R: the (z, p)
// pairs of both p buffers (2 * BR each), the band (K * R), then x, r, Ap,
// invd and, masked, the mask (BR each).
template <typename T>
struct ClusterMem {
  using P = Pair<T>;
  const PcgParams<T>& a;
  cg::cluster_group& cluster;
  T* s;
  T* const* base;  // every rank's s, in the generic address space
  T (*red)[kClusterPartials];  // every warp's partial, one row per slot
  unsigned long long* bars;    // mbarriers of slots 0 and 1
  unsigned parity;             // bit s: phase parity of bars[s]
  int rank, lo, rows_here, items, R, shift, BR;
  int oband, ox, or_, oap, oinvd, omask;

  __device__ ClusterMem(const PcgParams<T>& a_, cg::cluster_group& c, T* s_,
                        T* const* base_, T (*red_)[kClusterPartials],
                        unsigned long long* bars_)
      : a(a_), cluster(c), s(s_), base(base_), red(red_), bars(bars_),
        parity(0) {
    R = a.rows;
    shift = __ffs(R) - 1;
    BR = a.batch * R;
    rank = (int)cluster.block_rank();
    lo = rank * R;
    rows_here = max(0, min(R, a.n - lo));
    items = BR;
    oband = 4 * BR;
    ox = oband + a.K * R;
    or_ = ox + BR;
    oap = or_ + BR;
    oinvd = oap + BR;
    omask = oinvd + BR;
    for (int k = 0; k < a.K; ++k)
      for (int li = threadIdx.x; li < rows_here; li += blockDim.x)
        s[oband + k * R + li] = a.band[k * a.n + lo + li];
    for (int bb = 0; bb < a.batch; ++bb) {
      for (int li = threadIdx.x; li < rows_here; li += blockDim.x) {
        s[oinvd + bb * R + li] = a.invd[bb * a.invd_stride + lo + li];
        if (a.mask)
          s[omask + bb * R + li] = a.mask[bb * a.mask_stride + lo + li];
      }
    }
  }
  // Work item t < items is row li of plane bb; rows past N (in the last
  // rank's range) are no items.
  __device__ bool item(int t, int& bb, int& li) const {
    bb = t >> shift;
    li = t & (R - 1);
    return li < rows_here;
  }
  __device__ T band(int k, int li, int) const { return s[oband + k * R + li]; }
  __device__ T& x(int bb, int li) { return s[ox + bb * R + li]; }
  __device__ T& r(int bb, int li) { return s[or_ + bb * R + li]; }
  __device__ T& ap(int bb, int li) { return s[oap + bb * R + li]; }
  __device__ P& zp(int buf, int bb, int li) {
    return reinterpret_cast<P*>(s)[buf * BR + bb * R + li];
  }
  __device__ T invd(int bb, int li) const { return s[oinvd + bb * R + li]; }
  __device__ T mask(int bb, int li) const { return s[omask + bb * R + li]; }
  // Row j's (z, p) pair and mask, from this CTA's shared memory or, owned
  // by another rank, over DSMEM.
  __device__ P zp_at(int buf, int bb, int j) const {
    const int q = j >> shift, idx = buf * BR + bb * R + (j & (R - 1));
    return reinterpret_cast<const P*>(q == rank ? s : base[q])[idx];
  }
  __device__ T mask_at(int bb, int j) const {
    const int q = j >> shift, idx = omask + bb * R + (j & (R - 1));
    return (q == rank ? s : base[q])[idx];
  }
  // Sum over the cluster, bit-identical in every thread of every CTA:
  // every warp pushes its partial into red[slot] of every rank, and then
  // every warp sums the C x W partials from its own shared memory, lane l
  // taking partials l*e .. l*e + e-1 (e = C*W/32) in order before the
  // butterfly.  Slot 2 (r.z) is followed by the next matvec, which reads
  // neighbours' (z, p): its pushes are plain DSMEM stores and a cluster
  // barrier releases them with the vectors.  Slots 0 (p.Ap) and 1 (the
  // mean) publish nothing but the partials: they go by st.async to each
  // rank's mbarrier, whose wait is the only synchronisation (every warp
  // pushes after its last read of a neighbour, so a completed wait also
  // means no CTA still reads the buffers the next phase writes).
  __device__ T total(T v, int slot) {
    constexpr int W = kClusterThreads / 32;
    const int lane = threadIdx.x & 31, C = (int)cluster.num_blocks();
    v = warp_total(v);
    T* dst = &red[slot][rank * W + (threadIdx.x >> 5)];
    if (slot == 2) {
      if (lane < C) *cluster.map_shared_rank(dst, lane) = v;
      cluster_barrier();
    } else {
      const unsigned bar = smem_u32(&bars[slot]);
      if (threadIdx.x == 0) mbar_expect(bar, C * W * sizeof(T));
      if (lane < C)
        st_async(map_rank(smem_u32(dst), lane), v, map_rank(bar, lane));
      mbar_wait(bar, (parity >> slot) & 1u);
      parity ^= 1u << slot;
    }
    const int per = C * W / 32;
    T acc = T(0);
    for (int e = 0; e < per; ++e) acc += red[slot][lane * per + e];
    return warp_total(acc);
  }
  // Write x and r out; no CTA leaves while another may still read its
  // shared memory.
  __device__ void finish() {
    for (int bb = 0; bb < a.batch; ++bb) {
      for (int li = threadIdx.x; li < rows_here; li += blockDim.x) {
        a.x[bb * a.n + lo + li] = x(bb, li);
        a.r[bb * a.n + lo + li] = r(bb, li);
      }
    }
    cluster.sync();
  }
};

template <typename T, bool kMasked>
__global__ void __launch_bounds__(kClusterThreads, 1)
circulant_pcg_cluster_kernel(const __grid_constant__ PcgParams<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_off[kMaxOffsets];
  __shared__ T red[3][kClusterPartials];
  __shared__ T* s_base[kMaxCluster];
  __shared__ unsigned long long bars[2];
  cg::cluster_group cluster = cg::this_cluster();
  T* s = reinterpret_cast<T*>(smem_raw);
  for (int k = threadIdx.x; k < a.K; k += blockDim.x) s_off[k] = a.off[k];
  if (threadIdx.x < cluster.num_blocks())
    s_base[threadIdx.x] = cluster.map_shared_rank(s, threadIdx.x);
  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&bars[0]));
    mbar_init(smem_u32(&bars[1]));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  ClusterMem<T> m(a, cluster, s, s_base, red, bars);
  // every slice is loaded, and every mbarrier initialised, before any CTA
  // reads a neighbour or pushes to one
  cluster.sync();
  pcg_body<T, kMasked>(a, m, s_off);
}

// --------------------------------------------------------------------------
// launchers
// --------------------------------------------------------------------------

bool index_ok(int K, long long n, long long batch) {
  return K >= 1 && K <= kMaxOffsets && n >= 1 && n < (1LL << 30) &&
         batch >= 1 && n * batch < (1LL << 31) && K * n < (1LL << 31);
}

template <typename T>
int apply_launch(const T* band, const int* offs, int K, const T* x, T* y,
                 long long n, long long batch, cudaStream_t stream) {
  if (!index_ok(K, n, batch)) return (int)cudaErrorInvalidValue;
  OffsetList ol;
  ol.K = K;
  for (int k = 0; k < K; ++k) ol.off[k] = offs[k];
  int n32 = (int)n, b32 = (int)batch;
  void* args[] = {(void*)&band, (void*)&ol, (void*)&x, (void*)&y, &n32, &b32};
  const unsigned blocks = (unsigned)((n + kApplyThreads - 1) / kApplyThreads);
  // planes accumulated in registers per pass over the band
  const void* fn = batch == 1   ? (const void*)circulant_apply_kernel<T, 1>
                   : batch == 2 ? (const void*)circulant_apply_kernel<T, 2>
                                : (const void*)circulant_apply_kernel<T, 4>;
  return (int)cudaLaunchKernel(fn, dim3(blocks), dim3(kApplyThreads), args, 0,
                               stream);
}

constexpr int kRouteCluster = 0;
constexpr int kRouteGrid = 1;

template <typename T>
const void* cluster_kernel(bool masked) {
  return masked ? (const void*)circulant_pcg_cluster_kernel<T, true>
                : (const void*)circulant_pcg_cluster_kernel<T, false>;
}

template <typename T>
const void* grid_kernel(bool masked) {
  return masked ? (const void*)circulant_pcg_grid_kernel<T, true>
                : (const void*)circulant_pcg_grid_kernel<T, false>;
}

// The launch of route A: one cluster of `ctas` CTAs (attr is its storage).
cudaLaunchConfig_t cluster_config(int ctas, int smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ctas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Opt `fn` into all the dynamic shared memory a block may have beside its
// static arrays, so that no plan lowers another plan's limit.
cudaError_t allow_max_dynamic_smem(const void* fn) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)attr.sharedSizeBytes);
  return err;
}

// Check that `ctas` CTAs of a route's kernel with `smem` bytes of dynamic
// shared memory each can be resident at once (one cluster, or one
// cooperative grid).  Called once per plan by the wrapper.
template <typename T>
int pcg_prepare(int route, int ctas, int smem, int masked) {
  cudaError_t err;
  if (route == kRouteCluster) {
    const void* fn = cluster_kernel<T>(masked);
    if (ctas < 1 || ctas > kMaxCluster) return (int)cudaErrorInvalidValue;
    err = allow_max_dynamic_smem(fn);
    if (err == cudaSuccess && ctas > 8)
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(ctas, smem, nullptr, &attr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
    if (err != cudaSuccess) return (int)err;
    return clusters >= 1 ? 0 : (int)cudaErrorLaunchOutOfResources;
  }
  if (route != kRouteGrid) return (int)cudaErrorInvalidValue;
  const void* fn = grid_kernel<T>(masked);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  err = allow_max_dynamic_smem(fn);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                        kGridThreads, smem);
  if (err != cudaSuccess) return (int)err;
  return (long long)per_sm * sms >= ctas
             ? 0
             : (int)cudaErrorCooperativeLaunchTooLarge;
}

template <typename T>
int pcg_launch(int route, int ctas, int rows, int smem, int resident,
               const T* band, const int* offs, int K, long long n,
               long long batch, const T* b, const T* x0, const T* invd,
               int invd_stride, const T* mask, int mask_stride, int iters,
               int meanfree, T* x, T* r, T* scratch, cudaStream_t stream) {
  if (!index_ok(K, n, batch) || iters < 0 || ctas < 1 || rows < 1 ||
      (long long)ctas * rows < n)
    return (int)cudaErrorInvalidValue;
  PcgParams<T> a;
  a.band = band;
  a.K = K;
  a.n = (int)n;
  a.batch = (int)batch;
  a.rows = rows;
  a.resident = resident;
  for (int k = 0; k < K; ++k) a.off[k] = offs[k];
  a.b = b;
  a.x0 = x0;
  a.invd = invd;
  a.invd_stride = invd_stride;
  a.mask = mask;
  a.mask_stride = mask_stride;
  a.iters = iters;
  a.meanfree = meanfree;
  a.x = x;
  a.r = r;
  a.scratch = scratch;
  void* args[] = {&a};
  cudaError_t err;
  if (route == kRouteCluster) {
    if (ctas > kMaxCluster || (rows & (rows - 1)) != 0)
      return (int)cudaErrorInvalidValue;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(ctas, smem, stream, &attr);
    err = cudaLaunchKernelExC(&cfg, cluster_kernel<T>(mask != nullptr), args);
  } else if (route == kRouteGrid) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    err = cudaLaunchCooperativeKernel(grid_kernel<T>(mask != nullptr),
                                      dim3(ctas), dim3(kGridThreads), args,
                                      smem, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
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

int ns_circulant_pcg_prepare_f32(int route, int ctas, int smem, int masked) {
  return pcg_prepare<float>(route, ctas, smem, masked);
}

int ns_circulant_pcg_prepare_f64(int route, int ctas, int smem, int masked) {
  return pcg_prepare<double>(route, ctas, smem, masked);
}

int ns_circulant_pcg_f32(int route, int ctas, int rows, int smem,
                         int resident, const float* band, const int* offs,
                         int K, long long n, long long batch, const float* b,
                         const float* x0, const float* invd, int invd_stride,
                         const float* mask, int mask_stride, int iters,
                         int meanfree, float* x, float* r, float* scratch,
                         void* stream) {
  return pcg_launch<float>(route, ctas, rows, smem, resident, band, offs, K,
                           n, batch, b, x0, invd, invd_stride, mask,
                           mask_stride, iters, meanfree, x, r, scratch,
                           (cudaStream_t)stream);
}

int ns_circulant_pcg_f64(int route, int ctas, int rows, int smem,
                         int resident, const double* band, const int* offs,
                         int K, long long n, long long batch, const double* b,
                         const double* x0, const double* invd,
                         int invd_stride, const double* mask, int mask_stride,
                         int iters, int meanfree, double* x, double* r,
                         double* scratch, void* stream) {
  return pcg_launch<double>(route, ctas, rows, smem, resident, band, offs, K,
                            n, batch, b, x0, invd, invd_stride, mask,
                            mask_stride, iters, meanfree, x, r, scratch,
                            (cudaStream_t)stream);
}

}  // extern "C"
