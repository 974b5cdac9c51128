// The AMG-preconditioned CG of the planar step's pressure Poisson solve in
// one launch, for Hopper (sm_90a), bound to Python with ctypes.  Built into
// the same library as band.cu (cudalib.py::build_library).
//
// amg_pcg_cluster_kernel runs, in one 16-CTA thread-block cluster,
//
//     linalg/pcg.py::pcg(A', b, x0, iters, project=P,
//                        precond_fn=AMG.apply)
//
// for A' v = m*L(m*v) + (1-m)*v with P r = m*r (masked) or A' = L with
// P r = r - mean(r) (mean free), L a CirculantBand, and AMG the
// smoothed-aggregation hierarchy that planar_step.build_poisson_amg builds
// on the same L: level 0 is L itself (A' when masked), the levels below it
// padded row tables (ELL), the coarsest a dense pseudo-inverse.  Every
// V-cycle is linalg/amg.py::AMG._vcycle: one weighted-Jacobi sweep from
// zero, the residual, the smoothed restriction P0^T (I - c A D^-1), the
// cycle one level down, the smoothed prolongation (I - c D^-1 A) P0 and one
// sweep.  It returns (x, r) as circulant_pcg does.
//
// It replaces no Pallas kernel: the JAX package's V-cycle and CG are plain
// JAX (navierstokes_tpu/linalg/amg.py, solvers/planar_step.py).  In torch
// they were about 108 small kernels per CG iteration.
//
// Bound: a few hundred kB of operators and vectors, read once, are
// sub-microsecond at 3.35 TB/s; what bounds the solve is the chain of
// dependent phases.  Each level of a V-cycle depends on the one above it,
// each matvec on its neighbours' values, each CG step on two reductions;
// every dependency across CTAs is a cluster barrier (about 1,450 cycles,
// 0.73 us, for 16 CTAs of 1024 threads on an H100).  Barrier- and
// latency-bound, as route A of band.cu.
//
// Design:
// * Everything stays in the cluster's shared memory for the whole solve
//   (the coarse pseudo-inverse is read from L2 where it does not fit).
//   Each CTA owns ceil(n/16) contiguous rows of every distributed level
//   (the band slice or ELL rows, the inverse diagonals, the aggregate of
//   each row, the members of the coarse rows it owns).  The levels below
//   the distributed ones and the coarse pseudo-inverse are replicated:
//   every CTA runs them alone, with block barriers only, on the same data
//   and in the same order, so every CTA gets the same bits.  The plan
//   (cuda_amg.py) distributes the fewest levels whose layout fits (the
//   128^2 cavity: two in float32, three in float64).
// * A phase first fills a work buffer with the values its rows read: its
//   own rows and `halo` rows each side, round the end of the level where
//   it is periodic (a remote read costs about 200
//   cycles against 30 for a local one, so all of them are issued at once,
//   one per thread), then computes from shared memory of its own.
// * Barriers, not bytes.  One CG iteration takes 4d + 1 cluster barriers
//   for d distributed levels (9 at the 128^2 cavity in float32):
//   - the update r <- P(r - alpha Ap) and the pre-smooth from zero
//     (x1 = w D^-1 b, exactly what a sweep from zero gives) are folded
//     into the residual b - A x1: the neighbourhood's r and x1 are
//     recomputed from their r and Ap; the owner stores r one phase later;
//   - the smoothed restriction is computed by the owner of each coarse
//     row, for each of its members, from the members' neighbourhood
//     (`reach` rows each side) of D^-1 r0;
//   - the prolongation reads x_c[agg[j]] straight from the coarse owner;
//   - p = z + beta p is folded into the next matvec (route A);
//   - the mean of the new r is (sum r - alpha sum Ap) / n, summed with
//     p.Ap; r.z after the mean subtraction is r.z_raw - mean(z) sum r.
//   Every recomputed value is rounded with explicit round-to-nearest
//   operations (no contraction), so it has the owner's bits.
// * The last iteration's V-cycle, whose z no one uses, is not run.
// * Fixed-order reductions, no atomics: every CTA reduces its warps in
//   order and pushes its sum to every CTA; every warp adds the 16 sums the
//   same way.  Two runs from the same state give the same bits.
// * One 16-CTA cluster of 1024 threads per CTA: at the 128^2 cavity a CTA
//   owns 1,041 rows of level 0, one or two per thread.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstring>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kCtas = 16;
constexpr int kMaxWidth = 32;   // band offsets and ELL widths
constexpr int kMaxLevels = 8;   // the band level, ELL levels, the coarse

// The plan's descriptor (cuda_amg.py: HEADER, FIELDS): a header, then one
// row of fields per level.  Offsets: s_* bytes into every CTA's dynamic
// shared memory, g_* elements into the packs of values and indices.
enum Header {
  kNlev, kNdist, kIters, kSR, kSAp, kSZp,
  kSMask,   // -1: mean free
  kSWork,   // a CTA's work buffer: the neighbourhood, restriction terms
  kHeader
};
enum Field {
  kN,       // rows of the level
  kRows,    // rows one CTA owns (distributed, and a replicated level's input)
  kMagic,   // owner of row j: __umulhi(j, magic) == j / rows
  kWidth,   // ELL width
  kSwidth,  // members per row of the next level
  kHalo,    // distributed: the farthest column from its row
  kReach,   // distributed: the farthest column from the CTA's rows that
            // the restriction into its coarse rows reads
  kGVals, kGCols, kGDinv, kGWdinv, kGCdinv, kGAgg, kGRtab,
  kSVals, kSCols, kSDinv, kSWdinv, kSCdinv, kSAgg, kSRtab, kSScr,
  kSIn,     // the owned slice of the input that the level above restricts
  kSB, kSR0, kSX2,
  kFields
};

template <typename T>
struct AmgParams {
  int h[kHeader];
  int lv[kMaxLevels][kFields];
  double c[kMaxLevels];  // the smoother constant c of each level
  int K;                 // band offsets
  int off[kMaxWidth];
  const T* band;  // (K, n) level 0
  const T* tpack;
  const int* ipack;
  const T* b;
  const T* x0;
  const T* mask;  // masked: (n,), else null
  T* x;
  T* r;
};

// sum of term(w) over w < W, in order
template <typename T, class F>
__device__ __forceinline__ T width_sum(int W, F term) {
  T acc = T(0);
#pragma unroll 4
  for (int w = 0; w < W; ++w) acc += term(w);
  return acc;
}

// One level's descriptor and this CTA's rows of it.
struct Lvl {
  const int* f;
  int n, R, lo, here;
  unsigned magic;
  __device__ Lvl(const int* f_, int rank) : f(f_) {
    n = f[kN];
    R = f[kRows];
    magic = (unsigned)f[kMagic];
    lo = rank * R;
    here = max(0, min(R, n - lo));
  }
  __device__ int owner(int j) const { return (int)__umulhi((unsigned)j, magic); }
};

template <typename T>
struct Solver {
  using P = Pair<T>;
  const AmgParams<T>& a;
  cg::cluster_group& cluster;
  char* s;                // this CTA's dynamic shared memory
  char* const* base;      // every rank's, in the generic address space
  T* red;                 // [3 slots][2 values][kCtas]
  T* wpart;               // [kWarps][2]
  const int* off;         // level 0's offsets, signed: |off| <= n / 2
  T* work;
  int rank, tid;
  bool masked;

  __device__ Solver(const AmgParams<T>& a_, cg::cluster_group& c, char* s_,
                    char* const* base_, T* red_, T* wpart_, const int* off_)
      : a(a_), cluster(c), s(s_), base(base_), red(red_), wpart(wpart_),
        off(off_) {
    rank = (int)cluster.block_rank();
    tid = threadIdx.x;
    masked = a.h[kSMask] >= 0;
    work = loc<T>(a.h[kSWork]);
  }

  template <class U>
  __device__ U* loc(int o) const {
    return reinterpret_cast<U*>(s + o);
  }
  template <class U>
  __device__ const U* at(int q, int o) const {
    return reinterpret_cast<const U*>((q == rank ? s : base[q]) + o);
  }

  // Sum of v0 and v1 over the cluster, bit-identical in every thread;
  // ends with the cluster barrier that publishes the phase's vectors.
  __device__ void reduce(int slot, T v0, T v1, T& out0, T& out1) {
    const int lane = tid & 31, warp = tid >> 5;
    v0 = warp_total(v0);
    v1 = warp_total(v1);
    if (lane == 0) {
      wpart[2 * warp] = v0;
      wpart[2 * warp + 1] = v1;
    }
    __syncthreads();
    if (warp == 0) {
      const T s0 = warp_total(wpart[2 * lane]);
      const T s1 = warp_total(wpart[2 * lane + 1]);
      if (lane < kCtas) {
        T* d0 = &red[(2 * slot) * kCtas + rank];
        T* d1 = &red[(2 * slot + 1) * kCtas + rank];
        *cluster.map_shared_rank(d0, lane) = s0;
        *cluster.map_shared_rank(d1, lane) = s1;
      }
    }
    cluster_barrier();
    out0 = warp_total(lane < kCtas ? red[(2 * slot) * kCtas + lane] : T(0));
    out1 = warp_total(lane < kCtas ? red[(2 * slot + 1) * kCtas + lane]
                                   : T(0));
  }

  // ---- the neighbourhood of a CTA's rows -----------------------------------

  // work[e] = val(q, l) of row j = lo - H + e (mod n), (q, l) its owner and
  // index there, for e < R + 2H: every value this CTA's rows of a
  // distributed level read, fetched once, the remote ones all in flight at
  // once.  Ends with a block barrier.
  template <class F>
  __device__ void fill(const Lvl& L, int H, F val) {
    const int m = L.R + 2 * H;
    for (int e = tid; e < m; e += kThreads) {
      int j = L.lo - H + e;
      j += (j < 0) ? L.n : 0;
      j -= (j >= L.n) ? L.n : 0;
      const int q = L.owner(j);
      work[e] = val(q, j - q * L.R);
    }
    __syncthreads();
  }

  // where fill put row c (within H rows of this CTA's, either way round)
  __device__ int slot(const Lvl& L, int H, int c) const {
    int e = c - L.lo + H;
    e += (e < 0) ? L.n : 0;
    e -= (e >= L.n) ? L.n : 0;
    return e;
  }

  // (A v)_i at own row li from the filled neighbourhood: level 0 the band,
  // A' = m A m + (1 - m) with vi = v_i (work holding m v), else the ELL row
  __device__ T apply(const Lvl& L, int k, int li, T vi) const {
    const int H = L.f[kHalo];
    T acc;
    if (k == 0) {
      const T* band = loc<T>(L.f[kSVals]);
      acc = width_sum<T>(a.K, [&](int kk) {
        return band[kk * L.R + li] * work[H + li + off[kk]];
      });
      if (masked) {
        const T mi = loc<T>(a.h[kSMask])[li];
        acc = mi * acc + (T(1) - mi) * vi;
      }
    } else {
      const T* vals = loc<T>(L.f[kSVals]);
      const int* cols = loc<int>(L.f[kSCols]);
      acc = width_sum<T>(L.f[kWidth], [&](int w) {
        return vals[w * L.R + li] * work[slot(L, H, cols[w * L.R + li])];
      });
    }
    return acc;
  }

  // P(r - alpha Ap) at a row, from its r, Ap and mask
  __device__ T rnew(T r, T ap, T m, T alpha, T mean) const {
    const T v = sub_rn(r, mul_rn(alpha, ap));
    return masked ? mul_rn(m, v) : sub_rn(v, mean);
  }
  __device__ T mask_at(int q, int l) const {
    return masked ? at<T>(q, a.h[kSMask])[l] : T(1);
  }
  // m v at level 0 (the vector A' multiplies by m first)
  __device__ T masked_at(int q, int l, T v) const {
    return masked ? mul_rn(mask_at(q, l), v) : v;
  }
  // the projected z of a row from its raw V-cycle output
  __device__ T zfin(T z, T m, T mean_z) const {
    return masked ? mul_rn(m, z) : sub_rn(z, mean_z);
  }

  // ---- the phases ---------------------------------------------------------

  // r = P(b - A' x0), x = x0, Ap = 0, p = 0; returns sum r
  __device__ T prelude(const Lvl& L0) {
    const int sr = a.h[kSR], sap = a.h[kSAp];
    P* zp = loc<P>(a.h[kSZp]);
    fill(L0, L0.f[kHalo], [&](int q, int l) {
      return masked_at(q, l, __ldg(a.x0 + q * L0.R + l));
    });
    T part = T(0);
    for (int li = tid; li < L0.here; li += kThreads) {
      const int i = L0.lo + li;
      const T x0i = __ldg(a.x0 + i);
      T ri = a.b[i] - apply(L0, 0, li, x0i);
      if (masked) ri *= loc<T>(a.h[kSMask])[li];
      loc<T>(sr)[li] = ri;
      loc<T>(sap)[li] = T(0);
      zp[li] = P{T(0), T(0)};
      zp[L0.R + li] = P{T(0), T(0)};
      a.x[i] = x0i;
      part += ri;
    }
    T sum, unused;
    reduce(1, part, T(0), sum, unused);
    return sum;
  }

  // x += alpha p (update_x); r0 = b - A' x1 with b = P(r - alpha Ap) and
  // x1 = w D^-1 b, the neighbours' b and x1 recomputed from their r and Ap
  __device__ void phase_b(const Lvl& L0, T alpha, T mean, bool update_x,
                          int curn) {
    const int sr = a.h[kSR], sap = a.h[kSAp], swd = L0.f[kSWdinv];
    const T* r = loc<T>(sr);
    const T* ap = loc<T>(sap);
    const T* wd = loc<T>(swd);
    const P* zp = loc<P>(a.h[kSZp]) + curn * L0.R;
    T* r0 = loc<T>(L0.f[kSR0]);
    fill(L0, L0.f[kHalo], [&](int q, int l) {
      const T bj = rnew(at<T>(q, sr)[l], at<T>(q, sap)[l], mask_at(q, l),
                        alpha, mean);
      return masked_at(q, l, mul_rn(at<T>(q, swd)[l], bj));
    });
    for (int li = tid; li < L0.here; li += kThreads) {
      const int i = L0.lo + li;
      if (update_x) a.x[i] = add_rn(a.x[i], mul_rn(alpha, zp[li].y));
      const T bi = rnew(r[li], ap[li], mask_at(rank, li), alpha, mean);
      r0[li] = bi - apply(L0, 0, li, mul_rn(wd[li], bi));
    }
    cluster_barrier();
  }

  // The smoothed restriction of distributed level k into the owned slice
  // of level k + 1's input: for each member j of an owned coarse row,
  // rs_j = r0_j - c (A (D^-1 r0))_j, summed over the members in order.
  // The members' neighbourhood (their D^-1 r0, m D^-1 r0 at level 0) is
  // filled first; the terms go to the (z, p) buffer that no one reads
  // during a V-cycle (curn ^ 1).  Level 0 also stores r = P(r - alpha Ap)
  // (its last reader was phase b) and returns its sum.
  __device__ T restrict_dist(int k, T alpha, T mean, int curn) {
    const Lvl L(a.lv[k], rank), N(a.lv[k + 1], rank);
    const int S = L.f[kSwidth], H = L.f[kReach];
    const int sr0 = L.f[kSR0], sdv = L.f[kSDinv], sv = L.f[kSVals];
    const int* rtab = loc<int>(L.f[kSRtab]);
    T* scr = loc<T>(a.h[kSZp]) + (curn ^ 1) * 2 * a.lv[0][kRows];
    const T ck = T(a.c[k]);
    fill(L, H, [&](int q, int l) {
      const T v = mul_rn(at<T>(q, sdv)[l], at<T>(q, sr0)[l]);
      return k == 0 ? masked_at(q, l, v) : v;
    });
    const int slots = N.here * S;
    for (int t = tid; t < slots; t += kThreads) {
      const int j = rtab[t];
      if (j < 0) {  // a pad adds 0
        scr[t] = T(0);
        continue;
      }
      const int q = L.owner(j), l = j - q * L.R;
      const T r0j = at<T>(q, sr0)[l];
      T acc;
      if (k == 0) {
        acc = width_sum<T>(a.K, [&](int kk) {
          return at<T>(q, sv)[kk * L.R + l] * work[slot(L, H, j + off[kk])];
        });
        if (masked) {
          const T mj = mask_at(q, l);
          acc = mj * acc + (T(1) - mj) * mul_rn(at<T>(q, sdv)[l], r0j);
        }
      } else {
        const int sc = L.f[kSCols];
        acc = width_sum<T>(L.f[kWidth], [&](int w) {
          return at<T>(q, sv)[w * L.R + l] *
                 work[slot(L, H, at<int>(q, sc)[w * L.R + l])];
        });
      }
      scr[t] = sub_rn(r0j, mul_rn(ck, acc));
    }
    T part = T(0);
    if (k == 0) {
      T* r = loc<T>(a.h[kSR]);
      const T* ap = loc<T>(a.h[kSAp]);
      for (int li = tid; li < L.here; li += kThreads) {
        const T v = rnew(r[li], ap[li], mask_at(rank, li), alpha, mean);
        r[li] = v;
        part += v;
      }
    }
    __syncthreads();
    T* in = loc<T>(N.f[kSIn]);
    for (int al = tid; al < N.here; al += kThreads)
      in[al] = width_sum<T>(S, [&](int w) { return scr[al * S + w]; });
    T total = T(0), unused;
    if (k == 0)
      reduce(1, part, T(0), total, unused);
    else
      cluster_barrier();
    return total;
  }

  // r0 = b - A x1, x1 = w D^-1 b, at distributed ELL level k >= 1
  __device__ void presmooth_dist(int k) {
    const Lvl L(a.lv[k], rank);
    const int sb = L.f[kSB], swd = L.f[kSWdinv];
    const T* b = loc<T>(sb);
    T* r0 = loc<T>(L.f[kSR0]);
    fill(L, L.f[kHalo], [&](int q, int l) {
      return mul_rn(at<T>(q, swd)[l], at<T>(q, sb)[l]);
    });
    for (int li = tid; li < L.here; li += kThreads)
      r0[li] = b[li] - apply(L, k, li, T(0));
    cluster_barrier();
  }
  // The replicated levels d .. nlev-1 and the coarse pseudo-inverse, the
  // whole V-cycle below the distributed levels, in every CTA
  __device__ void tail() {
    const int d = a.h[kNdist], nlev = a.h[kNlev];
    {
      const Lvl L(a.lv[d], rank);
      T* b = loc<T>(L.f[kSB]);
      const int sin = L.f[kSIn];
      for (int i = tid; i < L.n; i += kThreads) {
        const int q = L.owner(i);
        b[i] = at<T>(q, sin)[i - q * L.R];
      }
      __syncthreads();
    }
    for (int k = d; k < nlev; ++k) {
      const int* f = a.lv[k];
      const int n = f[kN], W = f[kWidth], S = f[kSwidth];
      const int nn = a.lv[k + 1][kN];
      const T* vals = loc<T>(f[kSVals]);
      const int* cols = loc<int>(f[kSCols]);
      const T* b = loc<T>(f[kSB]);
      const T* wd = loc<T>(f[kSWdinv]);
      const T* dv = loc<T>(f[kSDinv]);
      const int* rtab = loc<int>(f[kSRtab]);
      T* r0 = loc<T>(f[kSR0]);
      T* scr = loc<T>(f[kSScr]);
      for (int i = tid; i < n; i += kThreads) {
        const T acc = width_sum<T>(W, [&](int w) {
          const int col = cols[w * n + i];
          return vals[w * n + i] * mul_rn(wd[col], b[col]);
        });
        r0[i] = b[i] - acc;
      }
      __syncthreads();
      const T ck = T(a.c[k]);
      for (int t = tid; t < nn * S; t += kThreads) {
        const int j = rtab[t];
        if (j < 0) {
          scr[t] = T(0);
          continue;
        }
        const T acc = width_sum<T>(W, [&](int w) {
          const int col = cols[w * n + j];
          return vals[w * n + j] * mul_rn(dv[col], r0[col]);
        });
        scr[t] = sub_rn(r0[j], mul_rn(ck, acc));
      }
      __syncthreads();
      T* bn = loc<T>(a.lv[k + 1][kSB]);
      for (int al = tid; al < nn; al += kThreads)
        bn[al] = width_sum<T>(S, [&](int w) { return scr[al * S + w]; });
      __syncthreads();
    }
    {
      // x_c = pinv b_c: one half-warp per row, lanes over the columns; the
      // pseudo-inverse in shared memory or, where it does not fit, read
      // from the pack (L2)
      const int* f = a.lv[nlev];
      const int nc = f[kN];
      const T* pinv = f[kSVals] >= 0 ? loc<T>(f[kSVals]) : a.tpack + f[kGVals];
      const T* bc = loc<T>(f[kSB]);
      T* xc = loc<T>(f[kSR0]);
      const int lane = tid & 15;
      const unsigned half = 0xffffu << (tid & 16);
      for (int row = tid >> 4; row < nc; row += kThreads / 16) {
        T acc = T(0);
        for (int e = lane; e < nc; e += 16) acc += pinv[row * nc + e] * bc[e];
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) acc += __shfl_xor_sync(half, acc, o);
        if (lane == 0) xc[row] = acc;
      }
      __syncthreads();
    }
    for (int k = nlev - 1; k >= d; --k) {
      const int* f = a.lv[k];
      const int n = f[kN], W = f[kWidth];
      const T* vals = loc<T>(f[kSVals]);
      const int* cols = loc<int>(f[kSCols]);
      const T* b = loc<T>(f[kSB]);
      const T* wd = loc<T>(f[kSWdinv]);
      const T* cd = loc<T>(f[kSCdinv]);
      const int* agg = loc<int>(f[kSAgg]);
      const T* xn = loc<T>(a.lv[k + 1][kSR0]);
      T* x2 = loc<T>(f[kSX2]);
      T* x3 = loc<T>(f[kSR0]);
      for (int i = tid; i < n; i += kThreads) {
        const T acc = width_sum<T>(W, [&](int w) {
          return vals[w * n + i] * xn[agg[cols[w * n + i]]];
        });
        const T x1 = mul_rn(wd[i], b[i]);
        x2[i] = add_rn(x1, sub_rn(xn[agg[i]], mul_rn(cd[i], acc)));
      }
      __syncthreads();
      for (int i = tid; i < n; i += kThreads) {
        const T acc = width_sum<T>(W, [&](int w) {
          return vals[w * n + i] * x2[cols[w * n + i]];
        });
        x3[i] = add_rn(x2[i], mul_rn(wd[i], sub_rn(b[i], acc)));
      }
      __syncthreads();
    }
  }

  // The coarse correction x2 = x1 + (y - c D^-1 A y), y_j = x_c[agg_j], at
  // distributed level k, reading x_c where level k + 1 keeps it
  __device__ void prolong_dist(int k) {
    const Lvl L(a.lv[k], rank), N(a.lv[k + 1], rank);
    const bool local = k + 1 >= a.h[kNdist];
    const int sagg = L.f[kSAgg], sxn = N.f[kSR0];
    auto xn = [&](int idx) -> T {
      if (local) return loc<T>(sxn)[idx];
      const int q = N.owner(idx);
      return at<T>(q, sxn)[idx - q * N.R];
    };
    const T* wd = loc<T>(L.f[kSWdinv]);
    const T* b = loc<T>(k == 0 ? a.h[kSR] : L.f[kSB]);
    const int* agg = loc<int>(sagg);
    const T* cd = a.tpack + L.f[kGCdinv];
    T* x2 = loc<T>(L.f[kSX2]);
    fill(L, L.f[kHalo], [&](int q, int l) {
      const T y = xn(at<int>(q, sagg)[l]);
      return k == 0 ? masked_at(q, l, y) : y;
    });
    for (int li = tid; li < L.here; li += kThreads) {
      const T yi = xn(agg[li]);
      const T ay = apply(L, k, li, yi);
      const T x1 = mul_rn(wd[li], b[li]);
      x2[li] = add_rn(x1, sub_rn(yi, mul_rn(__ldg(cd + L.lo + li), ay)));
    }
    cluster_barrier();
  }

  // The post-smoothing sweep x3 = x2 + w D^-1 (b - A x2) at distributed
  // level k.  Level 0 stores z_raw = x3 beside p and returns, summed over
  // the cluster, sum z_raw and r.z (mean free: r.z_raw; masked: r.(m z))
  __device__ void postsmooth_dist(int k, int curn, T& sz, T& rz) {
    const Lvl L(a.lv[k], rank);
    const int sx2 = L.f[kSX2];
    const T* x2 = loc<T>(sx2);
    const T* wd = loc<T>(L.f[kSWdinv]);
    const T* b = loc<T>(k == 0 ? a.h[kSR] : L.f[kSB]);
    fill(L, L.f[kHalo], [&](int q, int l) {
      const T v = at<T>(q, sx2)[l];
      return k == 0 ? masked_at(q, l, v) : v;
    });
    T part0 = T(0), part1 = T(0);
    for (int li = tid; li < L.here; li += kThreads) {
      const T ax = apply(L, k, li, x2[li]);
      const T x3 = add_rn(x2[li], mul_rn(wd[li], sub_rn(b[li], ax)));
      if (k == 0) {
        loc<P>(a.h[kSZp])[curn * L.R + li].x = x3;
        part0 += x3;
        part1 += b[li] * (masked ? mul_rn(mask_at(rank, li), x3) : x3);
      } else {
        loc<T>(L.f[kSR0])[li] = x3;
      }
    }
    if (k == 0)
      reduce(2, part0, part1, sz, rz);
    else
      cluster_barrier();
  }

  // p = P z + beta p_old into buffer cur ^ 1, Ap = A' p; returns p.Ap and
  // sum Ap over the cluster
  __device__ void phase_a(const Lvl& L0, T beta, T mean_z, int cur, T& pap,
                          T& sap) {
    const P* zc = loc<P>(a.h[kSZp]) + cur * L0.R;
    P* zn = loc<P>(a.h[kSZp]) + (cur ^ 1) * L0.R;
    const int szc = a.h[kSZp] + cur * L0.R * (int)sizeof(P);
    T* ap = loc<T>(a.h[kSAp]);
    fill(L0, L0.f[kHalo], [&](int q, int l) {
      const P pr = at<P>(q, szc)[l];
      const T m = mask_at(q, l);
      const T p = add_rn(zfin(pr.x, m, mean_z), mul_rn(beta, pr.y));
      return masked ? mul_rn(m, p) : p;
    });
    T part0 = T(0), part1 = T(0);
    for (int li = tid; li < L0.here; li += kThreads) {
      const P own = zc[li];
      const T pi = add_rn(zfin(own.x, mask_at(rank, li), mean_z),
                          mul_rn(beta, own.y));
      zn[li].y = pi;
      const T api = apply(L0, 0, li, pi);
      ap[li] = api;
      part0 += pi * api;
      part1 += api;
    }
    reduce(0, part0, part1, pap, sap);
  }

  // One V-cycle on b = P(r - alpha Ap), z_raw into buffer curn; returns
  // sum z_raw, r.z and sum r over the cluster
  __device__ void vcycle(T alpha, T mean, bool update_x, int curn, T& sz,
                         T& rz, T& sr) {
    const Lvl L0(a.lv[0], rank);
    const int d = a.h[kNdist];
    phase_b(L0, alpha, mean, update_x, curn);
    sr = restrict_dist(0, alpha, mean, curn);
    for (int k = 1; k < d; ++k) {
      presmooth_dist(k);
      restrict_dist(k, alpha, mean, curn);
    }
    tail();
    for (int k = d - 1; k >= 0; --k) {
      prolong_dist(k);
      postsmooth_dist(k, curn, sz, rz);
    }
  }

  __device__ void run() {
    const Lvl L0(a.lv[0], rank);
    const T nf = T(L0.n);
    const int iters = a.h[kIters];
    T sr = prelude(L0);
    T alpha = T(0), sap = T(0), sz, rz, rz_new, beta = T(0), mean_z = T(0);
    int cur = 0;
    if (iters > 0) {
      vcycle(T(0), masked ? T(0) : sr / nf, false, 0, sz, rz, sr);
      mean_z = masked ? T(0) : sz / nf;
      if (!masked) rz = rz - mean_z * sr;
    }
    for (int it = 0; it < iters; ++it) {
      T pap;
      phase_a(L0, beta, mean_z, cur, pap, sap);
      alpha = nonzero(pap) ? rz / pap : T(0);
      cur ^= 1;
      if (it + 1 == iters) break;  // the last z is never used
      const T mean = masked ? T(0) : (sr - alpha * sap) / nf;
      vcycle(alpha, mean, true, cur, sz, rz_new, sr);
      mean_z = masked ? T(0) : sz / nf;
      if (!masked) rz_new = rz_new - mean_z * sr;
      beta = nonzero(rz) ? rz_new / rz : T(0);
      rz = rz_new;
    }
    // x += alpha p, r = P(r - alpha Ap): written out
    const T mean = masked ? T(0) : (sr - alpha * sap) / nf;
    const T* r = loc<T>(a.h[kSR]);
    const T* ap = loc<T>(a.h[kSAp]);
    const P* zp = loc<P>(a.h[kSZp]) + cur * L0.R;
    for (int li = tid; li < L0.here; li += kThreads) {
      const int i = L0.lo + li;
      if (iters > 0) a.x[i] = add_rn(a.x[i], mul_rn(alpha, zp[li].y));
      a.r[i] = rnew(r[li], ap[li], mask_at(rank, li), alpha, mean);
    }
    // no CTA leaves while another may still read its shared memory
    cluster.sync();
  }
};

// Copy this CTA's part of every level from the packs into shared memory.
template <typename T>
__device__ void load_levels(const AmgParams<T>& a, char* s, int rank) {
  const int tid = threadIdx.x, nlev = a.h[kNlev], d = a.h[kNdist];
  auto tsh = [&](int o) { return reinterpret_cast<T*>(s + o); };
  auto ish = [&](int o) { return reinterpret_cast<int*>(s + o); };
  for (int k = 0; k <= nlev; ++k) {
    const Lvl L(a.lv[k], rank);
    const int* f = L.f;
    if (k == nlev) {  // coarse: the pseudo-inverse, row-major
      const int nc = L.n;
      if (f[kSVals] < 0) continue;
      for (int e = tid; e < nc * nc; e += kThreads)
        tsh(f[kSVals])[e] = a.tpack[f[kGVals] + e];
      continue;
    }
    const int S = f[kSwidth];
    if (k < d) {  // distributed: the owned rows
      for (int li = tid; li < L.here; li += kThreads) {
        const int i = L.lo + li;
        tsh(f[kSDinv])[li] = a.tpack[f[kGDinv] + i];
        tsh(f[kSWdinv])[li] = a.tpack[f[kGWdinv] + i];
        ish(f[kSAgg])[li] = a.ipack[f[kGAgg] + i];
        if (k == 0) {
          for (int kk = 0; kk < a.K; ++kk)
            tsh(f[kSVals])[kk * L.R + li] = a.band[kk * L.n + i];
          if (a.mask) tsh(a.h[kSMask])[li] = a.mask[i];
        } else {
          for (int w = 0; w < f[kWidth]; ++w) {
            tsh(f[kSVals])[w * L.R + li] = a.tpack[f[kGVals] + w * L.n + i];
            ish(f[kSCols])[w * L.R + li] = a.ipack[f[kGCols] + w * L.n + i];
          }
        }
      }
      const Lvl N(a.lv[k + 1], rank);
      for (int t = tid; t < N.here * S; t += kThreads)
        ish(f[kSRtab])[t] = a.ipack[f[kGRtab] + N.lo * S + t];
    } else {  // replicated: the whole level
      const int n = L.n;
      for (int i = tid; i < n; i += kThreads) {
        tsh(f[kSDinv])[i] = a.tpack[f[kGDinv] + i];
        tsh(f[kSWdinv])[i] = a.tpack[f[kGWdinv] + i];
        tsh(f[kSCdinv])[i] = a.tpack[f[kGCdinv] + i];
        ish(f[kSAgg])[i] = a.ipack[f[kGAgg] + i];
      }
      for (int e = tid; e < f[kWidth] * n; e += kThreads) {
        tsh(f[kSVals])[e] = a.tpack[f[kGVals] + e];
        ish(f[kSCols])[e] = a.ipack[f[kGCols] + e];
      }
      const int nn = a.lv[k + 1][kN];
      for (int t = tid; t < nn * S; t += kThreads)
        ish(f[kSRtab])[t] = a.ipack[f[kGRtab] + t];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
amg_pcg_cluster_kernel(const __grid_constant__ AmgParams<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_off[kMaxWidth];
  __shared__ T red[3 * 2 * kCtas];
  __shared__ T wpart[2 * kWarps];
  __shared__ char* s_base[kCtas];
  cg::cluster_group cluster = cg::this_cluster();
  char* s = reinterpret_cast<char*>(smem_raw);
  const int rank = (int)cluster.block_rank();
  // level 0's offsets, signed (a neighbour within n / 2 either way)
  const int n0 = a.lv[0][kN];
  for (int k = threadIdx.x; k < a.K; k += blockDim.x)
    s_off[k] = a.off[k] <= n0 / 2 ? a.off[k] : a.off[k] - n0;
  if (threadIdx.x < kCtas)
    s_base[threadIdx.x] = cluster.map_shared_rank(s, threadIdx.x);
  load_levels<T>(a, s, rank);
  // every slice is loaded before any CTA reads a neighbour's
  cluster.sync();
  Solver<T> solver(a, cluster, s, s_base, red, wpart, s_off);
  solver.run();
}

template <typename T>
const void* kernel_of() {
  return (const void*)amg_pcg_cluster_kernel<T>;
}

cudaLaunchConfig_t cluster_config(int smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCtas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCtas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Opt the kernel into all the dynamic shared memory a block may have beside
// its static arrays (so that no plan lowers another plan's limit) and a
// 16-CTA cluster, and check that one cluster with `smem` bytes of dynamic
// shared memory per CTA can be resident.
template <typename T>
int amg_prepare(int smem, int masked) {
  const void* fn = kernel_of<T>();
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)fa.sharedSizeBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(smem, nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (err != cudaSuccess) return (int)err;
  return clusters >= 1 ? 0 : (int)cudaErrorLaunchOutOfResources;
}

template <typename T>
int amg_launch(const int* desc, const double* cs, const int* offs, int K,
               int smem, const T* band, const T* tpack, const int* ipack,
               const T* b, const T* x0, const T* mask, T* x, T* r,
               cudaStream_t stream) {
  AmgParams<T> a;
  if (K < 1 || K > kMaxWidth || smem < 0) return (int)cudaErrorInvalidValue;
  std::memcpy(a.h, desc, sizeof(a.h));
  std::memset(a.lv, 0, sizeof(a.lv));
  const int nlev = a.h[kNlev], d = a.h[kNdist];
  if (nlev < 1 || nlev + 1 > kMaxLevels || d < 1 || d > nlev ||
      a.h[kIters] < 0 || (mask == nullptr) != (a.h[kSMask] < 0))
    return (int)cudaErrorInvalidValue;
  std::memcpy(a.lv, desc + kHeader, sizeof(int) * kFields * (nlev + 1));
  for (int k = 0; k < kMaxLevels; ++k) a.c[k] = k <= nlev ? cs[k] : 0.0;
  a.K = K;
  for (int k = 0; k < K; ++k) a.off[k] = offs[k];
  a.band = band;
  a.tpack = tpack;
  a.ipack = ipack;
  a.b = b;
  a.x0 = x0;
  a.mask = mask;
  a.x = x;
  a.r = r;
  void* args[] = {&a};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(smem, stream, &attr);
  return (int)cudaLaunchKernelExC(&cfg, kernel_of<T>(), args);
}

}  // namespace

extern "C" {

int ns_amg_pcg_prepare_f32(int smem, int masked) {
  return amg_prepare<float>(smem, masked);
}

int ns_amg_pcg_prepare_f64(int smem, int masked) {
  return amg_prepare<double>(smem, masked);
}

int ns_amg_pcg_f32(const int* desc, const double* cs, const int* offs, int K,
                   int smem, const float* band, const float* tpack,
                   const int* ipack, const float* b, const float* x0,
                   const float* mask, float* x, float* r, void* stream) {
  return amg_launch<float>(desc, cs, offs, K, smem, band, tpack, ipack, b, x0,
                           mask, x, r, (cudaStream_t)stream);
}

int ns_amg_pcg_f64(const int* desc, const double* cs, const int* offs, int K,
                   int smem, const double* band, const double* tpack,
                   const int* ipack, const double* b, const double* x0,
                   const double* mask, double* x, double* r, void* stream) {
  return amg_launch<double>(desc, cs, offs, K, smem, band, tpack, ipack, b,
                            x0, mask, x, r, (cudaStream_t)stream);
}

}  // extern "C"
