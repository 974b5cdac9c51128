// The nonlinear convection of the spectral step on class grids in two
// launches, for Hopper (sm_90a), bound to Python with ctypes.  Built into
// the same library as band.cu (cudalib.py::build_library).
//
// structured/ops.py::StructuredConvection assembles b_i = int (u.grad)u . N_i
// on the class grids U (2^dim, *grid, d) of a periodic P2 velocity, cell by
// cell.  For each cell g of the lattice and each of its ntau congruent
// simplices t (2 triangles in 2D, 6 Kuhn tetrahedra in 3D) it gathers the
// nlu local values X[l] = U[u_class[t, l]][g + u_shift[t, l]] (6 or 10 nodes,
// periodic wrap), walks the rule's nq points (16 in 2D, 64 in 3D),
//
//     u_q = N2 X,   grad u = g2_t X,   c = sum_a (d_a u) u_a,
//     r[l] += (W N2^T)_t[l, q] c,
//
// and scatters r back: out[c][g] = sum over the (t, l) of class c of
// r[t, l][g - u_shift[t, l]].
//
// It replaces no Pallas kernel: the JAX package leaves this chain to XLA,
// which fuses it on the TPU.  Eager torch cannot fuse it, and wrote every
// per-point intermediate to device memory: at 48^3 (G = 110,592 cells, f32)
// the gathered values 80 MB, u_q 0.51 GB, grad u 1.53 GB, c 0.51 GB, r
// 80 MB, and 60 rolls in and 60 out, about 5 GB per call.
//
// Bounds at 48^3, f32: the class grids read once and written once, 21.2 MB,
// take 6.3 us at 3.35 TB/s; the rule's arithmetic, 10,176 FMA per simplex
// per cell (per point: u_q 30, grad u 90, c 9, the test sums 30), is
// 13.5 GFLOP, 0.20 ms at 67 TFLOP/s.  The work is FMA-bound by a factor of
// 30; only r, 80 MB, is left between the two launches (about 27 us written
// and read again).
//
// Design:
// * structured_conv_quadrature_kernel does the gather and the quadrature.
//   One thread per (cell, simplex); a block takes one simplex
//   (blockIdx.y), so its tables are the same for every thread and sit in
//   shared memory, read as broadcasts: per point and local node the four
//   values (N2, d_0 N2, d_1 N2, d_2 N2 or 0) of the packed table, one 16-byte
//   load for 12 FMAs in 3D, and the weighted test functions W N2^T, four
//   nodes a load.  About 13 loads per 168 FMAs a point in 3D, so the FMAs
//   and not the loads set the pace.  The local values and the test sums
//   stay in registers (2 nlu d of them); nothing per point leaves the
//   thread.  Consecutive threads take consecutive cells along the fastest
//   grid axis, so the gathers from U (which L2 holds: 10.6 MB at 48^3) and
//   the stores of r coalesce.  A block takes kQuadThreads cells: a grid of
//   (cells / kQuadThreads, ntau) blocks.  Each block loads its simplex's
//   tables from L2 (13.3 KB f32, 26.6 KB f64 in 3D: under the 48 KB a
//   block has without an opt-in): 69 MB of L2 reads a call at 48^3 f32,
//   a few us beside the FMAs.
// * structured_conv_scatter_kernel sums the contributions: one thread per
//   (class, cell, component), adding r[t, l][g - u_shift[t, l]] over the
//   (t, l) of its class in the order of StructuredConvection.scatter_local
//   (t, then l), from zero.  No atomics: two runs from the same input give
//   the same bits, and so do two replays of a CUDA graph.  Bandwidth-bound:
//   r read once (80 MB at 48^3) and the result written once.
// * The periodic shifts are added with a wrap (the wrapper gives every shift
//   in [0, n) per axis): no roll, no modulo in the inner loops.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTau = 6;    // simplices per cell: 2 in 2D, 6 in 3D
constexpr int kMaxLocal = 10;  // P2 nodes per simplex: 6 in 2D, 10 in 3D
constexpr int kMaxClass = 8;   // velocity classes: 2^dim
constexpr int kQuadThreads = 128;
constexpr int kQuadSmem = 48 * 1024;  // a block's shared memory, no opt-in
constexpr int kScatterThreads = 256;

template <int DIM>
struct Local {
  static constexpr int kNodes = (DIM + 1) * (DIM + 2) / 2;
  static constexpr int kPad = (kNodes + 3) / 4 * 4;
};

// Elements of one simplex's packed tables: per point, kNodes rows of four
// (N2, its DIM derivatives, zero-padded), then kPad weighted test values.
template <int DIM>
__host__ __device__ constexpr int table_stride(int nq) {
  return nq * (4 * Local<DIM>::kNodes + Local<DIM>::kPad);
}

struct Lattice {
  int n[3];   // grid extents; n[2] = 1 in 2D
  int cells;  // n[0] n[1] n[2]
};

struct QuadGeom {
  Lattice lat;
  int nq;
  int cls[kMaxTau * kMaxLocal];       // (t, l) -> class
  int shift[kMaxTau * kMaxLocal][3];  // (t, l) -> + shift, in [0, n)
};

struct ScatterGeom {
  Lattice lat;
  int start[kMaxClass + 1];          // class c: entries start[c] to start[c + 1]
  int tl[kMaxTau * kMaxLocal];       // t nlu + l, in scatter order
  int back[kMaxTau * kMaxLocal][3];  // - shift, in [0, n)
};

__device__ __forceinline__ int wrap(int i, int n) { return i >= n ? i - n : i; }

__device__ __forceinline__ int shifted(const Lattice& lat, int c0, int c1,
                                       int c2, const int (&s)[3]) {
  return (wrap(c0 + s[0], lat.n[0]) * lat.n[1] + wrap(c1 + s[1], lat.n[1])) *
             lat.n[2] +
         wrap(c2 + s[2], lat.n[2]);
}

__device__ __forceinline__ void coords(const Lattice& lat, int g, int& c0,
                                       int& c1, int& c2) {
  c2 = g % lat.n[2];
  const int rest = g / lat.n[2];
  c1 = rest % lat.n[1];
  c0 = rest / lat.n[1];
}

// Four consecutive table values from shared memory (16-byte aligned).
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

template <typename T, int DIM>
__global__ void __launch_bounds__(kQuadThreads)
    structured_conv_quadrature_kernel(const T* __restrict__ U,
                                      const T* __restrict__ tables,
                                      T* __restrict__ R,
                                      const __grid_constant__ QuadGeom geom) {
  constexpr int kNodes = Local<DIM>::kNodes;
  constexpr int kPad = Local<DIM>::kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tab = reinterpret_cast<T*>(smem_raw);
  const int t = blockIdx.y;
  const int nq = geom.nq;
  const int stride = table_stride<DIM>(nq);
  const T* mine = tables + (size_t)t * stride;
  for (int i = threadIdx.x; i < stride; i += blockDim.x) tab[i] = mine[i];
  __syncthreads();
  const T* shape_rows = tab;                  // [q][l][4]
  const T* tests = tab + nq * 4 * kNodes;     // [q][kPad]
  const Lattice& lat = geom.lat;
  const int cells = lat.cells;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < cells) {
    int c0, c1, c2;
    coords(lat, g, c0, c1, c2);
    T x[kNodes][DIM];
#pragma unroll
    for (int l = 0; l < kNodes; ++l) {
      const int k = t * kNodes + l;
      const T* u = U + ((size_t)geom.cls[k] * cells +
                        shifted(lat, c0, c1, c2, geom.shift[k])) *
                           DIM;
#pragma unroll
      for (int e = 0; e < DIM; ++e) x[l][e] = __ldg(u + e);
    }
    T r[kNodes][DIM];
#pragma unroll
    for (int l = 0; l < kNodes; ++l)
#pragma unroll
      for (int e = 0; e < DIM; ++e) r[l][e] = T(0);

    // two points an iteration: 2-7 % faster than one, four no better
#pragma unroll 2
    for (int q = 0; q < nq; ++q) {
      // u_q[e] and grad[a][e] = d_a u_e at the point
      T uq[DIM], grad[DIM][DIM];
      const T* rows = shape_rows + q * 4 * kNodes;
#pragma unroll
      for (int l = 0; l < kNodes; ++l) {
        T v[4];
        load4(rows + 4 * l, v);
#pragma unroll
        for (int e = 0; e < DIM; ++e) {
          if (l == 0) {
            uq[e] = v[0] * x[l][e];
#pragma unroll
            for (int a = 0; a < DIM; ++a) grad[a][e] = v[1 + a] * x[l][e];
          } else {
            uq[e] = fma(v[0], x[l][e], uq[e]);
#pragma unroll
            for (int a = 0; a < DIM; ++a)
              grad[a][e] = fma(v[1 + a], x[l][e], grad[a][e]);
          }
        }
      }
      // c[e] = sum_a d_a u_e u_a
      T c[DIM];
#pragma unroll
      for (int e = 0; e < DIM; ++e) {
        c[e] = grad[0][e] * uq[0];
#pragma unroll
        for (int a = 1; a < DIM; ++a) c[e] = fma(grad[a][e], uq[a], c[e]);
      }
      const T* w = tests + q * kPad;
#pragma unroll
      for (int l4 = 0; l4 < kPad; l4 += 4) {
        T v[4];
        load4(w + l4, v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (l4 + j < kNodes) {
#pragma unroll
            for (int e = 0; e < DIM; ++e)
              r[l4 + j][e] = fma(v[j], c[e], r[l4 + j][e]);
          }
        }
      }
    }
    T* out = R + ((size_t)t * kNodes * cells + g) * DIM;
#pragma unroll
    for (int l = 0; l < kNodes; ++l)
#pragma unroll
      for (int e = 0; e < DIM; ++e) out[(size_t)l * cells * DIM + e] = r[l][e];
  }
}

template <typename T, int DIM>
__global__ void __launch_bounds__(kScatterThreads)
    structured_conv_scatter_kernel(const T* __restrict__ R, T* __restrict__ out,
                                   const __grid_constant__ ScatterGeom geom) {
  const Lattice& lat = geom.lat;
  const int c = blockIdx.y;
  const int items = lat.cells * DIM;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // g DIM + e
  if (i >= items) return;
  const int g = i / DIM, e = i - g * DIM;
  int c0, c1, c2;
  coords(lat, g, c0, c1, c2);
  T acc = T(0);
  // four loads in flight a thread; the sum keeps its order
#pragma unroll 4
  for (int k = geom.start[c]; k < geom.start[c + 1]; ++k)
    acc += __ldg(R + ((size_t)geom.tl[k] * lat.cells +
                      shifted(lat, c0, c1, c2, geom.back[k])) *
                         DIM +
                 e);
  out[(size_t)c * items + i] = acc;
}

// The lattice of the grid (n0, n1[, n2]); false where it is not one.
bool lattice_of(int dim, int n0, int n1, int n2, Lattice* lat) {
  if (dim != 2 && dim != 3) return false;
  if (dim == 2) n2 = 1;
  if (n0 < 1 || n1 < 1 || n2 < 1) return false;
  // the scatter indexes (cell, component) with 32-bit integers
  const long long cells = (long long)n0 * n1 * n2;
  if (cells * dim >= (1LL << 31)) return false;
  lat->n[0] = n0;
  lat->n[1] = n1;
  lat->n[2] = n2;
  lat->cells = (int)cells;
  return true;
}

// The (t, l) shift table as (sign * shift) mod n per axis, zero past dim.
void wrapped_shift(const Lattice& lat, int dim, const int* s, int sign,
                   int (&out)[3]) {
  for (int a = 0; a < 3; ++a) {
    const long long n = lat.n[a];
    const long long v = a < dim ? sign * (long long)s[a] : 0;
    out[a] = (int)(((v % n) + n) % n);
  }
}

template <typename T>
int quad_launch(int dim, int n0, int n1, int n2, int ntau, int nlu, int nq,
                const int* cls, const int* shift, const T* U, const T* tables,
                T* R, cudaStream_t stream) {
  QuadGeom geom;
  if (!lattice_of(dim, n0, n1, n2, &geom.lat) || ntau < 1 || ntau > kMaxTau ||
      nlu != (dim + 1) * (dim + 2) / 2 || nq < 1)
    return (int)cudaErrorInvalidValue;
  geom.nq = nq;
  for (int k = 0; k < ntau * nlu; ++k) {
    if (cls[k] < 0 || cls[k] >= (1 << dim)) return (int)cudaErrorInvalidValue;
    geom.cls[k] = cls[k];
    wrapped_shift(geom.lat, dim, shift + dim * k, 1, geom.shift[k]);
  }
  const long long smem =
      (long long)(dim == 2 ? table_stride<2>(nq) : table_stride<3>(nq)) *
      sizeof(T);
  if (smem > kQuadSmem) return (int)cudaErrorInvalidValue;
  const dim3 grid((geom.lat.cells + kQuadThreads - 1) / kQuadThreads, ntau);
  if (dim == 2)
    structured_conv_quadrature_kernel<T, 2>
        <<<grid, kQuadThreads, smem, stream>>>(U, tables, R, geom);
  else
    structured_conv_quadrature_kernel<T, 3>
        <<<grid, kQuadThreads, smem, stream>>>(U, tables, R, geom);
  return (int)cudaGetLastError();
}

template <typename T>
int scatter_launch(int dim, int n0, int n1, int n2, int ntau, int nlu,
                   const int* cls, const int* shift, const T* R, T* out,
                   cudaStream_t stream) {
  ScatterGeom geom;
  if (!lattice_of(dim, n0, n1, n2, &geom.lat) || ntau < 1 || ntau > kMaxTau ||
      nlu != (dim + 1) * (dim + 2) / 2)
    return (int)cudaErrorInvalidValue;
  const int nclass = 1 << dim;
  // the entries of each class in scatter_local's order: t, then l
  int k = 0;
  for (int c = 0; c < nclass; ++c) {
    geom.start[c] = k;
    for (int tl = 0; tl < ntau * nlu; ++tl) {
      if (cls[tl] < 0 || cls[tl] >= nclass) return (int)cudaErrorInvalidValue;
      if (cls[tl] != c) continue;
      geom.tl[k] = tl;
      wrapped_shift(geom.lat, dim, shift + dim * tl, -1, geom.back[k]);
      ++k;
    }
  }
  geom.start[nclass] = k;
  const int items = geom.lat.cells * dim;
  const dim3 grid((items + kScatterThreads - 1) / kScatterThreads, nclass);
  if (dim == 2)
    structured_conv_scatter_kernel<T, 2>
        <<<grid, kScatterThreads, 0, stream>>>(R, out, geom);
  else
    structured_conv_scatter_kernel<T, 3>
        <<<grid, kScatterThreads, 0, stream>>>(R, out, geom);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ns_structured_conv_quadrature_f32(int dim, int n0, int n1, int n2,
                                      int ntau, int nlu, int nq,
                                      const int* cls, const int* shift,
                                      const float* U, const float* tables,
                                      float* R, void* stream) {
  return quad_launch<float>(dim, n0, n1, n2, ntau, nlu, nq, cls, shift, U,
                            tables, R, (cudaStream_t)stream);
}

int ns_structured_conv_quadrature_f64(int dim, int n0, int n1, int n2,
                                      int ntau, int nlu, int nq,
                                      const int* cls, const int* shift,
                                      const double* U, const double* tables,
                                      double* R, void* stream) {
  return quad_launch<double>(dim, n0, n1, n2, ntau, nlu, nq, cls, shift, U,
                             tables, R, (cudaStream_t)stream);
}

int ns_structured_conv_scatter_f32(int dim, int n0, int n1, int n2, int ntau,
                                   int nlu, const int* cls, const int* shift,
                                   const float* R, float* out, void* stream) {
  return scatter_launch<float>(dim, n0, n1, n2, ntau, nlu, cls, shift, R, out,
                               (cudaStream_t)stream);
}

int ns_structured_conv_scatter_f64(int dim, int n0, int n1, int n2, int ntau,
                                   int nlu, const int* cls, const int* shift,
                                   const double* R, double* out,
                                   void* stream) {
  return scatter_launch<double>(dim, n0, n1, n2, ntau, nlu, cls, shift, R,
                                out, (cudaStream_t)stream);
}

}  // extern "C"
