// Native host-side mesh/topology kernels (counterpart of
// navierstokes_tpu/native/fastmesh.cpp, with the same C interface).
//
// Setup-time work only: the deduplication of facet and edge rows when a
// mesh builds its topology, and the ELL transpose tables of the cell-loop
// operators.  navierstokes_tpu_torch.native builds this file with g++ at
// first use and loads it with ctypes; the NumPy versions it replaces stay
// in the package (mesh/core.py::unique_rows,
// parallel/sharded.py::_numpy_scatter_transpose) and are selected with
// NS_TPU_NO_NATIVE=1.
//
//   unique_rows_i32     -- deduplicate fixed-width int32 rows
//                          (np.unique(axis=0) semantics: unique rows in
//                          lexicographic order, inverse map, counts)
//   build_transpose_i32 -- counting-sort ELL transpose table
//                          (node -> contributing flat slots, padded)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

// The packed branch's first pass buckets the keys on their top
// kBucketBits bits (a mesh's rows, in cell order, land in nearby
// buckets); each bucket is then sorted on its own, by insertion sort up
// to kInsertionMax rows.
constexpr int kBucketBits = 18;
constexpr long long kInsertionMax = 32;

// base ** width when it is below 2 ** 62 (so each row packs into one
// non-negative 64-bit key whose order is the rows' lexicographic order),
// else 0.
uint64_t packed_range(uint64_t base, int width) {
    const uint64_t limit = uint64_t(1) << 62;
    uint64_t range = 1;
    for (int k = 0; k < width; ++k) {
        if (range > (limit - 1) / base) return 0;
        range *= base;
    }
    return range;
}

using KeyRow = std::pair<uint64_t, long long>;

// Packed-key branch of unique_rows_i32: each row becomes one key; a
// counting pass on the keys' top bits buckets (key, row) pairs, each
// bucket is sorted (insertion sort when small), and one scan of the
// sorted keys emits the unique rows.
long long unique_packed(const int32_t* rows, long long n_rows, int width,
                        uint64_t base, uint64_t range, int32_t* out_unique,
                        long long* out_inverse, long long* out_counts) {
    std::vector<uint64_t> key(n_rows);
    for (long long i = 0; i < n_rows; ++i) {
        const int32_t* r = rows + i * width;
        uint64_t k = static_cast<uint64_t>(r[0]);
        for (int j = 1; j < width; ++j)
            k = k * base + static_cast<uint64_t>(r[j]);
        key[i] = k;
    }
    int bits = 0;
    while (bits < 64 && (range - 1) >> bits) ++bits;
    const int bucket_bits = std::min(bits, kBucketBits);
    const int shift = bits - bucket_bits;
    const long long n_buckets = 1LL << bucket_bits;

    std::vector<long long> start(n_buckets + 1, 0);
    for (long long i = 0; i < n_rows; ++i) ++start[(key[i] >> shift) + 1];
    for (long long b = 0; b < n_buckets; ++b) start[b + 1] += start[b];
    std::vector<KeyRow> sorted(n_rows);
    {
        std::vector<long long> pos(start.begin(), start.end() - 1);
        for (long long i = 0; i < n_rows; ++i)
            sorted[pos[key[i] >> shift]++] = {key[i], i};
    }
    for (long long b = 0; b < n_buckets; ++b) {
        auto first = sorted.begin() + start[b];
        auto last = sorted.begin() + start[b + 1];
        if (last - first > kInsertionMax) {
            std::sort(first, last);
            continue;
        }
        for (auto it = first; it != last; ++it) {
            KeyRow v = *it;
            auto j = it;
            for (; j != first && (j - 1)->first > v.first; --j) *j = *(j - 1);
            *j = v;
        }
    }

    long long n_unique = 0;
    for (long long i = 0; i < n_rows; ++i) {
        const long long idx = sorted[i].second;
        if (i == 0 || sorted[i].first != sorted[i - 1].first) {
            std::memcpy(out_unique + n_unique * width, rows + idx * width,
                        sizeof(int32_t) * width);
            if (out_counts) out_counts[n_unique] = 0;
            ++n_unique;
        }
        out_inverse[idx] = n_unique - 1;
        if (out_counts) out_counts[n_unique - 1] += 1;
    }
    return n_unique;
}

}  // namespace

extern "C" {

// Returns the number of unique rows; fills out_unique (capacity
// n_rows*width), out_inverse (n_rows), out_counts (capacity n_rows).
// Rows of non-negative entries with base ** width < 2 ** 62 (base = the
// largest entry + 1) are sorted by packed key; other rows by the row
// comparison.  Both give the same three arrays.
long long unique_rows_i32(const int32_t* rows, long long n_rows, int width,
                          int32_t* out_unique, long long* out_inverse,
                          long long* out_counts) {
    if (n_rows <= 0) return 0;
    const auto [lo, hi] = std::minmax_element(rows, rows + n_rows * width);
    const uint64_t base = static_cast<uint64_t>(*hi) + 1;
    const uint64_t range = *lo >= 0 ? packed_range(base, width) : 0;
    if (range != 0)
        return unique_packed(rows, n_rows, width, base, range, out_unique,
                             out_inverse, out_counts);

    std::vector<long long> order(n_rows);
    std::iota(order.begin(), order.end(), 0LL);
    auto less = [rows, width](long long a, long long b) {
        const int32_t* ra = rows + a * width;
        const int32_t* rb = rows + b * width;
        for (int k = 0; k < width; ++k) {
            if (ra[k] != rb[k]) return ra[k] < rb[k];
        }
        return false;
    };
    std::sort(order.begin(), order.end(), less);

    auto equal = [rows, width](long long a, long long b) {
        return std::memcmp(rows + a * width, rows + b * width,
                           sizeof(int32_t) * width) == 0;
    };

    long long n_unique = 0;
    for (long long i = 0; i < n_rows; ++i) {
        long long idx = order[i];
        if (i == 0 || !equal(idx, order[i - 1])) {
            std::memcpy(out_unique + n_unique * width, rows + idx * width,
                        sizeof(int32_t) * width);
            if (out_counts) out_counts[n_unique] = 0;
            ++n_unique;
        }
        out_inverse[idx] = n_unique - 1;
        if (out_counts) out_counts[n_unique - 1] += 1;
    }
    return n_unique;
}

// Counting-sort transpose table.  flat_nodes: n_flat values in
// [0, n_nodes).  out_table has capacity n_nodes * k; pad entries are
// n_flat.  If k <= 0, only computes and returns the required K (max
// valence) without writing the table.  Returns K, or -1 if k < K.
// Slots fill in increasing flat index: the order of a stable argsort.
long long build_transpose_i32(const int32_t* flat_nodes, long long n_flat,
                              long long n_nodes, long long k,
                              int32_t* out_table) {
    std::vector<long long> counts(n_nodes, 0);
    for (long long i = 0; i < n_flat; ++i) counts[flat_nodes[i]] += 1;
    long long K = 0;
    for (long long n = 0; n < n_nodes; ++n) K = std::max(K, counts[n]);
    if (k <= 0) return K;
    if (k < K) return -1;

    std::fill(out_table, out_table + n_nodes * k,
              static_cast<int32_t>(n_flat));
    std::vector<long long> fill(n_nodes, 0);
    for (long long i = 0; i < n_flat; ++i) {
        long long node = flat_nodes[i];
        out_table[node * k + fill[node]] = static_cast<int32_t>(i);
        fill[node] += 1;
    }
    return K;
}

}  // extern "C"
