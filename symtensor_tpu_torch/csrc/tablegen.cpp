// Native table generation for symtensor-tpu.
//
// Host-side combinatorial table builders: representative-index enumeration,
// multiplicities, sigma-class ids, packed-position ranking, dense gather
// maps. These are the O(n*r) loops that gate first-use latency for large
// (rank, dim); the Python/NumPy fallbacks in utils/ are the reference
// implementations (tested against each other).
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in the image).
// All outputs are caller-allocated; all sizes use int64.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// C(n, k) with clamping guard; only used for values that fit int64.
int64_t binom(int64_t n, int64_t k) {
    if (k < 0 || n < 0 || k > n) return 0;
    if (k > n - k) k = n - k;
    int64_t out = 1;
    for (int64_t t = 0; t < k; ++t) {
        out = out * (n - t) / (t + 1);  // exact: product of t+1 consecutive
    }
    return out;
}

int64_t multiset_count(int64_t values, int64_t size) {
    if (size == 0) return 1;
    return binom(values + size - 1, size);
}

int64_t factorial(int64_t n) {
    int64_t out = 1;
    for (int64_t i = 2; i <= n; ++i) out *= i;
    return out;
}

}  // namespace

extern "C" {

// Total independent components C(dim+rank-1, rank).
int64_t st_indep_size(int32_t rank, int32_t dim) {
    return multiset_count(dim, rank);
}

// Enumerate all rank-sized multisets over {0..dim-1} in gflat order into
// out (n * rank int32, row-major). Returns n, or -1 on error.
//
// gflat order (utils/combinatorics.py): group j = i_{r-2} ascending; head
// (i_1..i_{r-3}) in colex over {0..j}; tail (i_{r-1}, i_r) row-major in the
// triangle of side dim - j.  rank >= 2.
int64_t st_gflat_rep(int32_t rank, int32_t dim, int32_t* out) {
    if (rank < 2 || dim < 1) return -1;
    const int64_t n = multiset_count(dim, rank);
    int64_t pos = 0;
    if (rank == 2) {
        for (int32_t a = 0; a < dim; ++a)
            for (int32_t b = a; b < dim; ++b) {
                out[pos * 2] = a;
                out[pos * 2 + 1] = b;
                ++pos;
            }
        return pos;
    }
    const int32_t h = rank - 3;
    // heads in colex over {0..j}: iterate with an odometer that yields
    // ascending tuples in colexicographic order.
    std::vector<int32_t> head(h, 0);
    for (int32_t j = 0; j < dim; ++j) {
        const int64_t Pj = multiset_count(j + 1, h);
        std::fill(head.begin(), head.end(), 0);
        for (int64_t p = 0; p < Pj; ++p) {
            for (int32_t a = j; a < dim; ++a) {
                for (int32_t b = a; b < dim; ++b) {
                    int32_t* row = out + pos * rank;
                    for (int32_t t = 0; t < h; ++t) row[t] = head[t];
                    row[h] = j;
                    row[h + 1] = a;
                    row[h + 2] = b;
                    ++pos;
                }
            }
            // colex successor of an ascending multiset over {0..j}:
            // increment the first position that can grow; reset prefix to 0.
            for (int32_t t = 0; t < h; ++t) {
                int32_t cap = (t + 1 < h) ? head[t + 1] : j;
                if (head[t] < cap) {
                    ++head[t];
                    for (int32_t s = 0; s < t; ++s) head[s] = 0;
                    break;
                }
            }
        }
    }
    return (pos == n) ? pos : -1;
}

// Multiplicities gamma = rank!/prod(counts!) and sigma-class ids for sorted
// rows. class ids index the descending-partition enumeration passed in as
// a flattened (num_classes * rank) zero-padded descending counts matrix.
int64_t st_row_stats(const int32_t* rep, int64_t n, int32_t rank,
                     const int32_t* classes, int32_t num_classes,
                     float* gamma_out, int32_t* class_out) {
    const int64_t rfact = factorial(rank);
    std::vector<int32_t> counts(rank);
    for (int64_t i = 0; i < n; ++i) {
        const int32_t* row = rep + i * rank;
        int32_t ncounts = 0;
        int64_t denom = 1;
        int32_t run = 1;
        for (int32_t t = 1; t <= rank; ++t) {
            if (t < rank && row[t] == row[t - 1]) {
                ++run;
            } else {
                counts[ncounts++] = run;
                denom *= factorial(run);
                run = 1;
            }
        }
        gamma_out[i] = static_cast<float>(rfact / denom);
        std::sort(counts.begin(), counts.begin() + ncounts,
                  std::greater<int32_t>());
        for (int32_t t = ncounts; t < rank; ++t) counts[t] = 0;
        int32_t cid = -1;
        for (int32_t c = 0; c < num_classes; ++c) {
            if (std::memcmp(classes + c * rank, counts.data(),
                            rank * sizeof(int32_t)) == 0) {
                cid = c;
                break;
            }
        }
        if (cid < 0) return -1;
        class_out[i] = cid;
    }
    return n;
}

// Packed gflat position of each sorted row (rank >= 2).
int64_t st_position(const int32_t* rows, int64_t n, int32_t rank,
                    int32_t dim, int64_t* out) {
    if (rank < 2) return -1;
    if (rank == 2) {
        for (int64_t i = 0; i < n; ++i) {
            int64_t a = rows[i * 2], b = rows[i * 2 + 1];
            out[i] = a * (2 * dim - a + 1) / 2 + (b - a);
        }
        return n;
    }
    const int32_t h = rank - 3;
    // group offsets
    std::vector<int64_t> goff(dim + 1, 0);
    for (int32_t j = 0; j < dim; ++j) {
        int64_t Pj = multiset_count(j + 1, h);
        int64_t Tj = static_cast<int64_t>(dim - j) * (dim - j + 1) / 2;
        goff[j + 1] = goff[j] + Pj * Tj;
    }
    for (int64_t i = 0; i < n; ++i) {
        const int32_t* row = rows + i * rank;
        const int64_t j = row[h];
        int64_t hrank = 0;
        for (int32_t t = 0; t < h; ++t) hrank += binom(row[t] + t, t + 1);
        const int64_t Tj = static_cast<int64_t>(dim - j) * (dim - j + 1) / 2;
        const int64_t a = row[h + 1] - j, b = row[h + 2] - j;
        const int64_t side = dim - j;
        out[i] = goff[j] + hrank * Tj + a * (2 * side - a + 1) / 2 + (b - a);
    }
    return n;
}

// Dense gather map: for every dense index of dim^rank (C-order), the packed
// position of its sorted multiset. out has dim^rank int32 entries.
int64_t st_dense_gather(int32_t rank, int32_t dim, int32_t* out) {
    if (rank < 1) return -1;
    int64_t total = 1;
    for (int32_t t = 0; t < rank; ++t) total *= dim;
    std::vector<int32_t> idx(rank, 0), srt(rank);
    // reuse st_position row-by-row (cheap relative to the sort)
    for (int64_t i = 0; i < total; ++i) {
        srt.assign(idx.begin(), idx.end());
        std::sort(srt.begin(), srt.end());
        if (rank == 1) {
            out[i] = srt[0];
        } else {
            int64_t p;
            st_position(srt.data(), 1, rank, dim, &p);
            out[i] = static_cast<int32_t>(p);
        }
        // C-order odometer
        for (int32_t t = rank - 1; t >= 0; --t) {
            if (++idx[t] < dim) break;
            idx[t] = 0;
        }
    }
    return total;
}

// Insert table: positions in the rank-(k+1) layout of sort(J u {i}) for all
// size-k multisets J (gflat order over the SAME layout conventions) and all
// values i. out is (n_k * dim) int32. reps is the (n_k * k) rep table.
int64_t st_insert_table(const int32_t* reps, int64_t n_k, int32_t k,
                        int32_t dim, int32_t* out) {
    std::vector<int32_t> merged(k + 1);
    for (int64_t r = 0; r < n_k; ++r) {
        const int32_t* row = reps + r * k;
        for (int32_t i = 0; i < dim; ++i) {
            // merge i into the sorted row
            int32_t t = 0;
            int32_t w = 0;
            while (t < k && row[t] <= i) merged[w++] = row[t++];
            merged[w++] = i;
            while (t < k) merged[w++] = row[t++];
            if (k + 1 == 1) {
                out[r * dim + i] = merged[0];
            } else {
                int64_t p;
                st_position(merged.data(), 1, k + 1, dim, &p);
                out[r * dim + i] = static_cast<int32_t>(p);
            }
        }
    }
    return n_k * dim;
}

}  // extern "C"
