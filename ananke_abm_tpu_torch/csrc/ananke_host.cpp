// Host-side counting kernels for the comparison harness.
//
// The reference's metric layer counts n-grams and run-length segments with
// Python dict loops (compare/utils.py:255-301); the numpy path in this
// framework uses sort-based np.unique (O(N*T log)). These C++ kernels do
// the same work as single linear passes with dense accumulators — the
// O(N*T) floor for 1M-agent x 288-bin populations.
//
// Exposed via a plain C ABI for ctypes. The port's copy of
// native/ananke_host.cpp: ananke_abm_tpu_torch/ops/native.py builds it with
// g++ at first use into build/ananke_abm_tpu_torch/.

#include <cstdint>
#include <cstring>

extern "C" {

// Count n-grams of label rows into a dense table of size P^n.
// Y: (N, T) row-major int64 labels in [0, P). counts: preallocated,
// zeroed, size P^n. Codes are base-P big-endian (matches
// compare.utils.ngram_code_matrix).
void count_ngrams(const int64_t* Y, int64_t N, int64_t T, int64_t n,
                  int64_t P, int64_t* counts) {
    if (n <= 0 || n > T) return;
    // P^(n-1) for the rolling-code update
    int64_t head = 1;
    for (int64_t i = 1; i < n; ++i) head *= P;
    const int64_t mod = head * P;
    for (int64_t r = 0; r < N; ++r) {
        const int64_t* row = Y + r * T;
        int64_t code = 0;
        for (int64_t t = 0; t < n; ++t) code = code * P + row[t];
        counts[code] += 1;
        for (int64_t t = n; t < T; ++t) {
            code = (code % head) * P + row[t];
            counts[code] += 1;
        }
        (void)mod;
    }
}

// Run-length segmentation of all rows.
// Outputs arrays must have capacity N*T. Returns the segment count.
int64_t run_length_segments(const int64_t* Y, int64_t N, int64_t T,
                            int64_t* person, int64_t* purpose,
                            int64_t* length) {
    int64_t s = 0;
    for (int64_t r = 0; r < N; ++r) {
        const int64_t* row = Y + r * T;
        int64_t start = 0;
        for (int64_t t = 1; t <= T; ++t) {
            if (t == T || row[t] != row[t - 1]) {
                person[s] = r;
                purpose[s] = row[start];
                length[s] = t - start;
                ++s;
                start = t;
            }
        }
    }
    return s;
}

// Per-(time-bin, purpose) occupancy counts: counts[(t * P) + p] += 1.
// The inner loop of compute_empirical_tod / tod_marginals.
void tod_counts(const int64_t* Y, int64_t N, int64_t T, int64_t P,
                int64_t* counts) {
    for (int64_t r = 0; r < N; ++r) {
        const int64_t* row = Y + r * T;
        for (int64_t t = 0; t < T; ++t) counts[t * P + row[t]] += 1;
    }
}

// Histogram of segment-start times per n-gram-of-frames code:
// hist[(code_index_in_dense_table) * Tn + t] with dense code table P^n.
void ngram_start_hist(const int64_t* Y, int64_t N, int64_t T, int64_t n,
                      int64_t P, int64_t* hist) {
    if (n <= 0 || n > T) return;
    int64_t head = 1;
    for (int64_t i = 1; i < n; ++i) head *= P;
    const int64_t Tn = T - n + 1;
    for (int64_t r = 0; r < N; ++r) {
        const int64_t* row = Y + r * T;
        int64_t code = 0;
        for (int64_t t = 0; t < n; ++t) code = code * P + row[t];
        hist[code * Tn + 0] += 1;
        for (int64_t t = 1; t < Tn; ++t) {
            code = (code % head) * P + row[t + n - 1];
            hist[code * Tn + t] += 1;
        }
    }
}

}  // extern "C"

extern "C" {

// Rasterizer core: monotone push-forward bin assignment + interval fill.
// Inputs are per-activity arrays sorted by (person, stopno):
//   person_row: row index of the activity's person (0..n_persons-1)
//   nominal:    starttime // grid_min
//   bins:       ceil(duration / grid_min), >= 1
//   pid:        purpose id
// Y: (n_persons * L) int64, pre-zeroed.
void rasterize_fill(const int64_t* person_row, const int64_t* nominal,
                    const int64_t* bins, const int64_t* pid,
                    int64_t n_acts, int64_t L, int64_t* Y) {
    int64_t prev_person = -1;
    int64_t next_free = 0;
    for (int64_t i = 0; i < n_acts; ++i) {
        const int64_t r = person_row[i];
        if (r != prev_person) {
            prev_person = r;
            next_free = 0;
        }
        int64_t a = nominal[i] > next_free ? nominal[i] : next_free;
        if (a >= L) continue;  // truncated past the horizon
        int64_t b = a + bins[i];
        if (b > L) b = L;
        int64_t* row = Y + r * L;
        const int64_t p = pid[i];
        for (int64_t t = a; t < b; ++t) row[t] = p;
        next_free = b;
    }
}

}  // extern "C"
