/* bf_native: the host library of bayesfast_tpu_torch.
 *
 * The port's copy of the JAX package's host library, with the same code:
 * the host route of the SIT fit and QMC point generation run it, where a
 * batch is too small for the device (transforms/sit.py, utils/kde.py):
 *
 *   - sobol_points: Gray-code Sobol sequence from a precomputed
 *     direction-number matrix (OpenMP over dimensions).
 *   - kde_cdf: weighted 1-d Gaussian-KDE cdf, sum of erf terms
 *     (OpenMP over evaluation points); kde_cdf_sorted, the same on
 *     presorted data with prefix weight sums, summing only the +-8h
 *     window of each point: the inner loop of every host spline fit.
 *     Each output is one OpenMP iteration, so its bits do not depend on
 *     the team size.
 *   - spline_eval / spline_deriv / spline_solve: piecewise-cubic
 *     evaluate/derivative/bisection-inverse with binary interval search.
 *
 * Pure C99 + OpenMP, loaded via ctypes (no CPython API). Built at first use
 * by bayesfast_tpu_torch/_build.py; native/bindings.py raises when the
 * build fails (no numpy fallback stands in for it).
 */

#include <math.h>
#include <stdint.h>
#include <stddef.h>
#include <stdlib.h>

#ifdef _OPENMP
#include <omp.h>
#endif

#define BF_EXPORT __attribute__((visibility("default")))

/* 0 = OpenMP default; >0 caps the team size of every parallel region.
 * Callers that fan out over host threads (e.g. the SIT per-dim fits) set
 * this to 1 to avoid oversubscription. */
static volatile int bf_max_threads = 0;

BF_EXPORT void bf_set_threads(int n) { bf_max_threads = n; }

#ifdef _OPENMP
static int bf_team(void)
{
    int n = bf_max_threads;
    return n > 0 ? n : omp_get_max_threads();
}
#endif

/* ------------------------- Sobol ------------------------- */

/* V: (d, n_bits) uint32 direction numbers (bit b scaled by 2^32).
 * out: (n, d) doubles in [0, 1). Points are indices skip .. skip+n-1. */
BF_EXPORT void bf_sobol_points(const uint32_t *V, int64_t d, int64_t n_bits,
                               int64_t n, int64_t skip, double *out)
{
    const double scale = 1.0 / 4294967296.0; /* 2^-32 */
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(bf_team())
#endif
    for (int64_t j = 0; j < d; ++j) {
        const uint32_t *Vj = V + j * n_bits;
        /* X_skip via Gray code of the first index, then the XOR recursion
         * X_{i+1} = X_i ^ V[c(i)] with c(i) = lowest zero bit of i. */
        uint64_t i0 = (uint64_t)skip;
        uint64_t g = i0 ^ (i0 >> 1);
        uint32_t X = 0;
        for (int64_t b = 0; b < n_bits; ++b)
            if ((g >> b) & 1u)
                X ^= Vj[b];
        out[0 * d + j] = (double)X * scale;
        for (int64_t i = 1; i < n; ++i) {
            uint64_t prev = i0 + (uint64_t)i - 1;
            int64_t c = 0;
            while (prev & 1u) { prev >>= 1; ++c; }
            if (c < n_bits)
                X ^= Vj[c];
            out[i * d + j] = (double)X * scale;
        }
    }
}

/* ------------------------- KDE cdf ------------------------- */

/* cdf(x_i) = sum_k w_k * Phi((x_i - data_k) / h); Phi via erf.
 *
 * Dense variant plus a presorted windowed variant below. */

BF_EXPORT void bf_kde_cdf(const double *data, const double *weights,
                          int64_t n_data, double h, const double *x,
                          int64_t n_x, double *out)
{
    const double inv = 1.0 / (h * 1.4142135623730951); /* 1/(h*sqrt(2)) */
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(bf_team())
#endif
    for (int64_t i = 0; i < n_x; ++i) {
        double acc = 0.0;
        const double xi = x[i];
        for (int64_t k = 0; k < n_data; ++k)
            acc += weights[k] * 0.5 * (1.0 + erf((xi - data[k]) * inv));
        out[i] = acc;
    }
}

/* first index k with arr[k] > t (upper bound) */
static int64_t bf_upper_d(const double *arr, int64_t n, double t)
{
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (arr[mid] > t) hi = mid; else lo = mid + 1;
    }
    return lo;
}

/* Variant for presorted data with precomputed prefix weight sums
 * (prefix[k] = sum of sw[0..k-1], length n_data + 1): only the +-8h window
 * needs erf, everything below contributes its full weight. The caller
 * sorts once per kde object; fits evaluate the cdf many times. */
BF_EXPORT void bf_kde_cdf_sorted(const double *sdata, const double *sw,
                                 const double *prefix, int64_t n_data,
                                 double h, const double *x, int64_t n_x,
                                 double *out)
{
    const double inv = 1.0 / (h * 1.4142135623730951);
    const double win = 8.0 * h;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(bf_team())
#endif
    for (int64_t i = 0; i < n_x; ++i) {
        const double xi = x[i];
        const int64_t lo = bf_upper_d(sdata, n_data, xi - win);
        const int64_t hi = bf_upper_d(sdata, n_data, xi + win);
        double acc = prefix[lo]; /* everything far below: Phi = 1 */
        for (int64_t k = lo; k < hi; ++k)
            acc += sw[k] * 0.5 * (1.0 + erf((xi - sdata[k]) * inv));
        out[i] = acc;
    }
}

/* ------------------------- cubic splines ------------------------- */

/* Interval lookup: j such that x[j-1] <= v < x[j]; 0 below, m above. */
static int64_t find_interval(const double *x, int64_t m, double v)
{
    if (!(v >= x[0]))
        return v < x[0] ? 0 : -1; /* below range or nan */
    if (v >= x[m - 1])
        return m;
    int64_t lo = 1, hi = m - 1;
    while (lo < hi) {
        int64_t mid = (lo + hi) / 2;
        if (v < x[mid])
            hi = mid;
        else
            lo = mid + 1;
    }
    return lo;
}

static inline double ceval(const double *c, double t)
{
    return ((c[0] * t + c[1]) * t + c[2]) * t + c[3];
}

static inline double cderiv(const double *c, double t)
{
    return (3.0 * c[0] * t + 2.0 * c[1]) * t + c[2];
}

/* c: (m+1, 4) local coefficients incl. both linear extension rows. */
BF_EXPORT void bf_spline_eval(const double *c, const double *x, int64_t m,
                              const double *xp, int64_t n, double *out)
{
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(bf_team())
#endif
    for (int64_t i = 0; i < n; ++i) {
        int64_t j = find_interval(x, m, xp[i]);
        if (j <= 0)
            out[i] = c[2] * (xp[i] - x[0]) + c[3];
        else if (j >= m)
            out[i] = c[m * 4 + 2] * (xp[i] - x[m - 1]) + c[m * 4 + 3];
        else
            out[i] = ceval(c + j * 4, xp[i] - x[j - 1]);
    }
}

BF_EXPORT void bf_spline_deriv(const double *c, const double *x, int64_t m,
                               const double *xp, int64_t n, double *out)
{
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(bf_team())
#endif
    for (int64_t i = 0; i < n; ++i) {
        int64_t j = find_interval(x, m, xp[i]);
        if (j <= 0)
            out[i] = c[2];
        else if (j >= m)
            out[i] = c[m * 4 + 2];
        else
            out[i] = cderiv(c + j * 4, xp[i] - x[j - 1]);
    }
}

/* Inverse via bisection to ~1e-12 of the interval width. */
BF_EXPORT void bf_spline_solve(const double *c, const double *x,
                               const double *y, int64_t m, const double *yp,
                               int64_t n, double *out)
{
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(bf_team())
#endif
    for (int64_t i = 0; i < n; ++i) {
        int64_t j = find_interval(y, m, yp[i]);
        if (j <= 0) {
            out[i] = x[0] + (yp[i] - c[3]) / c[2];
        } else if (j >= m) {
            out[i] = x[m - 1] + (yp[i] - c[m * 4 + 3]) / c[m * 4 + 2];
        } else {
            const double *cj = c + j * 4;
            double a = 0.0, b = x[j] - x[j - 1];
            for (int it = 0; it < 60; ++it) {
                double t = 0.5 * (a + b);
                if (ceval(cj, t) - yp[i] > 0.0)
                    b = t;
                else
                    a = t;
            }
            out[i] = x[j - 1] + 0.5 * (a + b);
        }
    }
}
