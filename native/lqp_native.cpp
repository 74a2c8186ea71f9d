// lqp_native: double-precision CPU box-QP ADMM solver.
//
// Role in the framework: an *independent* trusted implementation used as a
// cross-check oracle in tests and as the CPU baseline in benchmarks — the
// reference repo leans on the external SCS C solver for this
// (/root/reference/lqp_py/scs_qp.py:97-108); this framework ships its own
// native solver instead so no external solver dependency is needed.
//
// Solves:  min 0.5 x'Qx + p'x  s.t.  Ax = b,  lb <= x <= ub
// via ADMM with a dense LDL^T factorization of the KKT matrix
//   [[Q + rho I, A'], [A, 0]]
// (quasi-definite => LDL^T with diagonal D exists without pivoting).
//
// Build: see native/Makefile (g++ -O3 -shared).  Python binding: ctypes
// (lqp_py_tpu/cpu/native.py).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Dense LDL^T factorization (no pivoting) of a symmetric quasi-definite
// matrix stored row-major full.  Overwrites M's lower triangle with L and
// returns D in d.  Returns false on (near-)zero pivot.
bool ldlt_factor(double* M, double* d, int n) {
    for (int j = 0; j < n; ++j) {
        double dj = M[j * n + j];
        for (int k = 0; k < j; ++k) {
            const double l = M[j * n + k];
            dj -= l * l * d[k];
        }
        if (std::fabs(dj) < 1e-300) return false;
        d[j] = dj;
        for (int i = j + 1; i < n; ++i) {
            double v = M[i * n + j];
            for (int k = 0; k < j; ++k) {
                v -= M[i * n + k] * M[j * n + k] * d[k];
            }
            M[i * n + j] = v / dj;
        }
    }
    return true;
}

// Solve (L D L') x = rhs in place.
void ldlt_solve(const double* L, const double* d, int n, double* x) {
    for (int i = 0; i < n; ++i) {
        double v = x[i];
        for (int k = 0; k < i; ++k) v -= L[i * n + k] * x[k];
        x[i] = v;
    }
    for (int i = 0; i < n; ++i) x[i] /= d[i];
    for (int i = n - 1; i >= 0; --i) {
        double v = x[i];
        for (int k = i + 1; k < n; ++k) v -= L[k * n + i] * x[k];
        x[i] = v;
    }
}

double inf_norm(const double* v, int n) {
    double m = 0.0;
    for (int i = 0; i < n; ++i) m = std::max(m, std::fabs(v[i]));
    return m;
}

}  // namespace

extern "C" {

// Returns: 0 converged, 1 max-iters reached, -1 factorization failure.
// Outputs: x (n), z (n), nu (m, may be null if m==0), lam (n; signed box
// dual, lam<0 => lower bound active), iters, primal/dual residuals.
int lqp_solve_box_qp(
    int n, int m,
    const double* Q,   // n*n row-major
    const double* p,   // n
    const double* A,   // m*n row-major (null if m == 0)
    const double* b,   // m
    const double* lb,  // n (may contain -inf)
    const double* ub,  // n (may contain +inf)
    double rho,        // <= 0 -> auto: ||Q||_F / sqrt(n)
    double eps_abs, double eps_rel, int max_iters, int check_every,
    double* x_out, double* z_out, double* nu_out, double* lam_out,
    int* iters_out, double* primal_out, double* dual_out) {
    const int N = n + m;
    std::vector<double> M(static_cast<size_t>(N) * N, 0.0);
    std::vector<double> diag(N, 0.0);
    std::vector<double> x(n, 0.0), z(n, 0.0), u(n, 0.0), zp(n, 0.0);
    std::vector<double> rhs(N, 0.0);

    if (rho <= 0.0) {
        double fro = 0.0;
        for (int i = 0; i < n * n; ++i) fro += Q[i] * Q[i];
        rho = std::sqrt(fro) / std::sqrt(static_cast<double>(n));
        rho = std::min(std::max(rho, 1e-6), 1e6);
    }

    auto factor = [&](double r) -> bool {
        for (int i = 0; i < n; ++i) {
            for (int j = 0; j < n; ++j) M[i * (size_t)N + j] = Q[i * n + j];
            M[i * (size_t)N + i] += r;
        }
        for (int i = 0; i < m; ++i) {
            for (int j = 0; j < n; ++j) {
                M[(n + i) * (size_t)N + j] = A[i * n + j];
                M[j * (size_t)N + (n + i)] = A[i * n + j];
            }
            M[(n + i) * (size_t)N + (n + i)] = 0.0;
        }
        return ldlt_factor(M.data(), diag.data(), N);
    };
    if (!factor(rho)) return -1;

    const double pn = inf_norm(p, n);
    double primal = std::numeric_limits<double>::infinity();
    double dual = primal;
    int it = 0;
    if (check_every < 1) {
        check_every = std::max(
            static_cast<int>(std::lround(std::sqrt((double)n) / 10.0)) * 10,
            1);
    }

    for (it = 0; it < max_iters; ++it) {
        for (int i = 0; i < n; ++i) rhs[i] = -p[i] + rho * (z[i] - u[i]);
        for (int i = 0; i < m; ++i) rhs[n + i] = b[i];
        ldlt_solve(M.data(), diag.data(), N, rhs.data());
        for (int i = 0; i < n; ++i) x[i] = rhs[i];
        zp = z;
        for (int i = 0; i < n; ++i) {
            double v = x[i] + u[i];
            if (v < lb[i]) v = lb[i];
            if (v > ub[i]) v = ub[i];
            z[i] = v;
            u[i] += x[i] - z[i];
        }
        if (it % check_every == 0 || it == max_iters - 1) {
            primal = 0.0;
            dual = 0.0;
            double xn = 0.0, zn = 0.0, yn = 0.0, qxn = 0.0;
            for (int i = 0; i < n; ++i) {
                primal = std::max(primal, std::fabs(x[i] - z[i]));
                dual = std::max(dual, rho * std::fabs(z[i] - zp[i]));
                xn = std::max(xn, std::fabs(x[i]));
                zn = std::max(zn, std::fabs(z[i]));
                yn = std::max(yn, rho * std::fabs(u[i]));
                double qx = 0.0;
                for (int j = 0; j < n; ++j) qx += Q[i * n + j] * x[j];
                qxn = std::max(qxn, std::fabs(qx));
            }
            const double tol_p = eps_abs + eps_rel * std::max(xn, zn);
            const double tol_d =
                eps_abs + eps_rel * std::max(std::max(yn, qxn), pn);
            if (primal < tol_p && dual < tol_d) {
                ++it;
                break;
            }
        }
    }

    std::memcpy(x_out, x.data(), sizeof(double) * n);
    std::memcpy(z_out, z.data(), sizeof(double) * n);
    if (m > 0 && nu_out) {
        for (int i = 0; i < m; ++i) nu_out[i] = rhs[n + i];
    }
    for (int i = 0; i < n; ++i) lam_out[i] = rho * u[i];
    *iters_out = it;
    *primal_out = primal;
    *dual_out = dual;
    return (primal < eps_abs + eps_rel || it < max_iters) ? 0 : 1;
}

// Batched front-end: loops over problems (the CPU baseline is sequential by
// design; the JAX path is the batched one).
int lqp_solve_box_qp_batch(
    int n_batch, int n, int m,
    const double* Q, const double* p, const double* A, const double* b,
    const double* lb, const double* ub,
    double rho, double eps_abs, double eps_rel, int max_iters,
    int check_every,
    double* x_out, double* z_out, double* nu_out, double* lam_out,
    int* iters_out, double* primal_out, double* dual_out) {
    int status = 0;
    for (int i = 0; i < n_batch; ++i) {
        const int s = lqp_solve_box_qp(
            n, m,
            Q + (size_t)i * n * n, p + (size_t)i * n,
            m > 0 ? A + (size_t)i * m * n : nullptr,
            m > 0 ? b + (size_t)i * m : nullptr,
            lb + (size_t)i * n, ub + (size_t)i * n,
            rho, eps_abs, eps_rel, max_iters, check_every,
            x_out + (size_t)i * n, z_out + (size_t)i * n,
            m > 0 ? nu_out + (size_t)i * m : nullptr,
            lam_out + (size_t)i * n,
            iters_out + i, primal_out + i, dual_out + i);
        if (s != 0) status = s;
    }
    return status;
}

// OpenMP batch-parallel front-end: one problem per task across cores.
// The sequential version above deliberately mirrors the reference's
// SCS-wrapper anti-pattern (scs_qp.py:97-108) for benchmarking; this one is
// the honest multicore CPU baseline.  n_threads <= 0 -> OpenMP default.
int lqp_solve_box_qp_batch_mt(
    int n_threads,
    int n_batch, int n, int m,
    const double* Q, const double* p, const double* A, const double* b,
    const double* lb, const double* ub,
    double rho, double eps_abs, double eps_rel, int max_iters,
    int check_every,
    double* x_out, double* z_out, double* nu_out, double* lam_out,
    int* iters_out, double* primal_out, double* dual_out) {
    int worst = 0;  // 0 ok, 1 max-iters, 2 factorization failure
#ifdef _OPENMP
    if (n_threads > 0) omp_set_num_threads(n_threads);
#pragma omp parallel for schedule(dynamic) reduction(max : worst)
#endif
    for (int i = 0; i < n_batch; ++i) {
        const int s = lqp_solve_box_qp(
            n, m,
            Q + (size_t)i * n * n, p + (size_t)i * n,
            m > 0 ? A + (size_t)i * m * n : nullptr,
            m > 0 ? b + (size_t)i * m : nullptr,
            lb + (size_t)i * n, ub + (size_t)i * n,
            rho, eps_abs, eps_rel, max_iters, check_every,
            x_out + (size_t)i * n, z_out + (size_t)i * n,
            m > 0 ? nu_out + (size_t)i * m : nullptr,
            lam_out + (size_t)i * n,
            iters_out + i, primal_out + i, dual_out + i);
        const int mapped = (s == -1) ? 2 : s;
        if (mapped > worst) worst = mapped;
    }
    return worst == 2 ? -1 : worst;
}

}  // extern "C"
