// Dense equality-constrained QP solvers (native runtime component).
//
// The reference package delegates its per-CG-site quadratic programs to the
// OSQP/SCS C solvers through the `qpsolvers` facade (reference
// qp/qplinear.py:79-86). This translation unit is the framework's native
// equivalent: a self-contained float64 solver pair for
//
//     minimize  1/2 x^T P x   subject to  A x = b
//
//  * eqp_kkt_solve  — equilibrated, regularized KKT factorization with
//    iterative refinement (the same algorithm as the device path, in C++
//    for host-side robustness/oracle use, multi-RHS).
//  * eqp_admm_solve — OSQP-style ADMM with over-relaxation and a KKT polish
//    step, kept as an independent algorithmic cross-check of the direct
//    solver (different iteration, same fixed point).
//
// Exposed with C linkage for ctypes; no external dependencies.

#include <cmath>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Dense LU factorization with partial pivoting (Doolittle, row-major).
// Returns false on exact singularity.
bool lu_factor(std::vector<double>& M, std::vector<int>& piv, int n) {
  for (int i = 0; i < n; ++i) piv[i] = i;
  for (int col = 0; col < n; ++col) {
    int p = col;
    double best = std::fabs(M[col * n + col]);
    for (int r = col + 1; r < n; ++r) {
      double v = std::fabs(M[r * n + col]);
      if (v > best) {
        best = v;
        p = r;
      }
    }
    if (best == 0.0) return false;
    if (p != col) {
      for (int c = 0; c < n; ++c) std::swap(M[col * n + c], M[p * n + c]);
      std::swap(piv[col], piv[p]);
    }
    const double pivot = M[col * n + col];
    for (int r = col + 1; r < n; ++r) {
      const double f = M[r * n + col] / pivot;
      M[r * n + col] = f;
      if (f != 0.0) {
        const double* src = &M[col * n + col + 1];
        double* dst = &M[r * n + col + 1];
        for (int c = 0; c < n - col - 1; ++c) dst[c] -= f * src[c];
      }
    }
  }
  return true;
}

void lu_solve_vec(const std::vector<double>& M, const std::vector<int>& piv,
                  int n, const double* rhs, double* out) {
  std::vector<double> y(n);
  for (int i = 0; i < n; ++i) y[i] = rhs[piv[i]];
  for (int i = 0; i < n; ++i) {
    double acc = y[i];
    for (int j = 0; j < i; ++j) acc -= M[i * n + j] * y[j];
    y[i] = acc;
  }
  for (int i = n - 1; i >= 0; --i) {
    double acc = y[i];
    for (int j = i + 1; j < n; ++j) acc -= M[i * n + j] * out[j];
    out[i] = acc / M[i * n + i];
  }
}

// y = M x for row-major (rows x cols)
void matvec(const double* M, int rows, int cols, const double* x, double* y) {
  for (int r = 0; r < rows; ++r) {
    double acc = 0.0;
    const double* row = M + (size_t)r * cols;
    for (int c = 0; c < cols; ++c) acc += row[c] * x[c];
    y[r] = acc;
  }
}

// y = M^T x
void matvec_t(const double* M, int rows, int cols, const double* x, double* y) {
  for (int c = 0; c < cols; ++c) y[c] = 0.0;
  for (int r = 0; r < rows; ++r) {
    const double* row = M + (size_t)r * cols;
    const double xr = x[r];
    for (int c = 0; c < cols; ++c) y[c] += row[c] * xr;
  }
}

struct Equilibrated {
  std::vector<double> Pn;  // n x n
  std::vector<double> An;  // m x n
  std::vector<double> row_norm;  // m
  double p_scale = 1.0;
};

Equilibrated equilibrate(const double* P, const double* A, int n, int m) {
  Equilibrated eq;
  eq.Pn.assign(P, P + (size_t)n * n);
  eq.An.assign(A, A + (size_t)m * n);
  eq.row_norm.assign(m, 0.0);
  double tr = 0.0;
  for (int i = 0; i < n; ++i) tr += P[(size_t)i * n + i];
  eq.p_scale = tr / n + 1e-300;
  for (size_t i = 0; i < eq.Pn.size(); ++i) eq.Pn[i] /= eq.p_scale;
  for (int r = 0; r < m; ++r) {
    double acc = 0.0;
    for (int c = 0; c < n; ++c) {
      const double v = A[(size_t)r * n + c];
      acc += v * v;
    }
    eq.row_norm[r] = std::sqrt(acc) + 1e-300;
    for (int c = 0; c < n; ++c) eq.An[(size_t)r * n + c] /= eq.row_norm[r];
  }
  return eq;
}

}  // namespace

extern "C" {

// Multi-RHS regularized-KKT solve with iterative refinement.
// P: n*n, A: m*n, B: m*k (column j is one RHS), X out: n*k. Returns 0 on
// success, nonzero on factorization failure.
int eqp_kkt_solve(const double* P, const double* A, const double* B, int n,
                  int m, int k, double delta, int refine_iters, double* X) {
  Equilibrated eq = equilibrate(P, A, n, m);
  const int dim = n + m;
  std::vector<double> K((size_t)dim * dim, 0.0);
  std::vector<double> Kt((size_t)dim * dim, 0.0);
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) {
      K[(size_t)i * dim + j] = eq.Pn[(size_t)i * n + j];
      Kt[(size_t)i * dim + j] = eq.Pn[(size_t)i * n + j];
    }
  for (int i = 0; i < n; ++i) K[(size_t)i * dim + i] += delta;
  for (int r = 0; r < m; ++r)
    for (int c = 0; c < n; ++c) {
      const double v = eq.An[(size_t)r * n + c];
      K[(size_t)(n + r) * dim + c] = v;
      K[(size_t)c * dim + (n + r)] = v;
      Kt[(size_t)(n + r) * dim + c] = v;
      Kt[(size_t)c * dim + (n + r)] = v;
    }
  for (int r = 0; r < m; ++r) K[(size_t)(n + r) * dim + (n + r)] = -delta;

  std::vector<int> piv(dim);
  if (!lu_factor(K, piv, dim)) return 1;

  std::vector<double> rhs(dim), z(dim), resid(dim), corr(dim);
  for (int col = 0; col < k; ++col) {
    for (int i = 0; i < n; ++i) rhs[i] = 0.0;
    for (int r = 0; r < m; ++r)
      rhs[n + r] = B[(size_t)r * k + col] / eq.row_norm[r];
    lu_solve_vec(K, piv, dim, rhs.data(), z.data());
    for (int it = 0; it < refine_iters; ++it) {
      matvec(Kt.data(), dim, dim, z.data(), resid.data());
      for (int i = 0; i < dim; ++i) resid[i] = rhs[i] - resid[i];
      lu_solve_vec(K, piv, dim, resid.data(), corr.data());
      for (int i = 0; i < dim; ++i) z[i] += corr[i];
    }
    for (int i = 0; i < n; ++i) X[(size_t)i * k + col] = z[i];
  }
  return 0;
}

// OSQP-style ADMM for the same problem (single RHS), with over-relaxation
// and a final KKT polish. eps_abs terminates on primal+dual residuals.
// Returns iterations used, or -1 on failure.
int eqp_admm_solve(const double* P, const double* A, const double* b, int n,
                   int m, double rho, double sigma, double alpha,
                   double eps_abs, int max_iter, int polish, double* x_out) {
  Equilibrated eq = equilibrate(P, A, n, m);
  std::vector<double> bn(m);
  for (int r = 0; r < m; ++r) bn[r] = b[r] / eq.row_norm[r];

  // M = Pn + sigma I + rho An^T An
  std::vector<double> M((size_t)n * n);
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) {
      double acc = eq.Pn[(size_t)i * n + j];
      for (int r = 0; r < m; ++r)
        acc += rho * eq.An[(size_t)r * n + i] * eq.An[(size_t)r * n + j];
      M[(size_t)i * n + j] = acc;
    }
  for (int i = 0; i < n; ++i) M[(size_t)i * n + i] += sigma;
  std::vector<int> piv(n);
  if (!lu_factor(M, piv, n)) return -1;

  std::vector<double> x(n, 0.0), y(m, 0.0), rhs(n), xt(n), ax(m), tmp_n(n);
  int it = 0;
  for (; it < max_iter; ++it) {
    // rhs = sigma x + An^T (rho b - y)
    std::vector<double> w(m);
    for (int r = 0; r < m; ++r) w[r] = rho * bn[r] - y[r];
    matvec_t(eq.An.data(), m, n, w.data(), rhs.data());
    for (int i = 0; i < n; ++i) rhs[i] += sigma * x[i];
    lu_solve_vec(M, piv, n, rhs.data(), xt.data());
    for (int i = 0; i < n; ++i) x[i] = alpha * xt[i] + (1.0 - alpha) * x[i];
    matvec(eq.An.data(), m, n, x.data(), ax.data());
    double prim = 0.0;
    for (int r = 0; r < m; ++r) {
      const double res = ax[r] - bn[r];
      y[r] += rho * res;
      prim = std::max(prim, std::fabs(res));
    }
    // dual residual: Pn x + An^T y
    matvec(eq.Pn.data(), n, n, x.data(), tmp_n.data());
    std::vector<double> aty(n);
    matvec_t(eq.An.data(), m, n, y.data(), aty.data());
    double dual = 0.0;
    for (int i = 0; i < n; ++i)
      dual = std::max(dual, std::fabs(tmp_n[i] + aty[i]));
    if (prim < eps_abs && dual < eps_abs) break;
  }
  if (polish) {
    // OSQP-style polish: refine the ADMM iterate (x, y) against the
    // (lightly regularized) KKT system — residual-correction sweeps
    // seeded by the ADMM solution, NOT a from-scratch solve (which would
    // make the ADMM result, and any cross-check against the direct
    // solver, meaningless).
    const int dim = n + m;
    const double delta = 1e-11;
    std::vector<double> K((size_t)dim * dim, 0.0), Kt;
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j)
        K[(size_t)i * dim + j] = eq.Pn[(size_t)i * n + j];
    for (int r = 0; r < m; ++r)
      for (int j = 0; j < n; ++j) {
        K[(size_t)(n + r) * dim + j] = eq.An[(size_t)r * n + j];
        K[(size_t)j * dim + (n + r)] = eq.An[(size_t)r * n + j];
      }
    Kt = K;  // unregularized copy for residuals
    for (int i = 0; i < n; ++i) K[(size_t)i * dim + i] += delta;
    for (int r = 0; r < m; ++r) K[(size_t)(n + r) * dim + (n + r)] = -delta;
    std::vector<int> kpiv(dim);
    if (lu_factor(K, kpiv, dim)) {
      std::vector<double> z(dim), rhs(dim, 0.0), resid(dim), corr(dim);
      for (int i = 0; i < n; ++i) z[i] = x[i];
      for (int r = 0; r < m; ++r) z[n + r] = y[r];
      for (int r = 0; r < m; ++r) rhs[n + r] = bn[r];
      for (int sweep = 0; sweep < 4; ++sweep) {
        matvec(Kt.data(), dim, dim, z.data(), resid.data());
        for (int i = 0; i < dim; ++i) resid[i] = rhs[i] - resid[i];
        lu_solve_vec(K, kpiv, dim, resid.data(), corr.data());
        for (int i = 0; i < dim; ++i) z[i] += corr[i];
      }
      for (int i = 0; i < n; ++i) x[i] = z[i];
    }
  }
  std::memcpy(x_out, x.data(), sizeof(double) * n);
  return it;
}

}  // extern "C"
