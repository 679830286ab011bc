// Independent native cross-validation oracle for mpc_rs_jax.
//
// PURPOSE (BASELINE.md item 2 surrogate): the reference's Rust examples
// cannot be rebuilt in this image (no cargo), so trajectories regenerated
// "by running the Rust examples" are unavailable. This file is the
// replacement evidence: a from-scratch f64 implementation of the
// reference's MPPI solve, UKF predict/update, dynamics, costs, and
// observation models — written in a different language, compiled by a
// different toolchain (g++), sharing ZERO code and ZERO constant
// definitions with the Python/JAX library. Every constant below is
// re-typed directly from the cited reference const block.
//
// tests/test_native_oracle.py feeds bit-identical noise to this oracle and
// to the JAX library (mppi_solve(noise=...), ukf_predict/update) and
// asserts agreement: tight (~1e-9) against the JAX f64 path, tolerance-
// banded against the production f32 path, and over full matched-noise
// closed-loop trajectories.
//
// Algorithm sources (transcribed, not copied — the reference is Rust):
//   MPPI solve        /root/reference/src/mppi.rs:33-92
//   UKF predict/update/sigma/UT/weights  /root/reference/src/ukf2.rs:44-137
//                      (ukf.rs is the same algorithm at N=4, O=3)
//   cartpole4 dynamics /root/reference/examples/mppi4-non-liner.rs:73-94
//   flagship ddot/dynamics4/dynamics_short
//                      /root/reference/examples/mppi4-non-liner-ukf.rs:105-159
//   hx4 (rpm/gyro)     /root/reference/examples/mppi4-non-liner-s.rs:242-248
//   hx6 (IMU)          /root/reference/examples/mppi4-non-liner-ukf.rs:169-179
//   gen_q6             /root/reference/examples/mppi4-non-liner-ukf.rs:192-221
//   costs              /root/reference/examples/mppi4.rs:20-27,
//                      /root/reference/examples/mppi4-non-liner-ukf.rs:22,33-35
//
// The one algorithmic deviation: sigma-point square roots use cyclic
// Jacobi eigendecomposition instead of nalgebra's SVD. For symmetric PSD
// C·P these yield the same {x ± L_i} sigma SET up to column order and
// sign, and the unscented transform is exactly invariant to both (all
// non-center weights are equal, ±L_i pairs swap) — so UT outputs match to
// f64 roundoff.
//
// Build: make -C native liboracle.so

#include <cmath>
#include <cstring>

namespace {

constexpr double kPi = 3.14159265358979323846;

// ---------------------------------------------------------------------------
// Parameter blocks (independent literals, cited)
// ---------------------------------------------------------------------------

// examples/mppi4-non-liner.rs:73-80 (== mppi4.rs, mppi4-non-liner-s.rs:170-177)
namespace sw {
constexpr double M1 = 150e-3;
constexpr double R_W = 50e-3;
constexpr double M2 = 2.3 - 2.0 * M1 + 2.0;
constexpr double L = 0.2474;
constexpr double J1 = M1 * R_W * R_W;
constexpr double J2 = 0.2;
constexpr double G = 9.81;
constexpr double KT = 0.15;
}  // namespace sw

// examples/mppi4-non-liner-ukf.rs:105-123 (== mppi4-ukf-commu.rs:115-135)
namespace tw {
constexpr double M1 = 160e-3;
constexpr double R_W = 50e-3;
constexpr double M2 = 2.4;
constexpr double L = 0.4;
constexpr double J1 = 2.23e5 * 1e-9;
constexpr double J2 = 1.168e8 * 1e-9;
constexpr double G = 9.81;
constexpr double KT = 0.15;
constexpr double D1 = (2.0 * M1 + M2 + 2.0 * J1 / (R_W * R_W)) * (M2 * L * L + J2);
}  // namespace tw

// ---------------------------------------------------------------------------
// Dynamics
// ---------------------------------------------------------------------------

// examples/mppi4-non-liner.rs:81-94 (dt-parametrized form of
// mppi4-non-liner-s.rs:193-207 dynamics_short). All state reads are the
// PRE-update values (Rust copies x into r, then reads x on every RHS).
void dynamics_cartpole4(const double* x, double u, double dt, double* r) {
  using namespace sw;
  const double D = (M1 + M2 + J1 / (R_W * R_W)) * (M2 * L * L + J2);
  const double c = std::cos(x[2]), s = std::sin(x[2]);
  const double d = D - M2 * M2 * L * L * c * c;
  const double term1 = (M1 + M2 + J1 / (R_W * R_W)) * M2 * G * L * s;
  const double term2 = (KT * u / R_W + M2 * L * x[3] * x[3] * s) * M2 * L * c;
  r[3] = x[3] + (term1 - term2) / d * dt;
  r[2] = x[2] + x[3] * dt;
  const double term3 = (J2 + M2 * L * L) * (KT * u / R_W + M2 * L * x[3] * x[3] * s);
  const double term4 = M2 * G * L * L * s * c;
  r[1] = x[1] + (term3 + term4) / d * dt;
  r[0] = x[0] + x[1] * dt;
}

// examples/mppi4-non-liner-ukf.rs:125-139. x4 = [x, dx, theta, dtheta].
// NOTE the reference's own quirks are transcribed verbatim: the force
// terms use cos(dtheta) (x[3].cos()), not cos(theta).
void ddot_flagship(const double* x4, double u, double f, double* ddx, double* ddth) {
  using namespace tw;
  const double th = x4[2], dth = x4[3];
  const double c = std::cos(th), s = std::sin(th);
  const double d = D1 - (M2 * L * c) * (M2 * L * c);
  double t1 = (M2 * L * L + J2) * M2 * L / d * dth * dth * s;
  double t2 = -(M2 * L) * (M2 * L) * G / d * s * c;
  double t3 = 2.0 * (M2 * L * L + J2) / (d * R_W) * KT * u;
  double t4 = (M2 * L * L + J2) / d * f * std::cos(dth);
  *ddx = t1 + t2 + t3 + t4;
  t1 = -(M2 * L) * (M2 * L) / d * dth * dth * s * c;
  t2 = (M2 * G * s - 2.0 * f) * L * (2.0 * M1 + M2 + 2.0 * J1 / (R_W * R_W)) / d;
  t3 = -2.0 * M2 * L / (d * R_W) * KT * u * c;
  t4 = -M2 * L * f * std::cos(dth) * std::cos(dth) / d;
  *ddth = t1 + t2 + t3 + t4;
}

// examples/mppi4-non-liner-ukf.rs:140-148. Sequential integration: r[2]
// reads the UPDATED r[3] and r[0] the UPDATED r[1] (unlike cartpole4).
void dynamics_flagship4(const double* x, double u, double dt, double* r) {
  double ddx, ddth;
  ddot_flagship(x, u, 0.0, &ddx, &ddth);
  r[3] = x[3] + ddth * dt;
  r[2] = x[2] + r[3] * dt;
  r[1] = x[1] + ddx * dt;
  r[0] = x[0] + r[1] * dt;
}

// examples/mppi4-non-liner-ukf.rs:149-159. 6-state [x, dx, ddx, th, dth,
// ddth]; accelerations are ASSIGNED (r[5] = ddth, r[2] = ddx) and the
// integrals read the updated values.
void dynamics_short6(const double* x, double u, double dt, double f, double* r) {
  const double x4[4] = {x[0], x[1], x[3], x[4]};
  double ddx, ddth;
  ddot_flagship(x4, u, f, &ddx, &ddth);
  r[5] = ddth;
  r[4] = x[4] + r[5] * dt;
  r[3] = x[3] + r[4] * dt;
  r[2] = ddx;
  r[1] = x[1] + r[2] * dt;
  r[0] = x[0] + r[1] * dt;
}

// ---------------------------------------------------------------------------
// Costs
// ---------------------------------------------------------------------------

double clampd(double v, double lo, double hi) { return v < lo ? lo : (v > hi ? hi : v); }

// examples/mppi4.rs:20-27 (== mppi4-non-liner.rs:20-27)
double cost_shaped4(const double* x) {
  const double xc = clampd(x[0], -2.0, 2.0);
  const double t1 = 2.0 * xc * xc;
  const double c2 = clampd(x[1] + 2.0 * xc, -5.0, 5.0);
  const double t2 = 3.0 * c2 * c2;
  const double c3 = x[2] + 0.35 * clampd(x[0], -0.75, 0.75);
  const double t3 = 5.0 * c3 * c3;
  const double t4 = 1.2 * x[3] * x[3];
  return t1 + t2 + t3 + t4;
}

// examples/mppi4-non-liner-ukf.rs:22 (C = [0.1, 0.1, 1.0, 0.5]) + :33-35
double cost_diag_flagship(const double* x) {
  return 0.1 * x[0] * x[0] + 0.1 * x[1] * x[1] + 1.0 * x[2] * x[2] + 0.5 * x[3] * x[3];
}

// ---------------------------------------------------------------------------
// Observation models
// ---------------------------------------------------------------------------

// examples/mppi4-non-liner-s.rs:242-248 (R_W = sw::R_W)
void hx4_rpm_gyro(const double* x, double* z) {
  z[0] = 60.0 / (2.0 * kPi * sw::R_W) * x[1];
  z[1] = 60.0 / (2.0 * kPi * sw::R_W) * x[1];
  z[2] = x[3] * 180.0 / kPi;  // to_degrees
}

// examples/mppi4-non-liner-ukf.rs:169-179. state = [x, dx, ddx, th, dth, ddth]
void hx6_imu(const double* x, double* z) {
  using namespace tw;
  const double ax = G * std::sin(x[3]) + x[2] * std::cos(x[3]) + L * x[5];
  const double az = G * std::cos(x[3]) - x[2] * std::sin(x[3]) + L * x[4] * x[4];
  z[0] = 36.0 * 60.0 / (2.0 * kPi * R_W) * x[1];
  z[1] = 36.0 * -60.0 / (2.0 * kPi * R_W) * x[1];
  z[2] = x[4] * 180.0 / kPi;
  z[3] = az / G;
  z[4] = ax / G;
}

// ---------------------------------------------------------------------------
// Small linear algebra (f64, n <= 8)
// ---------------------------------------------------------------------------

constexpr int kMaxN = 8;

// Cyclic Jacobi eigendecomposition of symmetric a (n x n, row-major).
// On return w holds eigenvalues, v the eigenvectors (column i of v matches
// w[i]). Returns sweeps used, or -1 if it failed to converge.
int jacobi_eigh(int n, const double* a_in, double* w, double* v) {
  double a[kMaxN][kMaxN];
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) a[i][j] = a_in[i * n + j];
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) v[i * n + j] = (i == j) ? 1.0 : 0.0;
  const int kMaxSweeps = 64;
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    double off = 0.0;
    for (int i = 0; i < n; ++i)
      for (int j = i + 1; j < n; ++j) off += a[i][j] * a[i][j];
    if (off < 1e-300) {
      for (int i = 0; i < n; ++i) w[i] = a[i][i];
      return sweep;
    }
    for (int p = 0; p < n - 1; ++p) {
      for (int q = p + 1; q < n; ++q) {
        const double apq = a[p][q];
        if (std::fabs(apq) < 1e-300) continue;
        const double tau = (a[q][q] - a[p][p]) / (2.0 * apq);
        const double t = (tau >= 0.0 ? 1.0 : -1.0) /
                         (std::fabs(tau) + std::sqrt(1.0 + tau * tau));
        const double c = 1.0 / std::sqrt(1.0 + t * t);
        const double s = t * c;
        for (int i = 0; i < n; ++i) {
          const double aip = a[i][p], aiq = a[i][q];
          a[i][p] = c * aip - s * aiq;
          a[i][q] = s * aip + c * aiq;
        }
        for (int i = 0; i < n; ++i) {
          const double api = a[p][i], aqi = a[q][i];
          a[p][i] = c * api - s * aqi;
          a[q][i] = s * api + c * aqi;
        }
        for (int i = 0; i < n; ++i) {
          const double vip = v[i * n + p], viq = v[i * n + q];
          v[i * n + p] = c * vip - s * viq;
          v[i * n + q] = s * vip + c * viq;
        }
      }
    }
  }
  for (int i = 0; i < n; ++i) w[i] = a[i][i];
  return -1;
}

// Gauss-Jordan inverse with partial pivoting (n <= 8). Returns 0 ok.
int invert(int n, const double* a_in, double* out) {
  double a[kMaxN][2 * kMaxN];
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) a[i][j] = a_in[i * n + j];
    for (int j = 0; j < n; ++j) a[i][n + j] = (i == j) ? 1.0 : 0.0;
  }
  for (int col = 0; col < n; ++col) {
    int piv = col;
    for (int r = col + 1; r < n; ++r)
      if (std::fabs(a[r][col]) > std::fabs(a[piv][col])) piv = r;
    if (std::fabs(a[piv][col]) < 1e-300) return 1;
    if (piv != col)
      for (int j = 0; j < 2 * n; ++j) std::swap(a[piv][j], a[col][j]);
    const double inv_p = 1.0 / a[col][col];
    for (int j = 0; j < 2 * n; ++j) a[col][j] *= inv_p;
    for (int r = 0; r < n; ++r) {
      if (r == col) continue;
      const double f = a[r][col];
      if (f == 0.0) continue;
      for (int j = 0; j < 2 * n; ++j) a[r][j] -= f * a[col][j];
    }
  }
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) out[i * n + j] = a[i][n + j];
  return 0;
}

// ---------------------------------------------------------------------------
// UKF internals (src/ukf2.rs:100-137; identical algorithm in ukf.rs)
// ---------------------------------------------------------------------------

// Merwe constants — src/ukf2.rs:23-28 (ALPHA=1e-3, BETA=2, KAPPA=3-n).
void merwe_weights(int n, double* wm, double* wc, double* c_out) {
  const double alpha = 1e-3, beta = 2.0;
  const double kappa = 3.0 - static_cast<double>(n);
  const double c = alpha * alpha * (static_cast<double>(n) + kappa);
  const double lambda = c - static_cast<double>(n);
  const int m = 2 * n + 1;
  for (int i = 0; i < m; ++i) {
    wm[i] = 1.0 / (2.0 * c);
    wc[i] = 1.0 / (2.0 * c);
  }
  wm[0] = lambda / c;
  wc[0] = lambda / c + 1.0 - alpha * alpha + beta;
  *c_out = c;
}

// src/ukf2.rs:126-137: sigma = {x, x + L_i, x - L_i}, L = sqrt(C*P)
// (eigen square root — see file header for SVD-equivalence). Row-major
// (2n+1, n), point-major.
int sigma_points(int n, const double* x, const double* p, double* sigma) {
  double wm[2 * kMaxN + 1], wc[2 * kMaxN + 1], c;
  merwe_weights(n, wm, wc, &c);
  double s[kMaxN * kMaxN];
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j)
      s[i * n + j] = 0.5 * c * (p[i * n + j] + p[j * n + i]);
  double eval[kMaxN], evec[kMaxN * kMaxN];
  if (jacobi_eigh(n, s, eval, evec) < 0) return 1;
  // column i of L = evec_col_i * sqrt(max(eval_i, 0))
  for (int j = 0; j < n; ++j) sigma[j] = x[j];
  for (int i = 0; i < n; ++i) {
    const double root = std::sqrt(eval[i] > 0.0 ? eval[i] : 0.0);
    for (int j = 0; j < n; ++j) {
      const double lij = evec[j * n + i] * root;
      sigma[(1 + i) * n + j] = x[j] + lij;
      sigma[(1 + n + i) * n + j] = x[j] - lij;
    }
  }
  return 0;
}

// src/ukf2.rs:100-114: mean = sigmas * wm; P = sum wc_i y y^T + cov.
void unscented_transform(int s_dim, int m, const double* sigmas, const double* wm,
                         const double* wc, const double* cov, double* mean,
                         double* p_out) {
  for (int j = 0; j < s_dim; ++j) {
    double acc = 0.0;
    for (int i = 0; i < m; ++i) acc += sigmas[i * s_dim + j] * wm[i];
    mean[j] = acc;
  }
  for (int a = 0; a < s_dim; ++a)
    for (int b = 0; b < s_dim; ++b) {
      double acc = 0.0;
      for (int i = 0; i < m; ++i)
        acc += wc[i] * (sigmas[i * s_dim + a] - mean[a]) *
               (sigmas[i * s_dim + b] - mean[b]);
      p_out[a * s_dim + b] = acc + cov[a * s_dim + b];
    }
}

// examples/mppi2.rs:22-27 — 2-state double integrator.
void dynamics_di2(const double* x, double u, double dt, double* r) {
  r[0] = x[0] + x[1] * dt;
  r[1] = x[1] + u * dt;
}

void apply_fx(int fx_id, const double* x, double u, double dt, double f, double* out) {
  switch (fx_id) {
    case 0: dynamics_cartpole4(x, u, dt, out); break;
    case 1: dynamics_short6(x, u, dt, f, out); break;
    case 2: dynamics_flagship4(x, u, dt, out); break;
    case 3: dynamics_di2(x, u, dt, out); break;
  }
}

void apply_hx(int hx_id, const double* x, double* z) {
  switch (hx_id) {
    case 0: hx4_rpm_gyro(x, z); break;
    case 1: hx6_imu(x, z); break;
  }
}

int state_dim(int fx_id) { return fx_id == 1 ? 6 : (fx_id == 3 ? 2 : 4); }

}  // namespace

// ---------------------------------------------------------------------------
// C API (ctypes)
// ---------------------------------------------------------------------------

extern "C" {

// dyn_id: 0 = cartpole4 nonlinear (SW params), 2 = flagship dynamics4
// (TW params, f = 0). Writes the successor state (dim 4).
void oracle_dynamics(int dyn_id, const double* x, double u, double dt, double* out) {
  apply_fx(dyn_id, x, u, dt, 0.0, out);
}

void oracle_dynamics_short6(const double* x, double u, double dt, double f, double* out) {
  dynamics_short6(x, u, dt, f, out);
}

double oracle_cost(int cost_id, const double* x) {
  return cost_id == 0 ? cost_shaped4(x) : cost_diag_flagship(x);
}

void oracle_hx(int hx_id, const double* x, double* z) { apply_hx(hx_id, x, z); }

// examples/mppi4-non-liner-ukf.rs:192-221 (PHY = [100, 70, 20], :28).
void oracle_gen_q6(double dt, double* q /* 36, row-major */) {
  const double p0 = 100.0, p1 = 70.0, p2 = 20.0;
  const double dt2 = dt * dt, dt3 = dt2 * dt, dt4 = dt2 * dt2;
  std::memset(q, 0, 36 * sizeof(double));
  // q1 (rows/cols 3..5), scaled by PHY[0]
  q[3 * 6 + 4] += p0 * dt4 / 8.0; q[3 * 6 + 5] += p0 * dt3 / 6.0;
  q[4 * 6 + 3] += p0 * dt4 / 8.0; q[4 * 6 + 4] += p0 * dt3 / 3.0; q[4 * 6 + 5] += p0 * dt2 / 2.0;
  q[5 * 6 + 3] += p0 * dt3 / 6.0; q[5 * 6 + 4] += p0 * dt2 / 2.0; q[5 * 6 + 5] += p0 * dt;
  // q2 (rows/cols 1,3,4), scaled by PHY[1]
  q[1 * 6 + 3] += p1 * dt4 / 8.0; q[1 * 6 + 4] += p1 * dt3 / 6.0;
  q[3 * 6 + 1] += p1 * dt4 / 8.0; q[3 * 6 + 3] += p1 * dt3 / 3.0; q[3 * 6 + 4] += p1 * dt2 / 2.0;
  q[4 * 6 + 1] += p1 * dt3 / 6.0; q[4 * 6 + 3] += p1 * dt2 / 2.0; q[4 * 6 + 4] += p1 * dt;
  // q3 (rows/cols 0..2), scaled by PHY[2]
  q[0 * 6 + 1] += p2 * dt4 / 8.0; q[0 * 6 + 2] += p2 * dt3 / 6.0;
  q[1 * 6 + 0] += p2 * dt4 / 8.0; q[1 * 6 + 1] += p2 * dt3 / 3.0; q[1 * 6 + 2] += p2 * dt2 / 2.0;
  q[2 * 6 + 0] += p2 * dt3 / 6.0; q[2 * 6 + 1] += p2 * dt2 / 2.0; q[2 * 6 + 2] += p2 * dt;
}

// One MPPI solve — src/mppi.rs:33-92 in straight serial f64.
// eps is the (k, n) row-major noise matrix, ALREADY scaled by sigma (the
// JAX side is fed the identical values through mppi_solve(noise=...)).
// Returns the reference's status: 0 Ok, 1 "Cannot calculate max",
// 2 "sum is zero", 3 "u is invalid". u_out is zeroed on failure (the
// fallback every reference caller applies).
int oracle_mppi_solve(int dyn_id, int cost_id, long long k, int n,
                      const double* x0, const double* u_n, const double* eps,
                      double lambda, double std_dev, double lim_lo, double lim_hi,
                      double dt, double* u_out) {
  if (n > 64) return -1;
  const int s = state_dim(dyn_id);
  const double inv = 1.0 / (std_dev * std_dev);  // src/mppi.rs:48 powi(-2)
  double max_score = -INFINITY;
  bool any_finite = false;
  // Pass 1: scores (recomputed in pass 2 — O(2KN) dynamics, trivially cheap
  // at test sizes and keeps memory at O(N)).
  for (long long i = 0; i < k; ++i) {
    double v[64];
    for (int t = 0; t < n; ++t) v[t] = clampd(u_n[t] + eps[i * n + t], lim_lo, lim_hi);
    double x[kMaxN];
    for (int j = 0; j < s; ++j) x[j] = x0[j];
    double c = 0.0;
    for (int t = 0; t < n; ++t) {
      double xn[kMaxN];
      apply_fx(dyn_id, x, v[t], dt, 0.0, xn);
      for (int j = 0; j < s; ++j) x[j] = xn[j];
      c += (cost_id == 0 ? cost_shaped4(x) : cost_diag_flagship(x));
    }
    double control_term = 0.0;
    for (int t = 0; t < n; ++t) control_term += u_n[t] * inv * v[t];
    const double score = -c - control_term;
    if (std::isfinite(score)) {
      any_finite = true;
      if (score > max_score) max_score = score;
    }
  }
  for (int t = 0; t < n; ++t) u_out[t] = 0.0;
  if (!any_finite) return 1;  // src/mppi.rs:65-69
  // Pass 2: softmax weights + weighted average.
  double sum = 0.0;
  double acc[64];
  for (int t = 0; t < n; ++t) acc[t] = 0.0;
  for (long long i = 0; i < k; ++i) {
    double v[64];
    for (int t = 0; t < n; ++t) v[t] = clampd(u_n[t] + eps[i * n + t], lim_lo, lim_hi);
    double x[kMaxN];
    for (int j = 0; j < s; ++j) x[j] = x0[j];
    double c = 0.0;
    for (int t = 0; t < n; ++t) {
      double xn[kMaxN];
      apply_fx(dyn_id, x, v[t], dt, 0.0, xn);
      for (int j = 0; j < s; ++j) x[j] = xn[j];
      c += (cost_id == 0 ? cost_shaped4(x) : cost_diag_flagship(x));
    }
    double control_term = 0.0;
    for (int t = 0; t < n; ++t) control_term += u_n[t] * inv * v[t];
    const double score = -c - control_term;
    const double w = std::isfinite(score) ? std::exp((score - max_score) / lambda) : 0.0;
    sum += w;
    for (int t = 0; t < n; ++t) acc[t] += w * v[t];
  }
  if (sum == 0.0) return 2;  // src/mppi.rs:76-78
  for (int t = 0; t < n; ++t) u_out[t] = acc[t] / sum;
  if (std::isnan(u_out[0]) || std::isinf(u_out[0])) {  // src/mppi.rs:86-89
    for (int t = 0; t < n; ++t) u_out[t] = 0.0;
    return 3;
  }
  return 0;
}

// The inline mppi2 weighting — examples/mppi2.rs:59-77: w = exp(−c/λ −
// Σ u/R·v) with NO max-shift, normalized, weighted average. Cost is the
// double integrator's x0² + x1² accumulated over the rollout (:49-56).
// v = clamp(u_n + eps) mirrors the library's sampling so the WEIGHTING
// equivalence (library control_inv = λ/R + max-shift, which cancels under
// normalization) is what this entry isolates. Returns 0, or 3 if u[0]
// went NaN/Inf (the example's loop-break condition, :88-90).
int oracle_mppi2_solve(long long k, int n, const double* x0, const double* u_n,
                       const double* eps, double lambda, double r_div,
                       double lim_lo, double lim_hi, double dt, double* u_out) {
  if (n > 64) return -1;
  double sum = 0.0;
  double acc[64];
  for (int t = 0; t < n; ++t) acc[t] = 0.0;
  for (long long i = 0; i < k; ++i) {
    double v[64];
    for (int t = 0; t < n; ++t) v[t] = clampd(u_n[t] + eps[i * n + t], lim_lo, lim_hi);
    double x[2] = {x0[0], x0[1]};
    double c = 0.0;
    for (int t = 0; t < n; ++t) {
      double xn[2];
      dynamics_di2(x, v[t], dt, xn);
      x[0] = xn[0]; x[1] = xn[1];
      c += x[0] * x[0] + x[1] * x[1];
    }
    double control_term = 0.0;
    for (int t = 0; t < n; ++t) control_term += u_n[t] / r_div * v[t];
    const double w = std::exp(-c / lambda - control_term);
    sum += w;
    for (int t = 0; t < n; ++t) acc[t] += w * v[t];
  }
  for (int t = 0; t < n; ++t) u_out[t] = acc[t] / sum;
  if (std::isnan(u_out[0]) || std::isinf(u_out[0])) return 3;
  return 0;
}

// ---------------------------------------------------------------------------
// Nonlinear-cost gradient MPC — examples/op-mpc-x.rs
// ---------------------------------------------------------------------------

namespace opnl {
// op-mpc-x.rs:26-47 — the LIGHT param set: M2 = 2.3 − 2·M1 (no +2.0)
constexpr double M1 = 150e-3;
constexpr double R = 50e-3;
constexpr double M2 = 2.3 - 2.0 * M1;
constexpr double L = 0.2474;
constexpr double J1 = M1 * R * R;
constexpr double J2 = 0.2;
constexpr double G = 9.81;
constexpr double KT = 0.15;
constexpr double D = (M1 + M2 + J1 / (R * R)) * (M2 * L * L + J2) - M2 * M2 * L * L;
constexpr double DT = 0.5 / 50.0;  // :49-61 live values T=0.5, N=50
// GAIN — op-mpc-x.rs:80 (live line)
constexpr double GAIN[5] = {0.0, 9.2, 16.0, 0.5, 0.0};

// op-mpc-x.rs:64-69 — IN-PLACE sequential update: x3 from OLD x2; x2 from
// NEW x3; x1 from NEW x2; x0 from NEW x1.
void dynamics_inplace(double* x, double u) {
  x[3] += ((M1 + M2 + J1 / (R * R)) / D * M2 * G * L * x[2] - M2 * L / D / R * KT * u) * DT;
  x[2] += x[3] * DT;
  x[1] += (-M2 * M2 * G * L * L / D * x[2] + (M2 * L * L + J2) / D / R * KT * u) * DT;
  x[0] += x[1] * DT;
}

// op-mpc-x.rs:86-102
void planning_err(const double* x, double* e) {
  const double x_g = x[0] + x[2] * L;
  const double x_g_ref = clampd(0.0 - x_g, -1.5, 1.5);
  const double x_g_err = x_g_ref - x_g;
  const double x_g_dot = x[1] + x[3] * L;
  const double x_g_dot_ref = clampd(1.5 * x_g_err, -1.5, 1.5);
  const double x_g_dot_err = x_g_dot_ref - x_g_dot;
  const double theta_ref = clampd(0.5 * x_g_dot_err, -0.3, 0.3);
  const double theta_err = theta_ref - x[2];
  const double theta_dot_err = 0.0 - x[3];
  e[0] = x_g_err;
  e[1] = x_g_dot_err;
  e[2] = theta_err;
  e[3] = theta_dot_err;
}

// op-mpc-x.rs:106-125 — rollout tracking cost with the cosh soft barrier.
double tracking_cost(const double* x0, const double* u, int n) {
  double x[4] = {x0[0], x0[1], x0[2], x0[3]};
  double c = 0.0;
  for (int t = 0; t < n; ++t) {
    dynamics_inplace(x, u[t]);
    double e[4];
    planning_err(x, e);
    c += GAIN[0] * e[0] * e[0] + GAIN[1] * e[1] * e[1] * e[1] * e[1] +
         GAIN[2] * e[2] * e[2] * e[2] * e[2] + GAIN[3] * e[3] * e[3] * e[3] * e[3] +
         GAIN[4] * u[t] * u[t];
    const double bar = std::cosh(x[2]) - 1.2;
    c += bar > 0.0 ? bar : 0.0;
  }
  return c;
}
}  // namespace opnl

// ---------------------------------------------------------------------------
// Condensed-QP gradient MPC — examples/op-mpc-x-calc.rs
// ---------------------------------------------------------------------------

namespace opx {
// op-mpc-x-calc.rs:186-194 (NOTE: this D is the CONSTANT linearized
// denominator, minus M2²L² with no cos — unlike the nonlinear models)
constexpr double M1 = 150e-3;
constexpr double R = 50e-3;
constexpr double M2 = 2.3 - 2.0 * M1 + 2.0;
constexpr double L = 0.2474;
constexpr double J1 = M1 * R * R;
constexpr double J2 = 0.2;
constexpr double G = 9.81;
constexpr double KT = 0.15;
constexpr double D = (M1 + M2 + J1 / (R * R)) * (M2 * L * L + J2) - M2 * M2 * L * L;
constexpr double DT = 0.8 / 8.0;  // :6-8
constexpr int N = 8;
constexpr int S = 4;

// op-mpc-x-calc.rs:10-21
void a_matrix(double a[S][S]) {
  const double a_init[S][S] = {
      {1.0, DT, 0.0, 0.0},
      {0.0, 1.0, -M2 * M2 * G * L * L / D * DT, 0.0},
      {0.0, 0.0, 1.0, DT},
      {0.0, 0.0, (M1 + M2 + J1 / (R * R)) / D * M2 * G * L * DT, 1.0}};
  std::memcpy(a, a_init, sizeof(a_init));
}
void b_vector(double b[S]) {
  b[0] = 0.0;
  b[1] = (M2 * L * L + J2) / D / R * KT * DT;
  b[2] = 0.0;
  b[3] = -M2 * L / D / R * KT * DT;
}

// op-mpc-x-calc.rs:29-39 — raised-cosine parking reference, column-major
// flattened (= step-major blocks of 4, :80).
void gen_ref(const double* x, double* r /* S*N */) {
  for (int i = 0; i < N; ++i) {
    const double phase = kPi * static_cast<double>(i) / static_cast<double>(N);
    r[S * i + 0] = (x[0] * (1.0 + std::cos(phase))) / 2.0;
    r[S * i + 1] = clampd(-0.4 * x[0], -2.0, 2.0) * std::sin(phase);
    r[S * i + 2] = clampd(-0.5 * x[0], -0.35, 0.35) * (1.0 * std::cos(phase)) / 2.0;
    r[S * i + 3] = clampd(-0.5 * x[0], -1.5, 1.5) * std::sin(phase);
  }
}

// create_a_matrix!/create_g_matrix!/create_q_matrix! (op-mpc-x-calc.rs:41-71
// == src/mpc.rs:2-36): F (SN, S) of A powers, lower-triangular G of
// A^(i-j)B, block-diagonal Q of C = diag(5, 5, 1, 1) (:22-27).
void build_fgq(double f[S * N][S], double g[S * N][N], double qdiag[S * N]) {
  double a[S][S], b[S];
  a_matrix(a);
  b_vector(b);
  double apow[N + 1][S][S];  // apow[k] = A^k
  for (int i = 0; i < S; ++i)
    for (int j = 0; j < S; ++j) apow[0][i][j] = (i == j) ? 1.0 : 0.0;
  for (int k = 1; k <= N; ++k)
    for (int i = 0; i < S; ++i)
      for (int j = 0; j < S; ++j) {
        double acc = 0.0;
        for (int t = 0; t < S; ++t) acc += apow[k - 1][i][t] * a[t][j];
        apow[k][i][j] = acc;
      }
  for (int i = 0; i < N; ++i)
    for (int r = 0; r < S; ++r)
      for (int c = 0; c < S; ++c) f[S * i + r][c] = apow[i + 1][r][c];
  for (int i = 0; i < S * N; ++i)
    for (int j = 0; j < N; ++j) g[i][j] = 0.0;
  for (int i = 0; i < N; ++i)
    for (int j = 0; j <= i; ++j)
      for (int r = 0; r < S; ++r) {
        double acc = 0.0;
        for (int t = 0; t < S; ++t) acc += apow[i - j][r][t] * b[t];
        g[S * i + r][j] = acc;
      }
  const double cdiag[S] = {5.0, 5.0, 1.0, 1.0};
  for (int i = 0; i < N; ++i)
    for (int r = 0; r < S; ++r) qdiag[S * i + r] = cdiag[r];
}
}  // namespace opx

// UKF predict — src/ukf2.rs:44-52. x (n), p (n,n) updated in place; the
// propagated sigma set (2n+1, n) is written to sigma_f for the update.
// fx_id: 0 = cartpole4 (dt), 1 = flagship 6-state (dt, f), 2 = flagship4.
int oracle_ukf_predict(int n, int fx_id, double u, double dt, double f,
                       const double* q, double* x, double* p, double* sigma_f) {
  if (n > kMaxN) return 2;
  const int m = 2 * n + 1;
  double sigma[(2 * kMaxN + 1) * kMaxN];
  if (sigma_points(n, x, p, sigma)) return 1;
  for (int i = 0; i < m; ++i)
    apply_fx(fx_id, &sigma[i * n], u, dt, f, &sigma_f[i * n]);
  double wm[2 * kMaxN + 1], wc[2 * kMaxN + 1], c;
  merwe_weights(n, wm, wc, &c);
  unscented_transform(n, m, sigma_f, wm, wc, q, x, p);
  return 0;
}

// Predict with an externally supplied square-root factor: deltas (n, n)
// row-major, row i = L_i so the sigma set is {x, x ± L_i}. Used by the
// matched-sqrt cross-validation tests: when C·P has near-degenerate
// eigenvalues the eigenbasis is ill-defined, so eigh (library) and Jacobi
// (this oracle) legitimately pick different sigma sets and the filters
// diverge by O(gain·innovation·angle) — not a transcription signal.
// Sharing the factor isolates everything else (weights, UT, cross-cov,
// gain, update, symmetrization) for a tight comparison; the sqrt itself
// is cross-validated separately on well-separated spectra.
int oracle_ukf_predict_sqrt(int n, int fx_id, double u, double dt, double f,
                            const double* q, const double* deltas,
                            double* x, double* p, double* sigma_f) {
  if (n > kMaxN) return 2;
  const int m = 2 * n + 1;
  double sigma[(2 * kMaxN + 1) * kMaxN];
  for (int j = 0; j < n; ++j) sigma[j] = x[j];
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) {
      sigma[(1 + i) * n + j] = x[j] + deltas[i * n + j];
      sigma[(1 + n + i) * n + j] = x[j] - deltas[i * n + j];
    }
  for (int i = 0; i < m; ++i)
    apply_fx(fx_id, &sigma[i * n], u, dt, f, &sigma_f[i * n]);
  double wm[2 * kMaxN + 1], wc[2 * kMaxN + 1], c;
  merwe_weights(n, wm, wc, &c);
  unscented_transform(n, m, sigma_f, wm, wc, q, x, p);
  return 0;
}

// Bare sigma-point placement (src/ukf2.rs:126-137) for direct sqrt
// cross-validation. Writes the (2n+1, n) set.
int oracle_sigma_points(int n, const double* x, const double* p, double* sigma) {
  if (n > kMaxN) return 2;
  return sigma_points(n, x, p, sigma);
}

// op-mpc-x tracking cost + the reference's central-difference gradient
// (op-mpc-x.rs:132-151, EPS = 1e-3, serialized here).
double oracle_tracking_cost(const double* x0, const double* u, int n) {
  if (n > 64) return NAN;
  return opnl::tracking_cost(x0, u, n);
}

void oracle_tracking_grad_fd(const double* x0, const double* u, int n, double* grad) {
  // The reference's scheme EXACTLY (op-mpc-x.rs:132-151): component i's
  // central difference is evaluated from dynamics_cpy(x, u[i]) — the
  // state pre-stepped once by u[i] — not from x itself.
  constexpr double kEps = 1e-3;  // :133
  if (n > 64) {
    for (int i = 0; i < n; ++i) grad[i] = NAN;  // caller allocated n entries
    return;
  }
  double up[64];
  for (int t = 0; t < n; ++t) up[t] = u[t];
  for (int i = 0; i < n; ++i) {
    double x_pre[4] = {x0[0], x0[1], x0[2], x0[3]};
    opnl::dynamics_inplace(x_pre, u[i]);  // :135-136 dynamics_cpy(x, u[i])
    const double saved = up[i];
    up[i] = saved + kEps;
    const double cp = opnl::tracking_cost(x_pre, up, n);
    up[i] = saved - kEps;  // u_cpy[i] -= 2*EPS after += EPS (:142-144)
    const double cm = opnl::tracking_cost(x_pre, up, n);
    up[i] = saved;
    grad[i] = (cp - cm) / (2.0 * kEps);
  }
}

// Condensed-QP cost + analytic gradient — op-mpc-x-calc.rs:73-98 at the
// op-mpc-x-calc configuration (N=8, the linearized A/B, C=diag(5,5,1,1),
// raised-cosine gen_ref). Like the reference, F/G/Q are rebuilt per call.
void oracle_qp_cost_grad(const double* x, const double* u, double* cost_out,
                         double* grad_out) {
  using namespace opx;
  double f[S * N][S], g[S * N][N], qd[S * N];
  build_fgq(f, g, qd);
  double xref[S * N];
  gen_ref(x, xref);
  double res[S * N];  // Gu + Fx − xref
  for (int i = 0; i < S * N; ++i) {
    double acc = 0.0;
    for (int j = 0; j < N; ++j) acc += g[i][j] * u[j];
    for (int j = 0; j < S; ++j) acc += f[i][j] * x[j];
    res[i] = acc - xref[i];
  }
  // grad = 2 Gᵀ Q (Gu + Fx − xref)
  for (int j = 0; j < N; ++j) {
    double acc = 0.0;
    for (int i = 0; i < S * N; ++i) acc += g[i][j] * qd[i] * res[i];
    grad_out[j] = 2.0 * acc;
  }
  // cost = uᵀGᵀQGu + 2(xᵀFᵀ − xrefᵀ)QGu  (op-mpc-x-calc.rs:80-82);
  // (xᵀFᵀ − xrefᵀ) entries are res − Gu
  double gu[S * N];
  for (int i = 0; i < S * N; ++i) {
    double acc = 0.0;
    for (int j = 0; j < N; ++j) acc += g[i][j] * u[j];
    gu[i] = acc;
  }
  double left = 0.0, right = 0.0;
  for (int i = 0; i < S * N; ++i) {
    left += gu[i] * qd[i] * gu[i];
    right += (res[i] - gu[i]) * qd[i] * gu[i];
  }
  *cost_out = left + 2.0 * right;
}

// Exact global solve of  min uᵀHu + bᵀu, lo ≤ u ≤ hi  by brute-force
// active-set enumeration (3^n candidates, KKT-checked; convex SPD ⇒ the
// KKT point is the global minimizer). n ≤ 12 (3^12 ≈ 5.3e5 subsolves).
int box_qp_enumerate(int n, const double* h /*(n,n)*/, const double* bvec,
                     double lo, double hi, double* u_out) {
  if (n > 12 || n > kMaxN) return 3;  // kMaxN bounds the dense subsolves
  double best_cost = INFINITY;
  bool found = false;
  double scale = 0.0;
  for (int i = 0; i < n; ++i) scale = std::max(scale, std::fabs(bvec[i]));
  for (int i = 0; i < n * n; ++i) scale = std::max(scale, std::fabs(h[i]));
  const double tol = 1e-9 * (scale + 1.0);
  long long total = 1;
  for (int i = 0; i < n; ++i) total *= 3;
  int assign[kMaxN];
  for (long long code = 0; code < total; ++code) {
    long long c = code;
    int n_free = 0;
    int free_idx[kMaxN];
    double u[kMaxN];
    for (int i = 0; i < n; ++i) {
      assign[i] = static_cast<int>(c % 3);
      c /= 3;
      if (assign[i] == 0) free_idx[n_free++] = i;
      else u[i] = (assign[i] == 1) ? lo : hi;
    }
    if (n_free > 0) {
      double a_sub[kMaxN * kMaxN], rhs[kMaxN];
      for (int r = 0; r < n_free; ++r) {
        const int i = free_idx[r];
        double acc = bvec[i];
        for (int j = 0; j < n; ++j)
          if (assign[j] != 0) acc += 2.0 * h[i * n + j] * u[j];
        rhs[r] = -acc;
        for (int cidx = 0; cidx < n_free; ++cidx)
          a_sub[r * n_free + cidx] = 2.0 * h[i * n + free_idx[cidx]];
      }
      double a_inv[kMaxN * kMaxN];
      if (invert(n_free, a_sub, a_inv)) continue;
      for (int r = 0; r < n_free; ++r) {
        double acc = 0.0;
        for (int cidx = 0; cidx < n_free; ++cidx) acc += a_inv[r * n_free + cidx] * rhs[cidx];
        u[free_idx[r]] = acc;
      }
    }
    bool ok = true;
    for (int i = 0; i < n && ok; ++i) {
      double acc = bvec[i];
      for (int j = 0; j < n; ++j) acc += 2.0 * h[i * n + j] * u[j];
      if (assign[i] == 0) ok = (u[i] >= lo - 1e-12 && u[i] <= hi + 1e-12);
      else if (assign[i] == 1) ok = (acc >= -tol);
      else ok = (acc <= tol);
    }
    if (!ok) continue;
    double cost = 0.0;
    for (int i = 0; i < n; ++i) {
      double hu = 0.0;
      for (int j = 0; j < n; ++j) hu += h[i * n + j] * u[j];
      cost += u[i] * hu + bvec[i] * u[i];
    }
    if (cost < best_cost) {
      best_cost = cost;
      for (int i = 0; i < n; ++i) u_out[i] = u[i];
      found = true;
    }
  }
  return found ? 0 : 1;
}

// Exact global box-QP solve of the op-mpc-x-calc condensed problem at
// state x: min over lo ≤ u ≤ hi of uᵀHu + bᵀu with H = GᵀQG and
// b = 2GᵀQ(Fx − xref), by brute-force active-set enumeration (3^N
// candidate sets, KKT-checked; convex SPD ⇒ the KKT point is the global
// minimizer). Independent end-to-end check of controllers/qp.py
// box_qp_newton. Returns 0 on success, 1 if no candidate satisfied KKT
// (cannot happen for SPD H within tolerance).
int oracle_qp_solve_box(const double* x, double lo, double hi, double* u_out) {
  using namespace opx;
  double f[S * N][S], g[S * N][N], qd[S * N];
  build_fgq(f, g, qd);
  double xref[S * N];
  gen_ref(x, xref);
  double h[N * N];  // GᵀQG
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) {
      double acc = 0.0;
      for (int t = 0; t < S * N; ++t) acc += g[t][i] * qd[t] * g[t][j];
      h[i * N + j] = acc;
    }
  double bvec[N];  // 2GᵀQ(Fx − xref)
  for (int j = 0; j < N; ++j) {
    double acc = 0.0;
    for (int t = 0; t < S * N; ++t) {
      double fx = 0.0;
      for (int c = 0; c < S; ++c) fx += f[t][c] * x[c];
      acc += g[t][j] * qd[t] * (fx - xref[t]);
    }
    bvec[j] = 2.0 * acc;
  }
  return box_qp_enumerate(N, h, bvec, lo, hi, u_out);
}

// Generic exact box-QP solve: caller-supplied H (n,n row-major) and b —
// the property-test seam for validating box_qp_newton / panoc_solve on
// arbitrary random SPD problems, not just the op-mpc-x-calc instance.
int oracle_box_qp_solve_generic(int n, const double* h, const double* b,
                                double lo, double hi, double* u_out) {
  return box_qp_enumerate(n, h, b, lo, hi, u_out);
}

// UKF update — src/ukf2.rs:54-74 (gain via Pz^-1, covariance
// symmetrization (P+P^T)/2).
int oracle_ukf_update(int n, int o, int hx_id, const double* z, const double* r,
                      const double* sigma_f, double* x, double* p) {
  if (n > kMaxN || o > kMaxN) return 2;
  const int m = 2 * n + 1;
  double sigmas_h[(2 * kMaxN + 1) * kMaxN];
  for (int i = 0; i < m; ++i) apply_hx(hx_id, &sigma_f[i * n], &sigmas_h[i * o]);
  double wm[2 * kMaxN + 1], wc[2 * kMaxN + 1], c;
  merwe_weights(n, wm, wc, &c);
  double zp[kMaxN], pz[kMaxN * kMaxN];
  unscented_transform(o, m, sigmas_h, wm, wc, r, zp, pz);
  double pxz[kMaxN * kMaxN];
  for (int a = 0; a < n; ++a)
    for (int b = 0; b < o; ++b) {
      double acc = 0.0;
      for (int i = 0; i < m; ++i)
        acc += wc[i] * (sigma_f[i * n + a] - x[a]) * (sigmas_h[i * o + b] - zp[b]);
      pxz[a * o + b] = acc;
    }
  double pz_inv[kMaxN * kMaxN];
  if (invert(o, pz, pz_inv)) return 1;  // "Inverse fail" — src/ukf2.rs:69
  double gain[kMaxN * kMaxN];
  for (int a = 0; a < n; ++a)
    for (int b = 0; b < o; ++b) {
      double acc = 0.0;
      for (int j = 0; j < o; ++j) acc += pxz[a * o + j] * pz_inv[j * o + b];
      gain[a * o + b] = acc;
    }
  for (int a = 0; a < n; ++a) {
    double acc = 0.0;
    for (int b = 0; b < o; ++b) acc += gain[a * o + b] * (z[b] - zp[b]);
    x[a] += acc;
  }
  // p -= K Pz K^T, then symmetrize
  double kpz[kMaxN * kMaxN];
  for (int a = 0; a < n; ++a)
    for (int b = 0; b < o; ++b) {
      double acc = 0.0;
      for (int j = 0; j < o; ++j) acc += gain[a * o + j] * pz[j * o + b];
      kpz[a * o + b] = acc;
    }
  double delta[kMaxN * kMaxN];
  for (int a = 0; a < n; ++a)
    for (int b = 0; b < n; ++b) {
      double acc = 0.0;
      for (int j = 0; j < o; ++j) acc += kpz[a * o + j] * gain[b * o + j];
      delta[a * n + b] = acc;
    }
  for (int a = 0; a < n; ++a)
    for (int b = 0; b < n; ++b) p[a * n + b] -= delta[a * n + b];
  for (int a = 0; a < n; ++a)
    for (int b = a; b < n; ++b) {
      const double sym = 0.5 * (p[a * n + b] + p[b * n + a]);
      p[a * n + b] = sym;
      p[b * n + a] = sym;
    }
  return 0;
}

}  // extern "C"
