// tinyopt_tpu native micro-runtime.
//
// The accelerator path (JAX/XLA) is the right tool for batched and large solves,
// but a single tiny solve (dims <= ~64) is dominated by dispatch latency
// there.  The reference library's headline benchmarks are exactly this
// regime: microsecond dense LM solves on the host (reference:
// /root/reference/benchmarks/dense.cpp:28-114, ~0.6-56 us per solve;
// float suite benchmarks/densef.cpp:24-50).  This translation unit
// provides that regime natively: a self-contained dense
// Levenberg-Marquardt / Gauss-Newton / gradient-descent core with its own
// small-matrix Cholesky, no external dependencies, exposed with a C ABI
// for ctypes.  The core is templated on the scalar (double and float
// instantiations, mirroring the reference's scalar-templated Jet/solvers)
// — the f32 entry points carry the `_f32` suffix.
//
// Semantics mirror the Python loop (tinyopt_tpu/optimizers/loop.py), which
// itself mirrors the reference optimizer (reference:
// include/tinyopt/optimizers/optimizer.h:243-534): multiplicative diagonal
// damping with an absolute floor for zero diagonals, accept/reject with
// rollback to the last good point, compounded bad factors, the same stop
// codes.  On the accepted path the trajectory (λ schedule, iterates, stop
// reason) is bit-identical to the jitted loop.  Known deviation on the
// REJECTED path: this merged loop rolls back and re-proposes within the
// same iteration, where the reference/jitted loop spends a separate
// evaluate-only iteration at the rolled-back point — the native runtime
// therefore reports fewer iterations on rejection-heavy runs while
// reaching the same optima.
//
// Build: g++ -O3 -fPIC -shared (see native/__init__.py).

#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <memory>

namespace {

constexpr int kMaxDims = 128;  // scratch bound

// grad = J^T r, H = J^T J. Residual-major accumulation: J rows are
// contiguous, so the inner loops are unit-stride and auto-vectorize.
// Only the LOWER triangle of H is built — the damped Cholesky below reads
// exactly that triangle, so the explicit symmetrize pass (d² loads+stores
// per iteration) is skipped entirely.
template <typename T>
void BuildNormalEquations(const T* J, const T* r, int n_res, int dims,
                          T* H, T* g) {
  std::memset(H, 0, sizeof(T) * dims * dims);
  std::memset(g, 0, sizeof(T) * dims);
  for (int i = 0; i < n_res; ++i) {
    const T* Ji = J + static_cast<size_t>(i) * dims;
    const T ri = r[i];
    for (int a = 0; a < dims; ++a) {
      const T v = Ji[a];
      if (v == T(0)) continue;  // sparse rows (e.g. diagonal J) are common
      g[a] += v * ri;
      T* Ha = H + static_cast<size_t>(a) * dims;
      for (int b = 0; b <= a; ++b) Ha[b] += v * Ji[b];
    }
  }
}

// Dot product with 8 independent accumulators: the factorization's inner
// loops are reduction chains, which gcc will not vectorize (or pipeline
// past the ~4-cycle FMA latency) without value-changing reassociation
// flags; spelling the reassociation out keeps the semantics defined and
// -ffast-math (which would delete the isfinite NaN guards) out of the
// build.  ~1.9x on the prior50 factorization-bound row.
template <typename T>
inline T Dot(const T* a, const T* b, int n) {
  if (n < 8) {  // short dots: accumulator setup costs more than it saves
    T s = T(0);
    for (int k = 0; k < n; ++k) s += a[k] * b[k];
    return s;
  }
  T acc[8] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  int k = 0;
  for (; k + 8 <= n; k += 8)
    for (int u = 0; u < 8; ++u) acc[u] += a[k + u] * b[k + u];
  T s = ((acc[0] + acc[1]) + (acc[2] + acc[3])) +
        ((acc[4] + acc[5]) + (acc[6] + acc[7]));
  for (; k < n; ++k) s += a[k] * b[k];
  return s;
}

// Damped Cholesky solve reading H's lower triangle without a pre-copy:
// L is factored into a separate buffer from (H + λ·D) on the fly — skips
// the O(d²) damped copy every proposal costs otherwise.
template <typename T>
bool CholeskySolveDamped(const T* H, const T* g, T lam, int n, T* L,
                         T* dx) {
  for (int j = 0; j < n; ++j) {
    const T* Lj = L + static_cast<size_t>(j) * n;
    const T hjj = H[j * n + j];
    T d = hjj + lam * (hjj == T(0) ? T(1) : hjj) - Dot(Lj, Lj, j);
    if (!(d > T(0)) || !std::isfinite(d)) return false;
    const T lj = std::sqrt(d);
    L[j * n + j] = lj;
    const T inv = T(1) / lj;
    for (int i = j + 1; i < n; ++i) {
      const T* Li = L + static_cast<size_t>(i) * n;
      L[i * n + j] = (H[i * n + j] - Dot(Li, Lj, j)) * inv;
    }
  }
  for (int i = 0; i < n; ++i) {
    const T s = -g[i] - Dot(L + static_cast<size_t>(i) * n, dx, i);
    dx[i] = s / L[i * n + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    T s = dx[i];
    for (int k = i + 1; k < n; ++k) s -= L[k * n + i] * dx[k];
    dx[i] = s / L[i * n + i];
  }
  return true;
}

}  // namespace

extern "C" {

// Residual+Jacobian callbacks: fill r (n_res) and J (n_res x dims,
// row-major). J may be ignored when jac == 0 (cost-only evaluation).
typedef void (*ResJacFn)(const double* x, double* r, double* J, int jac,
                         void* ctx);
typedef void (*ResJacFnF)(const float* x, float* r, float* J, int jac,
                          void* ctx);

// Stop-reason codes, matching tinyopt_tpu.StopReason / the reference
// (include/tinyopt/stop_reasons.h:14-43).
enum StopReason : int32_t {
  kSolverFailed = -3,
  kSystemHasNaNOrInf = -2,
  kSkipped = -1,
  kNone = 0,
  kMinError = 1,
  kMinRelError = 2,
  kMinDeltaNorm = 3,
  kMinGradNorm = 4,
  kMaxIters = 5,
  kMaxNoDecr = 6,
  kMaxConsecNoDecr = 7,
};

// Options/Output stay double-typed for a single ABI across scalar
// instantiations; thresholds are cast to the solve scalar internally
// (make_options(dtype=float32) on the Python side rescales them to f32
// floors, the Options.for_dtype analogue).
struct NativeOptions {
  int32_t solver_type;  // 0 = LM, 1 = GN, 2 = GD
  int32_t max_iters;
  int32_t max_consec_failures;
  int32_t max_total_failures;
  double min_error;
  double min_rerr_dec;
  double min_step_norm2;
  double min_grad_norm2;
  double damping_init;
  double damping_min;
  double damping_max;
  double good_factor;
  double bad_factor;
  double gd_lr;
};

struct NativeOutput {
  double final_cost;
  int32_t stop_reason;
  int32_t num_iters;
  int32_t num_failures;
  int32_t num_consec_failures;
};

void tinyopt_default_options(NativeOptions* o) {
  o->solver_type = 0;
  o->max_iters = 50;
  o->max_consec_failures = 5;
  o->max_total_failures = 0;
  o->min_error = 1e-12;
  o->min_rerr_dec = 1e-10;
  o->min_step_norm2 = 1e-14;
  o->min_grad_norm2 = 1e-18;
  o->damping_init = 1e-4;
  o->damping_min = 1e-9;
  o->damping_max = 1e9;
  o->good_factor = 1.0 / 3.0;
  o->bad_factor = 2.0;
  o->gd_lr = 1e-3;
}

}  // extern "C"

namespace {

// Dense NLLS solve core (scalar-templated). x is updated in place.
// Scratch sized by the caller: r (n_res), J (n_res*dims).
template <typename T, typename Fn>
int32_t SolveCore(int32_t dims, int32_t n_res, Fn fn, void* ctx, T* x,
                  const NativeOptions* opts, NativeOutput* out, T* r,
                  T* J) {
  out->final_cost = std::numeric_limits<double>::infinity();
  out->stop_reason = kNone;
  out->num_iters = 0;
  out->num_failures = 0;
  out->num_consec_failures = 0;
  if (dims <= 0 || dims > kMaxDims || n_res <= 0) {
    out->stop_reason = kSkipped;
    return out->stop_reason;
  }

  // Two system buffers with pointer swapping on accept: the accepted
  // (H, g) is preserved without any O(d²) copy, and rejected iterations
  // read it directly (the Rebuild(false) shortcut, reference
  // solvers/lm.h:96-105, at zero copy cost).  Heap-allocated per call:
  // re-entrancy (a residual callback may itself invoke tinyopt_solve —
  // bilevel problems) without the ~400 KB of stack frames automatic
  // arrays would cost; one malloc per solve is noise next to the
  // O(iters · dims³) factorizations.
  std::unique_ptr<T[]> scratch(
      new T[3 * kMaxDims * kMaxDims + 4 * kMaxDims]);
  T* H = scratch.get();  // build target (current candidate's system)
  T* H_bst = H + kMaxDims * kMaxDims;  // last accepted system
  T* L = H_bst + kMaxDims * kMaxDims;  // Cholesky factor scratch
  T* g = L + kMaxDims * kMaxDims;
  T* g_bst = g + kMaxDims;
  T* dx = g_bst + kMaxDims;
  T* x_best = dx + kMaxDims;
  std::memcpy(x_best, x, sizeof(T) * dims);

  const bool is_lm = opts->solver_type == 0;
  const bool is_gd = opts->solver_type == 2;
  T lam = static_cast<T>(opts->damping_init);
  T bad_factor = static_cast<T>(opts->bad_factor);
  const T damping_min = static_cast<T>(opts->damping_min);
  const T damping_max = static_cast<T>(opts->damping_max);
  const T opt_bad_factor = static_cast<T>(opts->bad_factor);
  const T good_factor = static_cast<T>(opts->good_factor);
  const T gd_lr = static_cast<T>(opts->gd_lr);
  T best_cost = std::numeric_limits<T>::infinity();
  bool have_good = false;

  const int max_iters = opts->max_iters + 1;
  for (int iter = 0; iter < max_iters; ++iter) {
    out->num_iters = iter + 1;
    // ---- Build: residuals + J at the current x ----
    fn(x, r, J, 1, ctx);
    T cost = T(0);
    for (int i = 0; i < n_res; ++i) cost += r[i] * r[i];
    if (!std::isfinite(cost)) {
      out->stop_reason = kSystemHasNaNOrInf;
      break;
    }

    BuildNormalEquations(J, r, n_res, dims, H, g);

    // ---- Accept / reject the cost at this point ----
    // λ ordering (matches the reference and the jitted loop): the solve
    // of this iteration's step uses λ as updated by the PREVIOUS
    // iteration's outcome; a GoodStep here only affects the NEXT solve,
    // while a BadStep (rollback + retry) escalates the λ used right away.
    const T lam_pre = lam;
    const T derr = cost - best_cost;
    const bool good = (derr < T(0)) || iter == 0;
    T rel_derr = T(0);
    if (have_good && best_cost > T(1e-12) && std::isfinite(best_cost))
      rel_derr = (best_cost - cost) / best_cost;

    const T* H_use;
    const T* g_use;
    if (good) {
      if (iter > 0) {
        // GoodStep: revert compounded bad factor, shrink lambda.
        T s = good_factor;
        if (bad_factor != opt_bad_factor) s /= bad_factor;
        lam *= s;
        if (lam < damping_min) lam = damping_min;
        bad_factor = opt_bad_factor;
      }
      best_cost = cost;
      have_good = true;
      out->num_consec_failures = 0;
      std::memcpy(x_best, x, sizeof(T) * dims);
      // The just-built system becomes the accepted one: swap buffers.
      std::swap(H, H_bst);
      std::swap(g, g_bst);
      H_use = H_bst;
      g_use = g_bst;
    } else {
      lam *= bad_factor;
      if (lam > damping_max) lam = damping_max;
      bad_factor *= opt_bad_factor;
      out->num_failures++;
      out->num_consec_failures++;
      std::memcpy(x, x_best, sizeof(T) * dims);  // rollback
      if (opts->max_consec_failures > 0 &&
          out->num_consec_failures >= opts->max_consec_failures) {
        out->stop_reason = kMaxConsecNoDecr;
        break;
      }
      if (opts->max_total_failures > 0 &&
          out->num_failures >= opts->max_total_failures) {
        out->stop_reason = kMaxNoDecr;
        break;
      }
      // Propose from the last accepted system — the Rebuild(false)
      // shortcut at zero copy cost.
      H_use = H_bst;
      g_use = g_bst;
    }

    // ---- Stop criteria on the (good) state ----
    if (good) {
      if (opts->min_error > 0 && cost < static_cast<T>(opts->min_error)) {
        out->stop_reason = kMinError;
        break;
      }
      if (opts->min_rerr_dec > 0 && rel_derr > T(0) &&
          rel_derr < static_cast<T>(opts->min_rerr_dec)) {
        out->stop_reason = kMinRelError;
        break;
      }
      T gn2 = T(0);
      for (int a = 0; a < dims; ++a) gn2 += g_use[a] * g_use[a];
      if (opts->min_grad_norm2 > 0 &&
          gn2 < static_cast<T>(opts->min_grad_norm2)) {
        out->stop_reason = kMinGradNorm;
        break;
      }
    }
    if (iter + 1 >= max_iters) break;

    // ---- Propose a step ----
    // Accepted: solve with λ from before this iteration's GoodStep
    // (the reference solves first, updates after). Rejected: solve with
    // the freshly escalated λ (the reference's next-step re-damp).
    T lam_solve = good ? lam_pre : lam;
    bool solved = false;
    for (int attempt = 0; attempt <= (opts->max_consec_failures > 0
                                          ? opts->max_consec_failures
                                          : 50);
         ++attempt) {
      if (is_gd) {
        for (int a = 0; a < dims; ++a) dx[a] = -gd_lr * g_use[a];
        solved = true;
        break;
      }
      if (CholeskySolveDamped<T>(H_use, g_use, is_lm ? lam_solve : T(0),
                                 dims, L, dx)) {
        solved = true;
        break;
      }
      if (!is_lm) break;  // GN has no damping to escalate
      lam_solve *= bad_factor;
      lam *= bad_factor;  // FailedStep escalation persists (lm.h:148)
      if (lam_solve > damping_max) lam_solve = damping_max;
      if (lam > damping_max) lam = damping_max;
      bad_factor *= opt_bad_factor;
      out->num_failures++;
      out->num_consec_failures++;
      if (opts->max_consec_failures > 0 &&
          out->num_consec_failures >= opts->max_consec_failures) break;
    }
    if (!solved) {
      out->stop_reason = kSolverFailed;
      break;
    }

    T dn2 = T(0);
    for (int a = 0; a < dims; ++a) dn2 += dx[a] * dx[a];
    if (!std::isfinite(dn2)) {
      out->stop_reason = kSystemHasNaNOrInf;
      break;
    }
    if (opts->min_step_norm2 > 0 &&
        dn2 < static_cast<T>(opts->min_step_norm2)) {
      out->stop_reason = kMinDeltaNorm;
      break;
    }
    for (int a = 0; a < dims; ++a) x[a] += dx[a];
  }

  if (out->stop_reason == kNone) out->stop_reason = kMaxIters;
  // Return the best point seen.
  std::memcpy(x, x_best, sizeof(T) * dims);
  out->final_cost = static_cast<double>(best_cost);
  return out->stop_reason;
}

// ---------------------------------------------------------------------
// Built-in benchmark problems (no callback overhead), mirroring the
// reference benchmark suite (reference: benchmarks/dense.cpp:28-114,
// float variants benchmarks/densef.cpp:24-50).
// ---------------------------------------------------------------------

template <typename T>
struct PriorCtx {
  const T* y;
  const T* inv_std;
  int dims;
};

template <typename T>
void PriorResJac(const T* x, T* r, T* J, int jac, void* ctx) {
  const PriorCtx<T>* c = static_cast<const PriorCtx<T>*>(ctx);
  const int d = c->dims;
  for (int i = 0; i < d; ++i) r[i] = (x[i] - c->y[i]) * c->inv_std[i];
  if (jac) {
    std::memset(J, 0, sizeof(T) * d * d);
    for (int i = 0; i < d; ++i) J[i * d + i] = c->inv_std[i];
  }
}

template <typename T>
void Sqrt2ResJac(const T* x, T* r, T* J, int jac, void*) {
  r[0] = x[0] * x[0] - T(2);
  if (jac) J[0] = T(2) * x[0];
}

template <typename T>
double BenchPriorUs(int32_t dims, const T* y, const T* inv_std,
                    const T* x0, const NativeOptions* opts, int32_t reps,
                    T* x_out) {
  PriorCtx<T> ctx{y, inv_std, dims};
  T r[kMaxDims];
  T J[kMaxDims * kMaxDims];
  T x[kMaxDims];
  NativeOutput out;
  volatile T sink = T(0);
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) {
    std::memcpy(x, x0, sizeof(T) * dims);
    SolveCore<T>(dims, dims, PriorResJac<T>, &ctx, x, opts, &out, r, J);
    sink += x[0];
  }
  const auto t1 = std::chrono::steady_clock::now();
  if (x_out) std::memcpy(x_out, x, sizeof(T) * dims);
  (void)sink;
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / reps;
}

template <typename T>
double BenchSqrt2Us(T x0, const NativeOptions* opts, int32_t reps,
                    T* x_out) {
  T r[1];
  T J[1];
  T x[1];
  NativeOutput out;
  volatile T sink = T(0);
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) {
    x[0] = x0;
    SolveCore<T>(1, 1, Sqrt2ResJac<T>, nullptr, x, opts, &out, r, J);
    sink += x[0];
  }
  const auto t1 = std::chrono::steady_clock::now();
  if (x_out) x_out[0] = x[0];
  (void)sink;
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / reps;
}

}  // namespace

extern "C" {

// ------------------------------ float64 -------------------------------

int32_t tinyopt_solve(int32_t dims, int32_t n_res, ResJacFn fn, void* ctx,
                      double* x, const NativeOptions* opts,
                      NativeOutput* out, double* r, double* J) {
  return SolveCore<double>(dims, n_res, fn, ctx, x, opts, out, r, J);
}

int32_t tinyopt_bench_prior(int32_t dims, const double* y,
                            const double* inv_std, double* x,
                            const NativeOptions* opts, NativeOutput* out) {
  PriorCtx<double> ctx{y, inv_std, dims};
  double r[kMaxDims];
  double J[kMaxDims * kMaxDims];
  return SolveCore<double>(dims, dims, PriorResJac<double>, &ctx, x, opts,
                           out, r, J);
}

int32_t tinyopt_bench_sqrt2(double* x, const NativeOptions* opts,
                            NativeOutput* out) {
  double r[1];
  double J[1];
  return SolveCore<double>(1, 1, Sqrt2ResJac<double>, nullptr, x, opts,
                           out, r, J);
}

double tinyopt_bench_prior_us(int32_t dims, const double* y,
                              const double* inv_std, const double* x0,
                              const NativeOptions* opts, int32_t reps,
                              double* x_out) {
  return BenchPriorUs<double>(dims, y, inv_std, x0, opts, reps, x_out);
}

double tinyopt_bench_sqrt2_us(double x0, const NativeOptions* opts,
                              int32_t reps, double* x_out) {
  return BenchSqrt2Us<double>(x0, opts, reps, x_out);
}

// ------------------------------ float32 -------------------------------
// Same semantics at f32 working precision (reference float suite,
// benchmarks/densef.cpp:24-50; published row: sqrt2-float 0.91 us,
// BASELINE.md row 0).  Pass f32-scaled stop thresholds (the Python
// wrapper's make_options(dtype=np.float32) mirrors Options.for_dtype).

int32_t tinyopt_solve_f32(int32_t dims, int32_t n_res, ResJacFnF fn,
                          void* ctx, float* x, const NativeOptions* opts,
                          NativeOutput* out, float* r, float* J) {
  return SolveCore<float>(dims, n_res, fn, ctx, x, opts, out, r, J);
}

int32_t tinyopt_bench_prior_f32(int32_t dims, const float* y,
                                const float* inv_std, float* x,
                                const NativeOptions* opts,
                                NativeOutput* out) {
  PriorCtx<float> ctx{y, inv_std, dims};
  float r[kMaxDims];
  float J[kMaxDims * kMaxDims];
  return SolveCore<float>(dims, dims, PriorResJac<float>, &ctx, x, opts,
                          out, r, J);
}

int32_t tinyopt_bench_sqrt2_f32(float* x, const NativeOptions* opts,
                                NativeOutput* out) {
  float r[1];
  float J[1];
  return SolveCore<float>(1, 1, Sqrt2ResJac<float>, nullptr, x, opts, out,
                          r, J);
}

double tinyopt_bench_prior_us_f32(int32_t dims, const float* y,
                                  const float* inv_std, const float* x0,
                                  const NativeOptions* opts, int32_t reps,
                                  float* x_out) {
  return BenchPriorUs<float>(dims, y, inv_std, x0, opts, reps, x_out);
}

double tinyopt_bench_sqrt2_us_f32(float x0, const NativeOptions* opts,
                                  int32_t reps, float* x_out) {
  return BenchSqrt2Us<float>(x0, opts, reps, x_out);
}

}  // extern "C"
