// The IOD's two-sided Lagrange f-g refinement on Hopper (sm_90a): one
// thread per candidate, each running the whole refinement to its own exit.
//
// Replaces no Pallas kernel.  It replaces the XLA while_loop of
// outfit_tpu/iod/gauss.py:_fg_correction (177-319), whose PyTorch form
// (outfit_tpu_torch/iod/gauss.py:_fg_correction_plain) runs as a Python loop
// of batched tensor operations: each outer trip, and each trip of the
// universal Kepler Newton loop nested in it, launches hundreds of small
// elementwise kernels over every candidate and reads the device once to
// test for its exit.  On an H100 that loop was host-bound: about 600 device
// reads a dataset of the short-arc stream, the card idle under them, and
// four of five candidates already done or rejected on an average trip,
// frozen by masked selects.  This kernel was added for that.
//
// What bounds it: float32 / float64 issue under warp divergence.  A
// candidate reads 30-odd numbers and writes 17, against some thousands of
// operations per live trip (two Kepler solves of up to 50 Newton steps, each
// with a 12-term Stumpff series and its duplications); the lanes of a warp
// run different numbers of outer and Newton trips, so a warp issues for its
// slowest lane.
//
// The design's answer:
// * registers only: a thread keeps its candidate's state (position at the
//   three epochs, velocity, epoch, the two warm starts chi1 / chi2, alive,
//   done, committed) in registers for the whole refinement; the triplet's
//   tables (observer positions, S^-1, line-of-sight unit vectors, epochs)
//   are read through the read-only path where each is used, so that the
//   float64 instantiation stays within its registers.  No shared memory:
//   threads share nothing;
// * a per-lane exit: a thread leaves the outer loop when its candidate is
//   done or rejected, and each Kepler solve when its Newton step converged,
//   instead of running frozen trips until the batch's slowest lane ends;
// * one launch for the whole refinement, and one read of its summary
//   ([the most outer trips a candidate ran, their sum]) for the program's
//   counters: no host round trip inside.
//
// Same answer as the plain loop: there a candidate that is done or rejected
// keeps its state, warm starts and decisions on every later trip (alive &
// ~done never turns true again), and a converged Kepler lane keeps its
// psi, so the thread's own exit changes no value.  Every expression follows
// the plain path's operation order and types, and with -fmad=false each
// product and sum rounds alone, as PyTorch's elementwise kernels round them:
// * a tensor divided by a Python number is, on a CUDA tensor, a product
//   with the number's reciprocal, taken in float64 and rounded to the
//   working type (div_scalar), and a Python number divided by a tensor is
//   the tensor's reciprocal times the number (rdiv_scalar);
// * torch.sum over the last axis of 3 contiguous terms splits them over two
//   threads of PyTorch's reduction, (x0 + x2) + x1 (sum3_last); over the
//   middle axis of (3, 3) one thread adds them in order, (x0 + x1) + x2
//   (sum3_mid); over the 9 terms of a (3, 3) block 8 threads and a
//   shuffle tree (sum9), ATen/native/cuda/Reduce.cuh.  Each adds a zero at
//   the end, as the reduction's identity makes a negative zero positive;
// * the mixed path's absolute MJDs stay float64: the light-time epoch is
//   the float64 central MJD less the float32 quotient, promoted.
//
// The thread also writes the number of outer trips at whose start its
// candidate was alive and not done, and a warp adds its lanes' counts (and
// takes their maximum) into the two-number summary with one atomic each.

#pragma once

#include <cfloat>
#include <cuda_runtime.h>

namespace outfit_fg {

constexpr int kBlock = 128;

template <typename T>
struct Lim;
template <>
struct Lim<float> {
  static constexpr float kMax = FLT_MAX;
  static constexpr double kEps = FLT_EPSILON;
};
template <>
struct Lim<double> {
  static constexpr double kMax = DBL_MAX;
  static constexpr double kEps = DBL_EPSILON;
};

__device__ __forceinline__ float vsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double vsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float vabs(float x) { return fabsf(x); }
__device__ __forceinline__ double vabs(double x) { return fabs(x); }
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double vmax(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double vmin(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float vceil(float x) { return ceilf(x); }
__device__ __forceinline__ double vceil(double x) { return ceil(x); }
__device__ __forceinline__ float vlog2(float x) { return log2f(x); }
__device__ __forceinline__ double vlog2(double x) { return log2(x); }
__device__ __forceinline__ float vldexp(float x, int e) { return ldexpf(x, e); }
__device__ __forceinline__ double vldexp(double x, int e) { return ldexp(x, e); }

template <typename T>
__device__ __forceinline__ bool is_nan(T x) {
  return x != x;
}
template <typename T>
__device__ __forceinline__ bool is_finite(T x) {
  return vabs(x) <= Lim<T>::kMax;
}

// x / c for a Python number c: x times 1 / c, taken in float64 and
// rounded to the working type
template <typename T>
__device__ __forceinline__ T div_scalar(T x, double c) {
  return x * T(1.0 / c);
}
// c / x for a Python number c: reciprocal(x) * c
template <typename T>
__device__ __forceinline__ T rdiv_scalar(double c, T x) {
  return (T(1) / x) * T(c);
}
// torch.clamp(x, lo, hi) on a CUDA tensor: a NaN passes through
template <typename T>
__device__ __forceinline__ T clamp(T x, T lo, T hi) {
  return is_nan(x) ? x : vmin(vmax(x, lo), hi);
}

template <typename T>
__device__ __forceinline__ T sum3_last(T x0, T x1, T x2) {
  return ((x0 + x2) + x1) + T(0);
}
template <typename T>
__device__ __forceinline__ T sum3_mid(T x0, T x1, T x2) {
  return ((x0 + x1) + x2) + T(0);
}
template <typename T>
__device__ __forceinline__ T sum9(const T* x) {
  return (((x[0] + x[8]) + x[4]) + (x[2] + x[6])) + ((x[1] + x[5]) + (x[3] + x[7])) + T(0);
}

template <typename T>
__device__ __forceinline__ T dot3(const T* a, const T* b) {
  return sum3_last(a[0] * b[0], a[1] * b[1], a[2] * b[2]);
}

template <typename T>
__device__ __forceinline__ void cross3(const T* a, const T* b, T* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// The scalars of one call (outfit_tpu_torch/iod/fg_correction_cuda.py).
struct FgParams {
  int max_it;        // outer trips
  int max_newton;    // Kepler Newton steps (SolverConfig.max_newton)
  double conv;       // Newton step tolerance, floored at 100 eps of the working type
  double done_eps;   // relative position change, floored at 10 eps of the working type
  double peri_max;   // IODParams.max_perihelion_au
  double ecc_max;    // IODParams.max_ecc
  double min_rho2;   // IODParams.min_rho2_au
  double mu;         // GAUSS_GRAV_SQUARED
  double sqrt_mu;    // math.sqrt(mu)
  double vlight;     // VLIGHT_AU
  double h_min;      // absolute angular-momentum guard, 1e6 float64 eps
};

template <typename T>
struct FgArgs {
  // per triplet, M = n / per of them: (M, 3, 3), (M, 3, 3), (M, 3, 3), (M, 3), (M,), (M,)
  const T* __restrict__ obs_pos;
  const T* __restrict__ s_inv;
  const T* __restrict__ u;
  const double* __restrict__ time;
  const double* __restrict__ dt01;
  const double* __restrict__ dt21;
  // per candidate: (n, 3, 3), (n, 3), (n,) each
  const T* __restrict__ pos;
  const T* __restrict__ vel;
  const double* __restrict__ epoch;
  const T* __restrict__ chi1;
  const T* __restrict__ chi2;
  const bool* __restrict__ alive;
  T* __restrict__ pos_out;
  T* __restrict__ vel_out;
  double* __restrict__ epoch_out;
  T* __restrict__ chi1_out;
  T* __restrict__ chi2_out;
  bool* __restrict__ alive_out;
  bool* __restrict__ committed_out;
  int* __restrict__ trips_out;
  unsigned long long* __restrict__ summary;  // [max trips, sum of trips], zeroed by the caller
  long long n;
  long long per;  // candidates per triplet
  FgParams p;
};

// kepler/stumpff.py:halving_count
template <typename T>
__device__ __forceinline__ int halving_count(T psi, T alpha) {
  const T beta = (alpha * psi) * psi;
  const T ab = vabs(beta);
  const T safe = is_nan(ab) ? ab : vmax(ab, T(1));
  const T kf = clamp(vceil(T(0.5) * vlog2(div_scalar(safe, 1.0))), T(0), T(40));
  return is_nan(kf) ? 0 : static_cast<int>(kf);
}

// kepler/stumpff.py:s_funct with the lane's own halving count k
template <typename T>
__device__ __forceinline__ void s_funct(T psi, T alpha, int k, T& s0, T& s1, T& s2, T& s3) {
  const T beta = (alpha * psi) * psi;
  const T scale = vldexp(T(1), -k);
  const T psi_r = psi * scale;
  const T beta_r = (beta * scale) * scale;
  const T psi2 = psi_r * psi_r;
  s2 = T(0.5) * psi2;
  s3 = div_scalar(s2 * psi_r, 3.0);
  T term2 = s2, term3 = s3;
#pragma unroll
  for (int n = 1; n <= 12; ++n) {
    term2 = term2 * div_scalar(beta_r, (2.0 * n + 1.0) * (2.0 * n + 2.0));
    term3 = term3 * div_scalar(beta_r, (2.0 * n + 2.0) * (2.0 * n + 3.0));
    s2 = s2 + term2;
    s3 = s3 + term3;
  }
  T p = psi_r;
  for (int i = 0; i < k; ++i) {
    const T s2n = (T(2) * s2) * (T(2) + alpha * s2);
    const T s3n = T(2) * ((s3 + p * s2) + (alpha * s2) * s3);
    p = T(2) * p;
    s2 = s2n;
    s3 = s3n;
  }
  s0 = T(1) + alpha * s2;
  s1 = psi + alpha * s3;
}

// The state at the central epoch that both sides' Kepler solves start
// from (kepler/universal.py:velocity_correction's r2, sig2, degenerate,
// and alpha from elements/orb_elem.py:eccentricity_control's energy).
template <typename T>
struct Central {
  T r2, sig2, alpha, sqrt_mu;
  bool degenerate;
};

// elements/orb_elem.py:eccentricity_control: accepted, and the energy
template <typename T>
__device__ __forceinline__ bool eccentricity_control(const T* x, const T* v, const FgParams& p, T& energy) {
  const T v2 = dot3(v, v);
  const T r = vsqrt(dot3(x, x));
  T h[3];
  cross3(x, v, h);
  const T h2 = dot3(h, h);
  const bool degenerate = vsqrt(h2) == T(0);
  const T r_safe = r > T(0) ? r : T(1);
  T vh[3], lenz[3];
  cross3(v, h, vh);
#pragma unroll
  for (int c = 0; c < 3; ++c) lenz[c] = div_scalar(vh[c], p.mu) - x[c] / r_safe;
  const T ecc = vsqrt(dot3(lenz, lenz));
  const T peri = h2 / ((T(1) + ecc) * T(p.mu));
  energy = div_scalar(v2, 2.0) - rdiv_scalar(p.mu, r_safe);
  return !degenerate && ecc < T(p.ecc_max) && peri < T(p.peri_max);
}

template <typename T>
__device__ __forceinline__ Central<T> central_state(const T* x2, const T* v2, const FgParams& p) {
  Central<T> c;
  c.r2 = vsqrt(dot3(x2, x2));
  c.sig2 = div_scalar(dot3(x2, v2), p.sqrt_mu);
  T h[3];
  cross3(x2, v2, h);
  const T h_norm = vsqrt(dot3(h, h));
  c.degenerate = !is_finite(h_norm) || h_norm <= T(p.h_min);
  T energy;
  eccentricity_control(x2, v2, p, energy);
  c.alpha = div_scalar(T(2) * energy, p.mu);
  c.sqrt_mu = vsqrt(T(p.mu));
  return c;
}

template <typename T>
struct Side {
  T v[3], f, g, psi;
  int status;  // 0 ok, 1 no convergence, 2 degenerate state, 4 unstable g
};

// kepler/universal.py:velocity_correction from the central state over dt,
// with solve_kepuni's Newton-only path (_newton, no bracketing fallback)
// warm-started at chi; the step loop ends at the lane's own convergence.
template <typename T>
__device__ __forceinline__ Side<T> velocity_correction(const T* x1, const T* x2, const Central<T>& c, double dt_d,
                                                       T chi, const FgParams& p) {
  const T dt = T(dt_d);
  const T smdt = c.sqrt_mu * dt;
  const T res_tol = T(10.0 * Lim<T>::kEps) * (T(1) + vabs(smdt));
  const T der_min = T(10.0 * Lim<T>::kEps);
  const T conv = T(p.conv);
  T psi = chi;
  bool done = false;
  for (int it = 0; it < p.max_newton && !done; ++it) {
    const T psi_s = is_finite(psi) ? psi : T(0.5);
    T s0, s1, s2, s3;
    s_funct(psi_s, c.alpha, halving_count(psi_s, c.alpha), s0, s1, s2, s3);
    const T res = ((c.r2 * s1 + c.sig2 * s2) + s3) - smdt;
    const T der = (c.r2 * s0 + c.sig2 * s1) + s2;
    const bool res_ok = vabs(res) <= res_tol;
    const bool der_bad = !is_finite(der) || vabs(der) < der_min;
    const T raw = -res / (der_bad ? T(1) : der);
    const T mx = T(2) * (T(1) + vabs(psi_s));
    const T step = clamp(raw, -mx, mx);
    T cand = psi_s + step;
    cand = cand * psi_s < T(0) ? T(0.5) * psi_s : cand;  // sign-change damping
    const T new_psi = der_bad ? T(0.5) * psi_s : cand;
    const bool step_conv = !der_bad && vabs(step) <= conv * (T(1) + vabs(new_psi));
    psi = res_ok ? psi_s : new_psi;
    done = res_ok || step_conv;
  }
  T s0, s1, s2, s3;
  s_funct(psi, c.alpha, halving_count(psi, c.alpha), s0, s1, s2, s3);
  Side<T> out;
  out.f = T(1) - s2 / c.r2;
  out.g = dt - div_scalar(s3, p.sqrt_mu);
  const T g_min = T(100.0 * Lim<T>::kEps) * (T(1) + vabs(dt));
  const bool g_bad = !is_finite(out.g) || vabs(out.g) < g_min;
  const T g_safe = g_bad ? T(1) : out.g;
#pragma unroll
  for (int k = 0; k < 3; ++k) out.v[k] = (x1[k] - out.f * x2[k]) / g_safe;
  out.psi = psi;
  out.status = c.degenerate ? 2 : (!done ? 1 : (g_bad ? 4 : 0));
  return out;
}

template <typename T>
__global__ void __launch_bounds__(kBlock) fg_correction_kernel(FgArgs<T> a) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  unsigned trips = 0;
  if (i < a.n) {
    const FgParams& p = a.p;
    const T feps = T(Lim<T>::kEps);
    const long long t = i / a.per;
    const T* obs = a.obs_pos + 9 * t;
    const T* sinv = a.s_inv + 9 * t;
    const T* uu = a.u + 9 * t;
    const double time1 = __ldg(a.time + 3 * t + 1);
    const double dt01 = __ldg(a.dt01 + t);
    const double dt21 = __ldg(a.dt21 + t);

    T cpos[9], cvel[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) cpos[k] = a.pos[9 * i + k];
#pragma unroll
    for (int k = 0; k < 3; ++k) cvel[k] = a.vel[3 * i + k];
    double cepoch = a.epoch[i];
    T chi1 = a.chi1[i], chi2 = a.chi2[i];
    bool alive = a.alive[i], done = false, committed = false;

    for (int it = 0; it < p.max_it && alive && !done; ++it) {
      ++trips;
      // both sides start from the state at the central epoch
      const Central<T> c = central_state(cpos + 3, cvel, p);
      const Side<T> left = velocity_correction(cpos, cpos + 3, c, dt01, chi1, p);
      const Side<T> right = velocity_correction(cpos + 6, cpos + 3, c, dt21, chi2, p);
      const bool iter_ok = left.status == 0 && right.status == 0;
      const bool chi_upd = iter_ok && alive && !done;
      const T chi1n = chi_upd ? left.psi : chi1;
      const T chi2n = chi_upd ? right.psi : chi2;

      T new_vel[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) new_vel[k] = T(0.5) * (left.v[k] + right.v[k]);
      const T fl = left.f * right.g - right.f * left.g;
      const bool fl_ok = is_finite(fl) && vabs(fl) > feps;
      const T inv_f = rdiv_scalar(1.0, fl_ok ? fl : T(1));
      const T cv[3] = {right.g * inv_f, T(-1), -left.g * inv_f};

      // iod/gauss.py:_positions_from_cvec
      T gcap[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        gcap[k] = sum3_mid(cv[0] * __ldg(obs + k), cv[1] * __ldg(obs + 3 + k), cv[2] * __ldg(obs + 6 + k));
      T rho[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const T crhom = sum3_last(__ldg(sinv + 3 * j) * gcap[0], __ldg(sinv + 3 * j + 1) * gcap[1],
                                  __ldg(sinv + 3 * j + 2) * gcap[2]);
        rho[j] = -crhom / cv[j];
      }
      const bool rho_ok = rho[1] >= T(p.min_rho2);
      T new_pos[9];
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int k = 0; k < 3; ++k) new_pos[3 * j + k] = __ldg(obs + 3 * j + k) + rho[j] * __ldg(uu + 3 * j + k);
      const double new_epoch = time1 - static_cast<double>(div_scalar(rho[1], p.vlight));

      T energy;
      const bool acc_i = eccentricity_control(new_pos + 3, new_vel, p, energy);
      const bool hard_reject = iter_ok && fl_ok && rho_ok && !acc_i && !done;
      const bool commit = iter_ok && fl_ok && rho_ok && acc_i && alive && !done;

      T sq[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) sq[k] = new_pos[k] * new_pos[k];
      const T denom = vsqrt(sum9(sq));
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const T d = new_pos[k] - cpos[k];
        sq[k] = d * d;
      }
      const T rel_err = vsqrt(sum9(sq)) / (denom > feps ? denom : T(1));

      if (commit) {
#pragma unroll
        for (int k = 0; k < 9; ++k) cpos[k] = new_pos[k];
#pragma unroll
        for (int k = 0; k < 3; ++k) cvel[k] = new_vel[k];
        cepoch = new_epoch;
      }
      alive = alive && !hard_reject;
      committed = committed || commit;
      // a lane that neither commits nor moves its warm starts is stationary
      const bool stalled = alive && !done && !commit && vabs(chi1n - chi1) <= feps * (T(1) + vabs(chi1)) &&
                           vabs(chi2n - chi2) <= feps * (T(1) + vabs(chi2));
      done = done || (commit && rel_err <= T(p.done_eps)) || stalled;
      chi1 = chi1n;
      chi2 = chi2n;
    }

#pragma unroll
    for (int k = 0; k < 9; ++k) a.pos_out[9 * i + k] = cpos[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) a.vel_out[3 * i + k] = cvel[k];
    a.epoch_out[i] = cepoch;
    a.chi1_out[i] = chi1;
    a.chi2_out[i] = chi2;
    a.alive_out[i] = alive;
    a.committed_out[i] = committed;
    a.trips_out[i] = static_cast<int>(trips);
  }
  // the summary: one atomic per warp (every lane of the block reaches here)
  const unsigned most = __reduce_max_sync(0xffffffffu, trips);
  const unsigned total = __reduce_add_sync(0xffffffffu, trips);
  if ((threadIdx.x & 31) == 0 && total != 0) {
    atomicMax(a.summary, static_cast<unsigned long long>(most));
    atomicAdd(a.summary + 1, static_cast<unsigned long long>(total));
  }
}

}  // namespace outfit_fg
