// One two-body Newton step of the differential correction on Hopper
// (sm_90a): one warp per trajectory.
//
// Replaces no Pallas kernel.  It replaces the XLA body of
// outfit_tpu/lsq/iteration.py:single_iteration on the two-body path, whose
// PyTorch form (outfit_tpu_torch/lsq/iteration.py:_single_iteration_plain)
// runs as some 1,800-1,950 small batched tensor operations a step: the
// generalized Kepler solve with one device read per trip
// (elements/twobody.py:solve_generalized_kepler), the positions, velocities
// and 6x3 partials (propagate_twobody), the rotation and aberration chain,
// the residuals, the normal equations and the unrolled 6x6 Cholesky inverse
// (utils/linalg.py:cholesky_inverse6).  On an H100 the host's dispatch of
// those operations set the pace of every fit; the card sat idle under it.
//
// What bounds it: bytes.  A step reads an observation's 13-17 numbers and
// writes 18 (residuals, 12 masked partials, the Kepler state, the active
// flag), and a trajectory's 6 elements in and some 80 numbers out, against
// a few hundred operations an observation and a few Newton trips of the
// Kepler solve (the previous step's solution is the warm start).  The
// stream's 8,192 x 12 float64 step moves ~28 MB, the seeded 4,096 x 129
// step ~124 MB: ~8 and ~37 us at 3.35 TB/s.  Below that bound the time
// goes to the lanes left idle past a short arc's 12 observations and to
// the one lane's serial solve at each warp's end.
//
// The design's answer:
// * one launch for the whole step and no device read: the Kepler solve
//   runs inside, each observation to its own exit, so the host no longer
//   tests the batch's slowest lane once a trip;
// * one warp per trajectory: each lane strides over the trajectory's padded
//   observations (12 in the stream, up to 129 in a catalogue arc), reads
//   them coalesced with its neighbours, and keeps what it computes in
//   registers; the 21 normal entries, 6 right-hand-side entries, the
//   weighted sum of squares q and the count m are summed by each lane over
//   its observations in order, then over the warp by a fixed xor-shuffle
//   tree, so the order is the same in every batch and a trajectory reads
//   nothing of another's (batch isolation);
// * one lane then masks the fixed elements, inverts and writes the
//   trajectory's results.
//
// Same numbers as the plain path on the card: every per-observation
// expression follows the plain path's operation order and types, and with
// -fmad=false each product and sum rounds alone, as PyTorch's elementwise
// kernels round them:
// * a tensor divided by a Python number is a product with the number's
//   reciprocal in the working type (div_scalar), a Python number divided by
//   a tensor the tensor's reciprocal times the number (Tensor.__rtruediv__),
//   x ** 2 and x ** 3 the products x * x and (x * x) * x;
// * torch.remainder is fmod with the sign fixed; torch.clamp passes a NaN;
// * torch.sum over the last axis of 3 contiguous terms is (x0 + x2) + x1
//   (two threads of PyTorch's reduction), of 6 terms
//   ((x0 + x4) + x2) + ((x1 + x5) + x3) (four threads, then a shuffle tree
//   at offsets 2 and 1), ATen/native/cuda/Reduce.cuh, as measured on the
//   card with torch 2.11; each adds a zero at the end, as the reduction's
//   identity makes a negative zero positive.
// The sums over observations (the normal matrix, the right-hand side, q)
// are taken in this kernel's own order, not torch.sum's over the middle
// axis, so they and what follows from them (the covariance, the
// correction, its norm, the RMS) may differ from the plain path's in the
// last bits.
//
// Three instantiations: <float, float> for the mixed-precision pre-warm,
// <double, float> for the mixed main loop (the float64 propagation, then
// the Jacobian pass in float32 from the float64 Kepler solution cast to
// float32; dt is formed in float64 and cast), <double, double> for the
// float64 loop and the mixed final linearisation.

#pragma once

#include <cfloat>
#include <cuda_runtime.h>

namespace outfit_lsq {

constexpr int kWarps = 4;  // trajectories a block
constexpr int kBlock = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

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
__device__ __forceinline__ float vfloor(float x) { return floorf(x); }
__device__ __forceinline__ double vfloor(double x) { return floor(x); }
__device__ __forceinline__ float vfmod(float a, float b) { return fmodf(a, b); }
__device__ __forceinline__ double vfmod(double a, double b) { return fmod(a, b); }
__device__ __forceinline__ float vatan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double vatan2(double y, double x) { return atan2(y, x); }

template <typename T>
__device__ __forceinline__ bool is_nan(T x) {
  return x != x;
}
template <typename T>
__device__ __forceinline__ bool is_finite(T x) {
  return vabs(x) <= Lim<T>::kMax;
}
// 1 / x, a Python number over a tensor (torch.reciprocal)
template <typename T>
__device__ __forceinline__ T rcp(T x) {
  return T(1) / x;
}
// x / c for a Python number c: x times the reciprocal of c, taken in the
// working type
template <typename T>
__device__ __forceinline__ T div_scalar(T x, double c) {
  return x * (T(1) / T(c));
}
// torch.clamp(x, lo, hi) and torch.clamp(x, min=lo): a NaN passes through
template <typename T>
__device__ __forceinline__ T clamp(T x, T lo, T hi) {
  return is_nan(x) ? x : vmin(vmax(x, lo), hi);
}
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return is_nan(x) ? x : vmax(x, lo);
}
// torch.remainder(a, b): fmod with the sign of b
template <typename T>
__device__ __forceinline__ T remainder(T a, T b) {
  T m = vfmod(a, b);
  if (m != T(0) && ((b < T(0)) != (m < T(0)))) m = m + b;
  return m;
}
template <typename T>
__device__ __forceinline__ T sum3(T x0, T x1, T x2) {
  return ((x0 + x2) + x1) + T(0);
}
template <typename T>
__device__ __forceinline__ T sum6(const T* x) {
  return (((x[0] + x[4]) + x[2]) + ((x[1] + x[5]) + x[3])) + T(0);
}

// The scalars of one call (outfit_tpu_torch/lsq/step_cuda.py): the plain
// path's constants, passed as the Python numbers it uses.
struct StepParams {
  double mu;        // GAUSS_GRAV_SQUARED
  double vlight;    // VLIGHT_AU
  double dpi;       // DPI
  double pi;        // math.pi
  double circ;      // 100 float64 eps: the circular-orbit threshold on e^2
  double res_tol;   // Kepler residual acceptance, 1e-12 rad
  double rot[9];    // ROT_ECLMJ2000_TO_EQUMJ2000, row-major
  double sin_c[8];  // the Taylor coefficients of _sincos_step
  double cos_c[9];
  int max_iter;     // Kepler Newton trips, 25
};

template <typename P>
struct StepArgs {
  // per trajectory: (T, 6), (T,); per observation (T, N), helio (T, N, 3)
  const P* __restrict__ elements;
  const double* __restrict__ epoch;
  const int* __restrict__ selection;
  const double* __restrict__ mjd;
  const P* __restrict__ ra;
  const P* __restrict__ dec;
  const P* __restrict__ sigma_ra;
  const P* __restrict__ sigma_dec;
  const P* __restrict__ helio;
  const bool* __restrict__ valid;
  const P* __restrict__ bias_ra;   // null: unbiased
  const P* __restrict__ bias_dec;
  // the warm start (F, sin F, cos F), each (T, N) at its own strides; null: cold
  const P* __restrict__ warm[3];
  long long warm_st[3][2];
  const bool* __restrict__ free;  // (6,)
  // outputs, in IterationResult's order
  P* __restrict__ corrected;   // (T, 6)
  P* __restrict__ corr_norm;   // (T,)
  P* __restrict__ rms;         // (T,)
  P* __restrict__ normal;      // (T, 6, 6)
  P* __restrict__ cov;         // (T, 6, 6)
  bool* __restrict__ inv_ok;   // (T,)
  int* __restrict__ m;         // (T,)
  P* __restrict__ res_ra;      // (T, N)
  P* __restrict__ res_dec;     // (T, N)
  P* __restrict__ d_ra;        // (T, N, 6)
  P* __restrict__ d_dec;       // (T, N, 6)
  bool* __restrict__ active;   // (T, N)
  P* __restrict__ kepler;      // (T, N, 3)
  long long T;
  long long N;
  StepParams p;
};

template <typename T>
struct Elements {
  T a, h, k, p, q, lam;
};

// kepler/angles.py:principal_angle
template <typename T>
__device__ __forceinline__ T principal_angle(T x, const StepParams& p) {
  return x - vfloor(div_scalar(x, p.dpi)) * T(p.dpi);
}

// elements/twobody.py:_sincos_step (Horner in d^2)
template <typename T>
__device__ __forceinline__ void sincos_step(T d, const StepParams& p, T& s, T& c) {
  const T d2 = d * d;
  s = d2 * T(p.sin_c[7]) + T(p.sin_c[6]);
#pragma unroll
  for (int i = 5; i >= 0; --i) s = s * d2 + T(p.sin_c[i]);
  s = d * (d2 * s + T(1));
  c = d2 * T(p.cos_c[8]) + T(p.cos_c[7]);
#pragma unroll
  for (int i = 6; i >= 0; --i) c = c * d2 + T(p.cos_c[i]);
  c = d2 * c + T(1);
}

// propagate_twobody's mean motion and lambda(t1) in [varpi, varpi + 2 pi)
template <typename T>
__device__ __forceinline__ void mean_longitude(const Elements<T>& o, T dt, const StepParams& p, T& n, T& e2,
                                               T& lam1) {
  n = vsqrt(rcp((o.a * o.a) * o.a) * T(p.mu));
  lam1 = o.lam + n * dt;
  e2 = o.h * o.h + o.k * o.k;
  const T varpi = e2 > T(p.circ) ? principal_angle(vatan2(o.h, o.k), p) : T(0);
  lam1 = principal_angle(lam1, p);
  lam1 = lam1 < varpi ? lam1 + T(p.dpi) : lam1;
}

// elements/twobody.py:solve_generalized_kepler to the lane's own exit: a
// lane done in the plain loop keeps its state on the later trips, so
// leaving the loop changes no value
template <typename T>
__device__ __forceinline__ bool solve_kepler(const Elements<T>& o, T e2, T lam, bool warm, T fw, T sw, T cw,
                                             const StepParams& p, T& F, T& sF, T& cF) {
  const T eps = T(Lim<T>::kEps);
  const T tol = T(100.0 * Lim<T>::kEps);
  const T res_tol = T(p.res_tol);
  const bool circular = e2 <= T(p.circ);
  const T varpi = circular ? T(0) : principal_angle(vatan2(o.h, o.k), p);
  const T inv_e = circular ? T(0) : rcp(vsqrt(circular ? T(1) : e2));
  T f = varpi + T(p.pi);
  T s = (-o.h) * inv_e;
  T c = circular ? T(-1) : (-o.k) * inv_e;
  if (warm && is_finite(fw) && is_finite(sw) && is_finite(cw)) {
    f = varpi + remainder(fw - varpi, T(p.dpi));
    s = sw;
    c = cw;
  }
  bool done = false;
  for (int it = 0; it < p.max_iter && !done; ++it) {
    const T res = ((f - o.k * s) + o.h * c) - lam;
    const T der = (T(1) - o.k * c) - o.h * s;
    const T raw = (-res) / (vabs(der) > eps ? der : eps);
    const T step = clamp(raw, T(-1), T(1));
    T sd, cd;
    sincos_step(step, p, sd, cd);
    f = f + step;
    const T sn = s * cd + c * sd;
    const T cn = c * cd - s * sd;
    s = sn;
    c = cn;
    done = vabs(raw) <= tol || vabs(res) <= res_tol;
  }
  // first-order renormalisation of the rotation drift
  const T scale = T(0.5) * (T(3) - (s * s + c * c));
  F = f;
  sF = s * scale;
  cF = c * scale;
  return done;
}

// propagate_twobody's Cartesian state from a Kepler solution, and what its
// position partials need
template <typename T>
struct State {
  T pos[3], vel[3], f[3], g[3];
  T xe, ye, r, inv_u, beta;
};

template <typename T>
__device__ __forceinline__ State<T> cartesian(const Elements<T>& o, T n, T e2, T F, T sF, T cF) {
  State<T> st;
  st.beta = rcp(vsqrt(clamp_min(T(1) - e2, T(0))) + T(1));
  const T bhk = (st.beta * o.h) * o.k;
  const T bhh1 = T(1) - (st.beta * o.h) * o.h;
  const T bkk1 = T(1) - (st.beta * o.k) * o.k;
  st.xe = o.a * (((bhh1 * cF) + bhk * sF) - o.k);
  st.ye = o.a * (((bkk1 * sF) + bhk * cF) - o.h);
  const T pp = o.p * o.p, qq = o.q * o.q;
  st.inv_u = rcp((pp + T(1)) + qq);
  const T common = ((o.p * T(2)) * o.q) * st.inv_u;
  st.f[0] = ((T(1) - pp) + qq) * st.inv_u;
  st.f[1] = common;
  st.f[2] = (o.p * T(-2)) * st.inv_u;
  st.g[0] = common;
  st.g[1] = ((pp + T(1)) - qq) * st.inv_u;
  st.g[2] = (o.q * T(2)) * st.inv_u;
  st.r = vsqrt(st.xe * st.xe + st.ye * st.ye);
  const T v_const = ((n * o.a) * o.a) / st.r;
  const T v_xe = v_const * (bhk * cF - bhh1 * sF);
  const T v_ye = v_const * (bkk1 * cF - bhk * sF);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    st.pos[j] = st.xe * st.f[j] + st.ye * st.g[j];
    st.vel[j] = v_xe * st.f[j] + v_ye * st.g[j];
  }
  return st;
}

// propagate_twobody's position partials d(pos)/d(element e), column by
// column; the terms shared by columns 2 and 3 are taken once
template <typename T>
struct Partials {
  T dx[4];  // the in-plane coefficients of columns 2 and 3
  T dt;
};

template <typename T>
__device__ __forceinline__ Partials<T> partials(const Elements<T>& o, const State<T>& st, T lam1, T F, T sF, T cF,
                                                T dt) {
  const T inv_r = rcp(st.r);
  const T inv_1b = rcp(T(1) - st.beta);
  const T b3 = (st.beta * st.beta) * st.beta;
  const T tmp1 = lam1 - F;
  const T tmp2 = st.beta + ((o.h * o.h) * b3) * inv_1b;
  const T tmp3 = ((o.h * o.k) * b3) * inv_1b;
  const T tmp4 = st.beta * o.h - sF;
  const T tmp5 = st.beta * o.k - cF;
  const T tmp6 = st.beta + ((o.k * o.k) * b3) * inv_1b;
  Partials<T> d;
  d.dx[0] = (-o.a) * (tmp1 * tmp2 + ((o.a * cF) * tmp4) * inv_r);
  d.dx[1] = o.a * ((tmp1 * tmp3 - T(1)) + ((o.a * cF) * tmp5) * inv_r);
  d.dx[2] = (-o.a) * ((tmp1 * tmp3 + T(1)) - ((o.a * sF) * tmp4) * inv_r);
  d.dx[3] = o.a * (tmp1 * tmp6 - ((o.a * sF) * tmp5) * inv_r);
  d.dt = dt;
  return d;
}

template <typename T>
__device__ __forceinline__ T partial(int e, int j, const Elements<T>& o, const State<T>& st, const Partials<T>& d,
                                     T n) {
  switch (e) {
    case 0:
      return (st.pos[j] - (st.vel[j] * T(1.5)) * d.dt) / o.a;
    case 1:
      return d.dx[0] * st.f[j] + d.dx[1] * st.g[j];
    case 2:
      return d.dx[2] * st.f[j] + d.dx[3] * st.g[j];
    case 3: {
      const T w = j == 0 ? (o.p * T(2)) * st.inv_u
                         : (j == 1 ? (o.q * T(-2)) * st.inv_u : ((T(1) - o.p * o.p) - o.q * o.q) * st.inv_u);
      return (((o.q * (st.ye * st.f[j] - st.xe * st.g[j])) - st.xe * w) * T(2)) * st.inv_u;
    }
    case 4: {
      const T w = j == 0 ? (o.p * T(2)) * st.inv_u
                         : (j == 1 ? (o.q * T(-2)) * st.inv_u : ((T(1) - o.p * o.p) - o.q * o.q) * st.inv_u);
      return (((o.p * ((-st.ye) * st.f[j] + st.xe * st.g[j])) + st.ye * w) * T(2)) * st.inv_u;
    }
    default:
      return st.vel[j] / n;
  }
}

// the 28 sums of a trajectory: the normal matrix's lower triangle (row by
// row), the right-hand side, q; and m / 2, the active observations
template <typename P>
struct Sums {
  P v[28];
  int n_active;
};

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// One observation: the plain path's observation_partials and the
// per-observation part of single_iteration.
template <typename P, typename J>
__device__ __forceinline__ void observation(const StepArgs<P>& a, const Elements<P>& o, double epoch, long long t,
                                            long long i, Sums<P>& acc) {
  const StepParams& p = a.p;
  const double dt_d = a.mjd[i] - epoch;
  const P dt = P(dt_d);
  P n, e2, lam1;
  mean_longitude(o, dt, p, n, e2, lam1);
  const bool warm = a.warm[0] != nullptr;
  const long long n_obs = i - t * a.N;
  P fw = P(0), sw = P(0), cw = P(0);
  if (warm) {
    fw = a.warm[0][t * a.warm_st[0][0] + n_obs * a.warm_st[0][1]];
    sw = a.warm[1][t * a.warm_st[1][0] + n_obs * a.warm_st[1][1]];
    cw = a.warm[2][t * a.warm_st[2][0] + n_obs * a.warm_st[2][1]];
  }
  P F, sF, cF;
  bool conv = solve_kepler(o, e2, lam1, warm, fw, sw, cw, p, F, sF, cF);
  a.kepler[3 * i] = F;
  a.kepler[3 * i + 1] = sF;
  a.kepler[3 * i + 2] = cF;
  const State<P> st = cartesian(o, n, e2, F, sF, cF);

  // ecliptic -> equatorial, the aberration chain, RA / Dec
  P rot[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) rot[k] = P(p.rot[k]);
  P pos[3], vel[3], rel[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    pos[r] = sum3(rot[3 * r] * st.pos[0], rot[3 * r + 1] * st.pos[1], rot[3 * r + 2] * st.pos[2]);
    vel[r] = sum3(rot[3 * r] * st.vel[0], rot[3 * r + 1] * st.vel[1], rot[3 * r + 2] * st.vel[2]);
    rel[r] = pos[r] - a.helio[3 * i + r];
  }
  const P rel_norm = vsqrt(sum3(rel[0] * rel[0], rel[1] * rel[1], rel[2] * rel[2]));
  const P lt = div_scalar(rel_norm, p.vlight);
  const P x = rel[0] - lt * vel[0];
  const P y = rel[1] - lt * vel[1];
  const P z = rel[2] - lt * vel[2];
  const P rho_xy2 = x * x + y * y;
  const P rho_xy = vsqrt(rho_xy2);
  const P rho2 = rho_xy2 + z * z;
  const P ra = remainder(vatan2(y, x), P(p.dpi));
  const P dec = vatan2(z, rho_xy);
  const P grad_ra[3] = {(-y) / rho_xy2, x / rho_xy2, P(0)};
  const P grad_dec[3] = {((-z) * x) / (rho_xy * rho2), ((-z) * y) / (rho_xy * rho2), rho_xy / rho2};
  const P ab = rcp(rel_norm * P(p.vlight));
  const P sra = sum3(grad_ra[0] * vel[0], grad_ra[1] * vel[1], grad_ra[2] * vel[2]) * ab;
  const P sdec = sum3(grad_dec[0] * vel[0], grad_dec[1] * vel[1], grad_dec[2] * vel[2]) * ab;
  P dra_dpos[3], ddec_dpos[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    dra_dpos[r] = grad_ra[r] - sra * rel[r];
    ddec_dpos[r] = grad_dec[r] - sdec * rel[r];
  }

  // the partials: in the working type, or (mixed) a float32 pass over the
  // same elements from the float64 Kepler solution
  P d_ra[6], d_dec[6];
  if constexpr (sizeof(J) == sizeof(P)) {
    const Partials<P> d = partials(o, st, lam1, F, sF, cF, dt);
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      P c[3], q[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) c[j] = partial(e, j, o, st, d, n);
#pragma unroll
      for (int r = 0; r < 3; ++r) q[r] = sum3(rot[3 * r] * c[0], rot[3 * r + 1] * c[1], rot[3 * r + 2] * c[2]);
      d_ra[e] = sum3(q[0] * dra_dpos[0], q[1] * dra_dpos[1], q[2] * dra_dpos[2]);
      d_dec[e] = sum3(q[0] * ddec_dpos[0], q[1] * ddec_dpos[1], q[2] * ddec_dpos[2]);
    }
  } else {
    const Elements<J> oj{J(o.a), J(o.h), J(o.k), J(o.p), J(o.q), J(o.lam)};
    const J dtj = J(dt_d);
    J nj, e2j, lam1j;
    mean_longitude(oj, dtj, p, nj, e2j, lam1j);
    const J Fj = J(F), sFj = J(sF), cFj = J(cF);
    conv = conv && is_finite(Fj) && is_finite(sFj) && is_finite(cFj);
    const State<J> sj = cartesian(oj, nj, e2j, Fj, sFj, cFj);
    const Partials<J> d = partials(oj, sj, lam1j, Fj, sFj, cFj, dtj);
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      P c[3], q[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) c[j] = P(partial(e, j, oj, sj, d, nj));
#pragma unroll
      for (int r = 0; r < 3; ++r) q[r] = sum3(rot[3 * r] * c[0], rot[3 * r + 1] * c[1], rot[3 * r + 2] * c[2]);
      d_ra[e] = sum3(q[0] * dra_dpos[0], q[1] * dra_dpos[1], q[2] * dra_dpos[2]);
      d_dec[e] = sum3(q[0] * ddec_dpos[0], q[1] * ddec_dpos[1], q[2] * ddec_dpos[2]);
    }
  }

  // single_iteration: residuals against the debiased observations, masks,
  // weights, and this observation's terms of the sums
  const bool prop_ok = conv && is_finite(ra) && is_finite(dec);
  const bool usable = a.valid[i] && prop_ok;
  const bool active = usable && a.selection[i] == 0;
  const P obs_ra = a.bias_ra ? a.ra[i] - a.bias_ra[i] : a.ra[i];
  const P obs_dec = a.bias_dec ? a.dec[i] - a.bias_dec[i] : a.dec[i];
  P dra = remainder(obs_ra - ra, P(p.dpi));
  dra = dra > P(p.pi) ? dra - P(p.dpi) : dra;
  const P res_ra = usable ? dra : P(0);
  const P res_dec = usable ? obs_dec - dec : P(0);
  const P sig_ra = a.sigma_ra[i], sig_dec = a.sigma_dec[i];
  const P w_ra = active ? rcp(sig_ra * sig_ra) : P(0);
  const P w_dec = active ? rcp(sig_dec * sig_dec) : P(0);
  a.res_ra[i] = res_ra;
  a.res_dec[i] = res_dec;
  a.active[i] = active;
  P gw_ra[6], gw_dec[6];
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    d_ra[e] = usable ? d_ra[e] : P(0);
    d_dec[e] = usable ? d_dec[e] : P(0);
    a.d_ra[6 * i + e] = d_ra[e];
    a.d_dec[6 * i + e] = d_dec[e];
    gw_ra[e] = d_ra[e] * w_ra;
    gw_dec[e] = d_dec[e] * w_dec;
  }
#pragma unroll
  for (int r = 0; r < 6; ++r) {
#pragma unroll
    for (int c = 0; c <= r; ++c) acc.v[tri(r, c)] = acc.v[tri(r, c)] + (gw_ra[r] * d_ra[c] + gw_dec[r] * d_dec[c]);
    acc.v[21 + r] = acc.v[21 + r] + (gw_ra[r] * res_ra + gw_dec[r] * res_dec);
  }
  acc.v[27] = acc.v[27] + (w_ra * (res_ra * res_ra) + w_dec * (res_dec * res_dec));
  acc.n_active += active;
}

// The trajectory's solve (single_iteration after the sums): the free-element
// mask with its unit diagonal, the finiteness check, cholesky_inverse6 in
// its order, the correction, its norm and the RMS.
template <typename P>
__device__ __forceinline__ void solve(const StepArgs<P>& a, long long t, const Elements<P>& o, const Sums<P>& s) {
  bool fr[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) fr[i] = a.free[i];
  const int m = 2 * s.n_active;
  P nm[6][6];
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const P v = i >= j ? s.v[tri(i, j)] : s.v[tri(j, i)];
      nm[i][j] = ((fr[i] && fr[j]) ? v : P(0)) + (i == j ? (fr[i] ? P(0) : P(1)) : P(0));
      finite = finite && is_finite(nm[i][j]);
      a.normal[36 * t + 6 * i + j] = nm[i][j];
    }
  P rhs[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) rhs[i] = fr[i] ? s.v[21 + i] : P(0);

  // utils/linalg.py:cholesky6 on the matrix, or on the identity where it is
  // not finite
  P L[6][6];
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      P v = finite ? nm[i][j] : P(i == j ? 1 : 0);
#pragma unroll
      for (int k = 0; k < j; ++k) v = v - L[i][k] * L[j][k];
      if (i == j) {
        ok = ok && v > P(0) && is_finite(v);
        L[i][i] = vsqrt(v > P(0) ? v : P(1));
      } else {
        L[i][j] = v / L[j][j];
      }
    }
  // cholesky_inverse6: L^-1 by forward substitution, then L^-T L^-1
  P li[6][6];
#pragma unroll
  for (int j = 0; j < 6; ++j)
#pragma unroll
    for (int i = j; i < 6; ++i) {
      if (i == j) {
        li[i][j] = rcp(L[i][i]);
      } else {
        P v = L[i][j] * li[j][j] + P(0);
#pragma unroll
        for (int k = j + 1; k < i; ++k) v = v + L[i][k] * li[k][j];
        li[i][j] = (-v) / L[i][i];
      }
    }
  P cov[6][6];
  bool cov_finite = true;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      P v = P(0);
#pragma unroll
      for (int k = i; k < 6; ++k) v = v + li[k][i] * li[k][j];
      cov[i][j] = v;
      cov[j][i] = v;
      cov_finite = cov_finite && is_finite(v);
    }
  const bool inv_ok = finite && ok && cov_finite && m >= 1;

  P dx[6], ndx[6], term[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) term[j] = cov[i][j] * rhs[j];
    const P v = sum6(term);
    dx[i] = (fr[i] && inv_ok) ? v : P(0);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) term[j] = nm[i][j] * dx[j];
    ndx[i] = sum6(term);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) term[i] = dx[i] * ndx[i];
  a.corr_norm[t] = vsqrt(clamp_min(sum6(term), P(0)));
  const P rms = vsqrt(s.v[27] / P(m > 1 ? m : 1));
  a.rms[t] = m > 0 ? rms : P(0);
  const P el[6] = {o.a, o.h, o.k, o.p, o.q, o.lam};
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    a.corrected[6 * t + i] = el[i] + dx[i];
#pragma unroll
    for (int j = 0; j < 6; ++j) a.cov[36 * t + 6 * i + j] = cov[i][j];
  }
  a.inv_ok[t] = inv_ok;
  a.m[t] = m;
}

template <typename P, typename J>
__global__ void __launch_bounds__(kBlock) lsq_step_kernel(StepArgs<P> a) {
  const long long t = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (t >= a.T) return;  // the whole warp: t is the same on its lanes
  const int lane = threadIdx.x & 31;
  const P* el = a.elements + 6 * t;
  const Elements<P> o{el[0], el[1], el[2], el[3], el[4], el[5]};
  const double epoch = a.epoch[t];
  Sums<P> acc;
#pragma unroll
  for (int k = 0; k < 28; ++k) acc.v[k] = P(0);
  acc.n_active = 0;
  for (long long n = lane; n < a.N; n += 32) observation<P, J>(a, o, epoch, t, t * a.N + n, acc);
  // a fixed butterfly: every lane ends with the same sums, in the same order
  // in every batch
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 28; ++k) acc.v[k] = acc.v[k] + __shfl_xor_sync(kFull, acc.v[k], off);
    acc.n_active += __shfl_xor_sync(kFull, acc.n_active, off);
  }
  if (lane == 0) solve(a, t, o, acc);
}

}  // namespace outfit_lsq
