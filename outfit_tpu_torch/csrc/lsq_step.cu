// C launcher for the two-body Newton step of the differential correction
// (lsq_step.cuh), loaded from Python with ctypes
// (outfit_tpu_torch/lsq/step_cuda.py).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -fmad=false -shared -Xcompiler -fPIC -o liblsq_step.so lsq_step.cu

#include "lsq_step.cuh"

// One call's pointers, strides and scalars; the ctypes Structure _Call
// mirrors it field for field.  P is the working type (the elements', the
// observations' and the outputs'): per trajectory elements (T, 6) in P and
// epoch (T,) float64; per observation selection (T, N) int32, mjd (T, N)
// float64, ra, dec, sigma_ra, sigma_dec (T, N) in P, helio (T, N, 3) in P,
// valid (T, N) bool, bias_ra and bias_dec (T, N) in P or null; the warm
// start (F, sin F, cos F), each (T, N) in P at the strides warm_st[k] =
// {trajectory, observation}, or null; free (6,) bool.  The outputs follow
// IterationResult's order, in P except inv_ok, active (bool) and m (int32).
struct StepCall {
  const void* elements;
  const double* epoch;
  const int* selection;
  const double* mjd;
  const void* ra;
  const void* dec;
  const void* sigma_ra;
  const void* sigma_dec;
  const void* helio;
  const bool* valid;
  const void* bias_ra;
  const void* bias_dec;
  const void* warm_f;
  const void* warm_s;
  const void* warm_c;
  const bool* free;
  void* corrected;
  void* corr_norm;
  void* rms;
  void* normal;
  void* cov;
  bool* inv_ok;
  int* m;
  void* res_ra;
  void* res_dec;
  void* d_ra;
  void* d_dec;
  bool* active;
  void* kepler;
  long long warm_st[3][2];
  long long T;
  long long N;
  outfit_lsq::StepParams params;
};

namespace {

template <typename P, typename J>
int launch(const StepCall& c, cudaStream_t s) {
  outfit_lsq::StepArgs<P> a{
      static_cast<const P*>(c.elements), c.epoch, c.selection, c.mjd,
      static_cast<const P*>(c.ra), static_cast<const P*>(c.dec),
      static_cast<const P*>(c.sigma_ra), static_cast<const P*>(c.sigma_dec),
      static_cast<const P*>(c.helio), c.valid,
      static_cast<const P*>(c.bias_ra), static_cast<const P*>(c.bias_dec),
      {static_cast<const P*>(c.warm_f), static_cast<const P*>(c.warm_s), static_cast<const P*>(c.warm_c)},
      {{c.warm_st[0][0], c.warm_st[0][1]}, {c.warm_st[1][0], c.warm_st[1][1]}, {c.warm_st[2][0], c.warm_st[2][1]}},
      c.free,
      static_cast<P*>(c.corrected), static_cast<P*>(c.corr_norm), static_cast<P*>(c.rms),
      static_cast<P*>(c.normal), static_cast<P*>(c.cov), c.inv_ok, c.m,
      static_cast<P*>(c.res_ra), static_cast<P*>(c.res_dec), static_cast<P*>(c.d_ra), static_cast<P*>(c.d_dec),
      c.active, static_cast<P*>(c.kepler),
      c.T, c.N, c.params,
  };
  const dim3 grid(static_cast<unsigned>((c.T + outfit_lsq::kWarps - 1) / outfit_lsq::kWarps));
  outfit_lsq::lsq_step_kernel<P, J><<<grid, outfit_lsq::kBlock, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kind 0: float32 throughout (the mixed-precision pre-warm); 1: float64
// propagation with float32 Jacobians (the mixed main loop); 2: float64
// throughout.  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a call it
// does not take.
extern "C" int outfit_lsq_step(const StepCall* call, int kind, void* stream) {
  if (call->T <= 0) return 0;
  const bool warm = call->warm_f != nullptr;
  if (call->N < 0 || call->T / outfit_lsq::kWarps >= 0x7fffffffLL ||
      warm != (call->warm_s != nullptr) || warm != (call->warm_c != nullptr) ||
      (call->bias_ra != nullptr) != (call->bias_dec != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return launch<float, float>(*call, s);
    case 1:
      return launch<double, float>(*call, s);
    case 2:
      return launch<double, double>(*call, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
