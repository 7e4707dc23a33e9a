// C launcher for the Chebyshev interpolation kernel (chebyshev.cuh), loaded
// from Python with ctypes (outfit_tpu_torch/ephem/chebyshev_cuda.py).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -fmad=false -shared -Xcompiler -fPIC -o libchebyshev.so chebyshev.cu

#include <cstdint>

#include "chebyshev.cuh"

namespace {

constexpr int kMinCoeff = 2;
constexpr int kMaxCoeff = 32;

// The instantiation for n_coeff, found by walking C = kMinCoeff .. kMaxCoeff.
template <int CH, bool DERIV, int C>
int launch(int n_coeff, const double* coeffs, int n_gran, const double* mjd, long long n,
           double t0, double gran, double* out, double* dout, cudaStream_t s) {
  if (n_coeff == C) {
    const dim3 grid((unsigned)((n + outfit::kTile - 1) / outfit::kTile));
    outfit::chebyshev_eval_kernel<CH, DERIV, C><<<grid, outfit::kTile, 0, s>>>(
        coeffs, n_gran, mjd, n, t0, gran, 2.0 / gran, out, dout);
    return (int)cudaGetLastError();
  }
  if constexpr (C < kMaxCoeff) {
    return launch<CH, DERIV, C + 1>(n_coeff, coeffs, n_gran, mjd, n, t0, gran, out, dout, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0; }

}  // namespace

// Two channel counts: 3 with the derivative (body positions and
// velocities) and 10 without (the observer frame table), each for
// n_coeff = 2 .. 32.  out and dout must be 16-byte aligned, and coeffs too
// where a row (n_chan * n_coeff doubles) is a multiple of 16 bytes, since
// the kernel copies such rows in 16-byte pieces.  Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue for anything it does not take.
extern "C" int outfit_chebyshev_f64(const double* coeffs, int n_gran,
                                    int n_chan, int n_coeff,
                                    const double* mjd, long long n, double t0,
                                    double gran, double* out, double* dout,
                                    void* stream) {
  if (n <= 0) return 0;
  if (n_gran <= 0 || n_coeff < kMinCoeff || n_coeff > kMaxCoeff || !aligned16(out) ||
      (dout != nullptr && !aligned16(dout)) || ((n_chan * n_coeff) % 2 == 0 && !aligned16(coeffs))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chan == 3 && dout != nullptr) {
    return launch<3, true, kMinCoeff>(n_coeff, coeffs, n_gran, mjd, n, t0, gran, out, dout, s);
  }
  if (n_chan == 10 && dout == nullptr) {
    return launch<10, false, kMinCoeff>(n_coeff, coeffs, n_gran, mjd, n, t0, gran, out, nullptr,
                                        s);
  }
  return (int)cudaErrorInvalidValue;
}
