// C launcher for the Chebyshev interpolation kernel (chebyshev.cuh), loaded
// from Python with ctypes (outfit_tpu_torch/ephem/chebyshev_cuda.py).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -fmad=false -shared -Xcompiler -fPIC -o libchebyshev.so chebyshev.cu

#include "chebyshev.cuh"

namespace {
constexpr int kThreads = 256;
}

// Two instantiations: 3 channels with the derivative (body positions and
// velocities) and 10 channels without (the observer frame table).
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 = launched).
extern "C" int outfit_chebyshev_f64(const double* coeffs, int n_gran,
                                    int n_chan, int n_coeff,
                                    const double* mjd, long long n, double t0,
                                    double gran, double* out, double* dout,
                                    void* stream) {
  if (n <= 0) return 0;
  if (n_gran <= 0 || n_coeff < 2 || n_coeff > 32) return (int)cudaErrorInvalidValue;
  const dim3 block(kThreads);
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double vscale = 2.0 / gran;
  if (n_chan == 3 && dout != nullptr) {
    outfit::chebyshev_eval_kernel<3, true><<<grid, block, 0, s>>>(
        coeffs, n_gran, n_coeff, mjd, n, t0, gran, vscale, out, dout);
  } else if (n_chan == 10 && dout == nullptr) {
    outfit::chebyshev_eval_kernel<10, false><<<grid, block, 0, s>>>(
        coeffs, n_gran, n_coeff, mjd, n, t0, gran, vscale, out, nullptr);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
