// Chebyshev ephemeris interpolation on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel outfit_tpu/ephem/pallas_kernel.py
// (_kernel, launched by _run through pl.pallas_call): per query, the granule
// index, the normalised time, one coefficient-row read and the T_k (and
// dT_k/dtau) recurrences contracted to the channel values.
//
// What bounds it: one row read per query, CH * C * 8 bytes (336 B for a
// 3-channel body row at C = 14, 1120 B for the 10-channel frame row), against
// ~4 * C * CH flops.  The tables are small (0.2 to 5 MB) and the queries of
// one trajectory hit the same granules, so most row reads hit L2, and the
// neighbouring threads of a warp usually read the same row (broadcast).  The
// TPU design (scalar-prefetched indices, one DMA per row into VMEM) is not
// carried over: on this card a thread reads its row through the read-only
// data cache itself, keeps the recurrence and the CH accumulators in
// registers, and writes its CH outputs once.
//
// Arithmetic follows outfit_tpu/ephem/chebyshev.py:63-65 exactly
// (x = (mjd - t0) / gran, idx = clip(floor(x), 0, G - 1),
// tau = 2 (x - idx) - 1), and the sum runs k = 0 .. C-1 in order.

#pragma once

#include <cuda_runtime.h>

namespace outfit {

// CH channels per row; DERIV adds the dT_k/dtau contraction (velocity),
// scaled by vscale = 2 / gran.  coeffs is (G, CH, C) row-major.
template <int CH, bool DERIV>
__global__ void chebyshev_eval_kernel(const double* __restrict__ coeffs,
                                      int n_gran, int n_coeff,
                                      const double* __restrict__ mjd,
                                      long long n, double t0, double gran,
                                      double vscale,
                                      double* __restrict__ out,
                                      double* __restrict__ dout) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;

  const double x = (__ldg(mjd + i) - t0) / gran;
  // clamp after flooring; clamping in double is the same for every finite
  // x and keeps the cast in range
  const double fl = fmin(fmax(floor(x), 0.0), (double)(n_gran - 1));
  const long long idx = (long long)fl;
  const double tau = 2.0 * (x - fl) - 1.0;

  const double* row = coeffs + idx * (long long)(CH * n_coeff);

  double acc[CH];
  double dacc[DERIV ? CH : 1];
  // k = 0: T_0 = 1, dT_0 = 0
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    acc[c] = __ldg(row + c * n_coeff) * 1.0;
    if (DERIV) dacc[c] = __ldg(row + c * n_coeff) * 0.0;
  }
  double t_prev = 1.0, t_cur = tau;
  double d_prev = 0.0, d_cur = 1.0;
  for (int k = 1; k < n_coeff; ++k) {
    if (k >= 2) {
      const double t_next = 2.0 * tau * t_cur - t_prev;
      const double d_next = 2.0 * t_cur + 2.0 * tau * d_cur - d_prev;
      t_prev = t_cur;
      t_cur = t_next;
      d_prev = d_cur;
      d_cur = d_next;
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const double ck = __ldg(row + c * n_coeff + k);
      acc[c] += ck * t_cur;
      if (DERIV) dacc[c] += ck * d_cur;
    }
  }

#pragma unroll
  for (int c = 0; c < CH; ++c) {
    out[i * CH + c] = acc[c];
    if (DERIV) dout[i * CH + c] = dacc[c] * vscale;
  }
}

}  // namespace outfit
