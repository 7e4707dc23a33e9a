// Three other designs of the Chebyshev kernel K1, timed by
// tools/torch_k1/bench.py beside the kernel of
// outfit_tpu_torch/csrc/chebyshev.cuh (block tiles of 128 queries, each
// distinct row of a tile copied into shared memory once with cp.async.ca):
//
//   1 first     the first design of that kernel: one thread per query, the
//               coefficient count a runtime loop bound, each lane reading its
//               own row through the read-only cache and storing its CH
//               outputs at a stride of CH doubles
//   2 warp_ldg  no row staging: each warp a tile of 32 queries, the
//               coefficient count a template parameter, each lane reading its
//               own row through the read-only cache (16-byte pairs where C is
//               even), the warp's outputs staged in its own shared memory and
//               written as contiguous 16-byte stores, no block barrier
//   3 tma       the port's kernel with each distinct row copied by one TMA
//               bulk copy (cp.async.bulk, completion counted in bytes on an
//               mbarrier) issued by the run's head thread; a row that is not
//               a multiple of 16 bytes (the Moon's 3 x 13) as its 16-byte
//               aligned part plus one element stored alone
//
// All three compute bitwise the values of the port's kernel.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -fmad=false -shared -Xcompiler -fPIC -o libk1ab.so variants.cu

#include <cstdint>

#include <cuda_runtime.h>

#include "../../outfit_tpu_torch/csrc/chebyshev.cuh"

namespace {

template <int CH, bool DERIV>
__global__ void first_kernel(const double* __restrict__ coeffs, int n_gran, int n_coeff,
                             const double* __restrict__ mjd, long long n, double t0, double gran,
                             double vscale, double* __restrict__ out, double* __restrict__ dout) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const double x = (__ldg(mjd + i) - t0) / gran;
  const double fl = fmin(fmax(floor(x), 0.0), (double)(n_gran - 1));
  const long long idx = (long long)fl;
  const double tau = 2.0 * (x - fl) - 1.0;
  const double* row = coeffs + idx * (long long)(CH * n_coeff);
  double acc[CH];
  double dacc[DERIV ? CH : 1];
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

constexpr int kWarpThreads = 128;

// a warp's nt x CH outputs, staged at P = CH | 1 doubles per query, as
// contiguous 16-byte stores from out + w0 * CH
template <int CH>
__device__ __forceinline__ void store_warp(const double* stage, double* __restrict__ out,
                                           long long w0, int nt, int lane) {
  constexpr int P = CH | 1;
  const int span = nt * CH;
  double* base = out + w0 * CH;
  double2* base2 = reinterpret_cast<double2*>(base);
  for (int j = lane; j < span / 2; j += 32) {
    const int q = 2 * j;
    base2[j] = make_double2(stage[(q / CH) * P + q % CH],
                            stage[((q + 1) / CH) * P + (q + 1) % CH]);
  }
  if ((span & 1) && lane == 0) {
    const int q = span - 1;
    base[q] = stage[(q / CH) * P + q % CH];
  }
}

template <int CH, bool DERIV, int C>
__global__ void __launch_bounds__(kWarpThreads, 8)
warp_ldg_kernel(const double* __restrict__ coeffs, int n_gran, const double* __restrict__ mjd,
                long long n, double t0, double gran, double vscale, double* __restrict__ out,
                double* __restrict__ dout) {
  constexpr int P = CH | 1;
  __shared__ __align__(16) double stage[kWarpThreads / 32][(DERIV ? 2 : 1) * 32 * P];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long w0 = (long long)blockIdx.x * kWarpThreads + warp * 32;
  if (w0 >= n) return;
  const long long i = w0 + lane;
  double* st = stage[warp];
  if (i < n) {
    const double x = (__ldg(mjd + i) - t0) / gran;
    const double fl = fmin(fmax(floor(x), 0.0), (double)(n_gran - 1));
    const long long idx = (long long)fl;
    const double tau = 2.0 * (x - fl) - 1.0;
    const double* row = coeffs + idx * (long long)(CH * C);
    [[maybe_unused]] double2 pair[CH];
    auto coef = [&](int c, int k) -> double {
      if constexpr (C % 2 == 0) {
        if (k % 2 == 0) pair[c] = __ldg(reinterpret_cast<const double2*>(row + c * C + k));
        return k % 2 == 0 ? pair[c].x : pair[c].y;
      } else {
        return __ldg(row + c * C + k);
      }
    };
    double acc[CH];
    double dacc[DERIV ? CH : 1];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const double c0 = coef(c, 0);
      acc[c] = c0 * 1.0;
      if (DERIV) dacc[c] = c0 * 0.0;
    }
    double t_prev = 1.0, t_cur = tau;
    double d_prev = 0.0, d_cur = 1.0;
#pragma unroll
    for (int k = 1; k < C; ++k) {
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
        const double ck = coef(c, k);
        acc[c] += ck * t_cur;
        if (DERIV) dacc[c] += ck * d_cur;
      }
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      st[lane * P + c] = acc[c];
      if (DERIV) st[32 * P + lane * P + c] = dacc[c] * vscale;
    }
  }
  __syncwarp();
  const int nt = (int)(n - w0 < 32 ? n - w0 : 32);
  store_warp<CH>(st, out, w0, nt, lane);
  if (DERIV) store_warp<CH>(st + 32 * P, dout, w0, nt, lane);
}


// Variant 3, tma: shared-memory slots of a (CH, C) table's rows for bulk
// copies: an odd-width row sits 8 bytes in where its global address is 8
// past a 16-byte boundary, so its aligned part is aligned in shared memory
template <int CH, int C>
struct BulkSlots {
  static constexpr int kWidth = CH * C;
  static constexpr bool kWhole = kWidth % 2 == 0;
  static constexpr int kBytes = 8 * kWidth + (kWhole ? 0 : 8);
  static constexpr unsigned kCopy = 8 * (kWidth - (kWhole ? 0 : 1));  // bytes a bulk copy moves
  static constexpr int kFit = outfit::kRowBytes / kBytes;
  static constexpr int kSlots = kFit < outfit::kTile ? kFit : outfit::kTile;
};

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int CH, bool DERIV, int C>
__global__ void __launch_bounds__(outfit::kTile, outfit::kMinBlocks)
tma_kernel(const double* __restrict__ coeffs, int n_gran, const double* __restrict__ mjd,
           long long n, double t0, double gran, double vscale, double* __restrict__ out,
           double* __restrict__ dout) {
  using S = BulkSlots<CH, C>;
  constexpr int T = outfit::kTile;
  constexpr int P = CH | 1;
  __shared__ __align__(16) unsigned char rows[S::kSlots * S::kBytes];
  __shared__ __align__(16) double stage[(DERIV ? 2 : 1) * T * P];
  __shared__ int warp_heads[T / 32];
  __shared__ std::uint64_t bar;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const long long tile0 = (long long)blockIdx.x * T, i = tile0 + t;
  const bool valid = i < n;
  const int nt = (int)(n - tile0 < T ? n - tile0 : T);
  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem(&bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  int idx = -1;
  double tau = 0.0;
  if (valid) idx = outfit::granule(__ldg(mjd + i), t0, gran, n_gran, &tau);
  int prev = __shfl_up_sync(0xffffffffu, idx, 1);
  if (lane == 0 && t > 0 && valid) {
    double unused;
    prev = outfit::granule(__ldg(mjd + i - 1), t0, gran, n_gran, &unused);
  }
  const bool head = valid && (t == 0 || idx != prev);
  const unsigned heads = __ballot_sync(0xffffffffu, head);
  if (lane == 0) warp_heads[warp] = __popc(heads);
  __syncthreads();
  int slot = __popc(heads & (0xffffffffu >> (31 - lane))) - 1, total = 0;
  for (int w = 0; w < T / 32; ++w) {
    slot += w < warp ? warp_heads[w] : 0;
    total += warp_heads[w];
  }
  const double* grow = coeffs + (long long)(idx < 0 ? 0 : idx) * S::kWidth;
  const int lead = S::kWhole ? 0 : (int)(reinterpret_cast<std::uintptr_t>(grow) & 8);
  unsigned parity = 0;
  for (int base = 0; base < total; base += S::kSlots, parity ^= 1) {
    if (base > 0) __syncthreads();
    const int n_rows = total - base < S::kSlots ? total - base : S::kSlots;
    if (t == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem(&bar)),
                   "r"(n_rows * S::kCopy)
                   : "memory");
    }
    const bool mine = valid && slot >= base && slot < base + S::kSlots;
    unsigned char* srow = rows + (slot - base) * S::kBytes;
    if (head && mine) {
      // the whole row; or the first element alone and the rest; or the
      // aligned part and the last element alone
      const double* src = grow + (lead ? 1 : 0);
      unsigned char* dst = srow + (lead ? 16 : 0);
      if (!S::kWhole) {
        const int e = lead ? 0 : S::kWidth - 1;
        *reinterpret_cast<double*>(srow + lead + 8 * e) = __ldg(grow + e);
      }
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
          ::"r"(smem(dst)), "l"(src), "r"(S::kCopy), "r"(smem(&bar))
          : "memory");
    }
    unsigned done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done)
          : "r"(smem(&bar)), "r"(parity)
          : "memory");
    }
    if (!S::kWhole) __syncthreads();  // the elements stored alone
    if (mine) {
      outfit::evaluate_row<CH, DERIV, C>(reinterpret_cast<const double*>(srow + lead), tau,
                                         vscale, stage + t * P, stage + T * P + t * P);
    }
  }
  __syncthreads();
  outfit::store_tile<CH>(stage, out, tile0, nt);
  if (DERIV) outfit::store_tile<CH>(stage + T * P, dout, tile0, nt);
}

template <int CH, bool DERIV>
int launch(int variant, const double* coeffs, int n_gran, int n_coeff, const double* mjd,
           long long n, double t0, double gran, double* out, double* dout, cudaStream_t s) {
  const double vscale = 2.0 / gran;
  if (variant == 1) {
    const dim3 grid((unsigned)((n + 255) / 256));
    first_kernel<CH, DERIV><<<grid, 256, 0, s>>>(coeffs, n_gran, n_coeff, mjd, n, t0, gran,
                                                 vscale, out, dout);
  } else if (variant == 2 && (n_coeff == 13 || n_coeff == 14)) {
    const dim3 grid((unsigned)((n + kWarpThreads - 1) / kWarpThreads));
    if (n_coeff == 14) {
      warp_ldg_kernel<CH, DERIV, 14><<<grid, kWarpThreads, 0, s>>>(coeffs, n_gran, mjd, n, t0,
                                                                   gran, vscale, out, dout);
    } else {
      warp_ldg_kernel<CH, DERIV, 13><<<grid, kWarpThreads, 0, s>>>(coeffs, n_gran, mjd, n, t0,
                                                                   gran, vscale, out, dout);
    }
  } else if (variant == 3 && (n_coeff == 13 || n_coeff == 14)) {
    const dim3 grid((unsigned)((n + outfit::kTile - 1) / outfit::kTile));
    if (n_coeff == 14) {
      tma_kernel<CH, DERIV, 14><<<grid, outfit::kTile, 0, s>>>(coeffs, n_gran, mjd, n, t0, gran,
                                                               vscale, out, dout);
    } else {
      tma_kernel<CH, DERIV, 13><<<grid, outfit::kTile, 0, s>>>(coeffs, n_gran, mjd, n, t0, gran,
                                                               vscale, out, dout);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One launch of variant 1, 2 or 3 (see above) on `stream`; arguments as
// outfit_chebyshev_f64 in outfit_tpu_torch/csrc/chebyshev.cu.  Returns
// cudaGetLastError() (0 = launched).
extern "C" int k1_variant(int variant, const double* coeffs, int n_gran, int n_chan,
                          int n_coeff, const double* mjd, long long n, double t0, double gran,
                          double* out, double* dout, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chan == 3 && dout != nullptr) {
    return launch<3, true>(variant, coeffs, n_gran, n_coeff, mjd, n, t0, gran, out, dout, s);
  }
  if (n_chan == 10 && dout == nullptr) {
    return launch<10, false>(variant, coeffs, n_gran, n_coeff, mjd, n, t0, gran, out, nullptr,
                             s);
  }
  return (int)cudaErrorInvalidValue;
}
