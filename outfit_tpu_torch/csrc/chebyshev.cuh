// Chebyshev ephemeris interpolation on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel outfit_tpu/ephem/pallas_kernel.py
// (_kernel, launched by _run through pl.pallas_call): per query, the granule
// index, the normalised time, one coefficient-row read and the T_k (and
// dT_k/dtau) recurrences contracted to the channel values.
//
// What bounds it: bytes.  A query reads its 8-byte epoch and writes CH
// values, and CH derivatives at the body site: 56 bytes a query for a body
// (3 channels with the derivative), 88 for the observer frame table (10
// channels), against ~270 and ~320 float64 operations, about 5 and 4 a
// byte, under the card's ridge of ~10 (34 TFLOP/s over 3.35 TB/s).  The
// table is read once (0.2 to 1.2 MB) and stays in L2.  At the observer
// cache's 524,288 queries the bound is 8.8 us for a body and 14.1 us for
// the frame table.  Close behind it: -fmad=false (below) issues each
// multiply and add alone, ~250 and ~300 float64 instructions a query, 7-9 us
// of the card's float64 pipes at that size.
//
// The design's answer, per block of kTile contiguous queries (a tile):
// * stores: the first design's thread per query wrote its CH values at a
//   stride of CH doubles, 3-4x the 32-byte sectors of the same bytes written
//   contiguously.  Here each thread stages its outputs in shared memory (at
//   an odd stride of doubles, so the lanes' writes fall in distinct banks)
//   and the block writes the tile's kTile x CH values (and derivatives) as
//   one contiguous span of 16-byte stores;
// * row reads: the path's queries are time-sorted, so a tile touches few
//   distinct granules.  The block marks its runs of equal granule index
//   (run heads by ballot; each warp lists its heads' indices, and a prefix
//   sum over the warps' counts ranks them) and gives each run a slot; the
//   block copies each slot's row into shared memory once with cp.async, in
//   16-byte pieces (8-byte for a row that is not a multiple of 16 bytes, as
//   the Moon's 3 x 13), and every thread of the run reads its coefficients
//   from there (as 16-byte pairs where C is even).  The copies allocate in
//   L1 (cp.async.ca): every tile of a dataset reads the same few hot rows
//   (the padding queries all repeat one epoch), and a copy that bypasses L1
//   -- a TMA bulk copy (cp.async.bulk) or cp.async.cg -- fetches them from
//   the same L2 lines again for every tile: one bulk copy per row measured
//   slower at 11 of 12 shapes on an H100, up to 7.1x, and 7 % faster at
//   one (the real-cadence frame table in path order;
//   tools/torch_k1/bench.py);
// * any query order: slots beyond one round of kRowBytes of shared memory
//   are copied and evaluated in further rounds of the same code, down to
//   every query in a granule of its own;
// * the coefficient count C is a template parameter, so the k loop
//   unrolls; at 80 registers a thread (6 blocks a SM) the unrolled loop
//   spills at most 4 bytes (at 64 it spilled more).
//
// Measured on an H100 at 524,288 time-sorted queries: 0.49 of the bound at
// the body site and 0.41 at the frame site.  What holds it there: each
// lane reading its own row through L1, without staging, is 1.1-1.4x
// faster, since L1 already keeps a tile's few hot rows and broadcasts
// them; the copy's round trip and the tile's barriers cost more than they
// save (tools/torch_k1/bench.py, PERF.md).
//
// Arithmetic follows outfit_tpu/ephem/chebyshev.py:63-65 exactly
// (x = (mjd - t0) / gran, idx = clip(floor(x), 0, G - 1),
// tau = 2 (x - idx) - 1), and the sum runs k = 0 .. C-1 in order, seeded
// with row[c*C] * 1.0 (and * 0.0 for the derivative); built with
// -fmad=false, every value is bitwise the one the first design of this
// kernel (runtime C, strided stores) computed.

#pragma once

#include <cuda_runtime.h>

namespace outfit {

// queries of a tile, one thread each
constexpr int kTile = 128;
constexpr int kWarps = kTile / 32;
// blocks resident on an SM: caps the registers at 65,536 / (6 * 128) = 85
constexpr int kMinBlocks = 6;
// shared memory for the rows of one round: 73 EMB rows, 21 frame rows at
// C = 14 (the six blocks of an SM take up to 213 KB of its 228 KB)
constexpr int kRowBytes = 24 * 1024;

// Shared-memory slots of a (CH, C) table's rows
template <int CH, int C>
struct RowSlots {
  static constexpr int kWidth = CH * C;                      // doubles in a row
  static constexpr int kPiece = kWidth % 2 == 0 ? 2 : 1;     // doubles a copy moves
  static constexpr int kPieces = kWidth / kPiece;            // copies a row takes
  static constexpr int kFit = kRowBytes / (8 * kWidth);
  static constexpr int kSlots = kFit < kTile ? kFit : kTile;  // slots of a round
  static_assert(kSlots >= 1, "a row must fit in one round");
};

// one cp.async of 8 or 16 bytes, allocating in L1 (.ca)
template <int DOUBLES>
__device__ __forceinline__ void copy_async(double* dst, const double* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(d), "l"(src), "n"(8 * DOUBLES)
               : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The granule index of epoch m and, through tau, its normalised time.
__device__ __forceinline__ int granule(double m, double t0, double gran, int n_gran,
                                       double* tau) {
  const double x = (m - t0) / gran;
  // clamp after flooring; clamping in double is the same for every finite
  // x and keeps the cast in range
  const double fl = fmin(fmax(floor(x), 0.0), (double)(n_gran - 1));
  *tau = 2.0 * (x - fl) - 1.0;
  return (int)fl;
}

// Contract one query's row (CH x C doubles in shared memory) with T_k(tau)
// (and dT_k/dtau) into out[0 .. CH) (and dout, scaled by vscale).
template <int CH, bool DERIV, int C>
__device__ __forceinline__ void evaluate_row(const double* row, double tau, double vscale,
                                             double* out, double* dout) {
  double acc[CH];
  double dacc[DERIV ? CH : 1];
  // an even count is read as 16-byte pairs (k, k + 1): pair[c] holds them
  [[maybe_unused]] double2 pair[CH];
  double t_prev = 1.0, t_cur = tau;
  double d_prev = 0.0, d_cur = 1.0;
#pragma unroll
  for (int k = 0; k < C; ++k) {
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
      double ck;
      if constexpr (C % 2 == 0) {
        if (k % 2 == 0) pair[c] = *reinterpret_cast<const double2*>(row + c * C + k);
        ck = k % 2 == 0 ? pair[c].x : pair[c].y;
      } else {
        ck = row[c * C + k];
      }
      if (k == 0) {  // T_0 = 1, dT_0 = 0
        acc[c] = ck * 1.0;
        if (DERIV) dacc[c] = ck * 0.0;
      } else {
        acc[c] += ck * t_cur;
        if (DERIV) dacc[c] += ck * d_cur;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    out[c] = acc[c];
    if (DERIV) dout[c] = dacc[c] * vscale;
  }
}

// Write a tile's nt x CH outputs, staged at P = CH | 1 doubles per query,
// as contiguous 16-byte stores from out + tile0 * CH (16-byte aligned: the
// launcher checks out, and kTile * CH * 8 is a multiple of 16), and one
// 8-byte store for an odd tail.
template <int CH>
__device__ __forceinline__ void store_tile(const double* stage, double* __restrict__ out,
                                           long long tile0, int nt) {
  constexpr int P = CH | 1;
  const int span = nt * CH;
  double* base = out + tile0 * CH;
  double2* base2 = reinterpret_cast<double2*>(base);
  for (int j = threadIdx.x; j < span / 2; j += kTile) {
    const int q = 2 * j;
    base2[j] = make_double2(stage[(q / CH) * P + q % CH],
                            stage[((q + 1) / CH) * P + (q + 1) % CH]);
  }
  if ((span & 1) && threadIdx.x == 0) {
    const int q = span - 1;
    base[q] = stage[(q / CH) * P + q % CH];
  }
}

// CH channels per row and C coefficients per channel; DERIV adds the
// dT_k/dtau contraction (velocity), scaled by vscale = 2 / gran.  coeffs is
// (G, CH, C) row-major, out and dout (n, CH).
template <int CH, bool DERIV, int C>
__global__ void __launch_bounds__(kTile, kMinBlocks)
chebyshev_eval_kernel(const double* __restrict__ coeffs, int n_gran,
                      const double* __restrict__ mjd, long long n, double t0, double gran,
                      double vscale, double* __restrict__ out, double* __restrict__ dout) {
  using S = RowSlots<CH, C>;
  constexpr int P = CH | 1;
  __shared__ __align__(16) double rows[S::kSlots * S::kWidth];
  __shared__ __align__(16) double stage[(DERIV ? 2 : 1) * kTile * P];
  __shared__ int head_rows[kWarps][32];  // granule index of each warp's run heads
  __shared__ int warp_heads[kWarps];     // run heads of each warp

  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const long long tile0 = (long long)blockIdx.x * kTile;
  const long long i = tile0 + t;
  const bool valid = i < n;
  const int nt = (int)(n - tile0 < kTile ? n - tile0 : kTile);

  // the granule index and the normalised time; a run head is a query whose
  // index differs from the query before it in the tile
  int idx = -1;
  double tau = 0.0;
  if (valid) idx = granule(__ldg(mjd + i), t0, gran, n_gran, &tau);
  int prev = __shfl_up_sync(0xffffffffu, idx, 1);
  if (lane == 0 && t > 0 && valid) {
    double unused;
    prev = granule(__ldg(mjd + i - 1), t0, gran, n_gran, &unused);
  }
  const bool head = valid && (t == 0 || idx != prev);
  const unsigned heads = __ballot_sync(0xffffffffu, head);
  const int rank = __popc(heads & ((1u << lane) - 1u));  // heads before this lane
  if (head) head_rows[warp][rank] = idx;
  if (lane == 0) warp_heads[warp] = __popc(heads);
  __syncthreads();

  // slot = the run's rank in the tile: its head's rank in the warp, after
  // the heads of the warps before
  int slot = rank - (head ? 0 : 1);
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int h = warp_heads[w];
    slot += w < warp ? h : 0;
    total += h;
  }

  // rounds of kSlots slots: copy their rows in, then evaluate their queries
  // and stage the results
  for (int base = 0; base < total; base += S::kSlots) {
    if (base > 0) __syncthreads();  // the last round's rows are read
    const int n_rows = total - base < S::kSlots ? total - base : S::kSlots;
    for (int e = t; e < n_rows * S::kPieces; e += kTile) {
      const int s = e / S::kPieces;
      const int w = (e - s * S::kPieces) * S::kPiece;
      // slot base + s belongs to the r-th head of warp h
      int h = 0, r = base + s;
      while (r >= warp_heads[h]) r -= warp_heads[h++];
      copy_async<S::kPiece>(rows + s * S::kWidth + w,
                            coeffs + (long long)head_rows[h][r] * S::kWidth + w);
    }
    copy_async_wait();
    __syncthreads();
    if (valid && slot >= base && slot < base + S::kSlots) {
      evaluate_row<CH, DERIV, C>(rows + (slot - base) * S::kWidth, tau, vscale, stage + t * P,
                                 stage + kTile * P + t * P);
    }
  }
  __syncthreads();  // the staged tile is complete
  store_tile<CH>(stage, out, tile0, nt);
  if (DERIV) store_tile<CH>(stage + kTile * P, dout, tile0, nt);
}

}  // namespace outfit
