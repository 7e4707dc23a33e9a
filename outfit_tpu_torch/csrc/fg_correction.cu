// C launcher for the IOD's f-g correction kernel (fg_correction.cuh), loaded
// from Python with ctypes (outfit_tpu_torch/iod/fg_correction_cuda.py).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -fmad=false -shared -Xcompiler -fPIC -o libfg_correction.so fg_correction.cu

#include "fg_correction.cuh"

// One call's pointers and scalars; the ctypes Structure _Call mirrors it
// field for field.  Per triplet (M = n / per): obs_pos, s_inv, u (M, 3, 3)
// in the working type, time (M, 3), dt01 and dt21 (M,) in float64.  Per
// candidate (n): pos (n, 3, 3), vel (n, 3), chi1 and chi2 (n,) in the
// working type, epoch (n,) float64, alive (n,) bool, and the outputs in
// the same types, with trips (n,) int32.  summary: two zeroed uint64.
struct FgCall {
  const void* obs_pos;
  const void* s_inv;
  const void* u;
  const double* time;
  const double* dt01;
  const double* dt21;
  const void* pos;
  const void* vel;
  const double* epoch;
  const void* chi1;
  const void* chi2;
  const bool* alive;
  void* pos_out;
  void* vel_out;
  double* epoch_out;
  void* chi1_out;
  void* chi2_out;
  bool* alive_out;
  bool* committed_out;
  int* trips_out;
  unsigned long long* summary;
  long long n;
  long long per;
  outfit_fg::FgParams params;
};

namespace {

template <typename T>
int launch(const FgCall& c, cudaStream_t s) {
  outfit_fg::FgArgs<T> a{
      static_cast<const T*>(c.obs_pos), static_cast<const T*>(c.s_inv), static_cast<const T*>(c.u),
      c.time, c.dt01, c.dt21,
      static_cast<const T*>(c.pos), static_cast<const T*>(c.vel), c.epoch,
      static_cast<const T*>(c.chi1), static_cast<const T*>(c.chi2), c.alive,
      static_cast<T*>(c.pos_out), static_cast<T*>(c.vel_out), c.epoch_out,
      static_cast<T*>(c.chi1_out), static_cast<T*>(c.chi2_out), c.alive_out, c.committed_out, c.trips_out,
      c.summary, c.n, c.per, c.params,
  };
  const dim3 grid(static_cast<unsigned>((c.n + outfit_fg::kBlock - 1) / outfit_fg::kBlock));
  outfit_fg::fg_correction_kernel<T><<<grid, outfit_fg::kBlock, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f64 = 0: the float32 instantiation (the mixed-precision candidate pass);
// 1: float64 (the polish and the float64 IOD).  Launches on `stream`, does
// not synchronise, and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a call it does not take.
extern "C" int outfit_fg_correction(const FgCall* call, int f64, void* stream) {
  if (call->n <= 0) return 0;
  if (call->per <= 0 || call->n % call->per != 0 || call->n / outfit_fg::kBlock >= 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(*call, s) : launch<float>(*call, s);
}
