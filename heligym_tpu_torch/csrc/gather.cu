// gather.cu — per-element gathers along axis 0 and axis 1, for Hopper (sm_90a).
//
// Replaces the two TPU probe kernels of tools/exp_gather.py:
//   gather_axis0_kernel (:18): out[s, l] = x[idx[s, l], l]
//   gather_axis1_kernel (:22): out[s, l] = x[s, idx[s, l]]
// (both launched by `build`, pl.pallas_call at :27), i.e. numpy's
// take_along_axis for f32 x (S, L) and i32 idx (S, L), row-major.
//
// What bounds them on the H100: bytes. Each output element reads one index
// (4 B) and one value (4 B) and writes one value (4 B), with no arithmetic:
// 12 B per element, 12.6 MB at (1024, 1024), 3.76 us at 3.35 TB/s. At the
// probe sizes x (at most 4 MB) sits in the 50 MB L2 after its first touch,
// so the random reads cost L2 sectors, not device-memory rows.
// What the design does about it: one thread per output element, threads
// along L, so the index loads and the output stores of a warp are 128
// contiguous bytes (coalesced). The value reads are scattered by nature: along
// axis 0 a warp reads 32 different rows at neighbouring columns (32 sectors
// in the worst case), along axis 1 it reads within one row (as few as 4
// sectors, as many as 32).
//
// An index must lie in [0, n). The wrapper checks that on the host when
// asked; the kernels clamp, so a bad index never reads outside x.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int clamp_index(int j, int n) {
  return j < 0 ? 0 : (j >= n ? n - 1 : j);
}

__global__ void __launch_bounds__(kThreads)
gather_axis0_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                    float* __restrict__ out, int S, int L) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)S * L) return;
  const int l = (int)(e % L);
  out[e] = x[(long long)clamp_index(idx[e], S) * L + l];
}

__global__ void __launch_bounds__(kThreads)
gather_axis1_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                    float* __restrict__ out, int S, int L) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)S * L) return;
  const long long s = e / L;
  out[e] = x[s * L + clamp_index(idx[e], L)];
}

template <typename Kernel>
int launch(Kernel kernel, const float* x, const int* idx, float* out, int S,
           int L, void* stream) {
  const long long total = (long long)S * L;
  if (total == 0) return 0;
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(x, idx, out, S, L);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes); each returns the cudaError_t of its
// launch. `out` must not alias `x`.
extern "C" int heligym_gather_axis0(const float* x, const int* idx, float* out,
                                    int S, int L, void* stream) {
  return launch(gather_axis0_kernel, x, idx, out, S, L, stream);
}

extern "C" int heligym_gather_axis1(const float* x, const int* idx, float* out,
                                    int S, int L, void* stream) {
  return launch(gather_axis1_kernel, x, idx, out, S, L, stream);
}
