// Furthest point sampling on Hopper (sm_90a).
//
// Replaces the TPU kernel spacap3d_tpu/ops/fps_pallas.py::
// furthest_point_sample_pallas (_fps_kernel). Contract
// (spacap3d_tpu/ops/fps.py:3-10): index 0 comes first; a point with
// x^2+y^2+z^2 <= 1e-3 starts at min-distance -1 and is never picked; each
// step picks the largest min squared distance to the picks so far, lowest
// index on ties.
//
// Arithmetic: every three-term sum of squares is the chain
// fma(z, z, fma(y, y, x * x)), the order the JAX oracle
// (furthest_point_sample_xla) compiles to on the CPU. The intrinsics below
// are never contracted or reordered by nvcc, so the plain PyTorch version
// (ops/fps.py) reproduces them bit for bit.
//
// Bound on the H100: npoint - 1 dependent steps per row, each a pass over
// the row's N points and a block-wide argmax. The work is a few GFLOP, far
// below the card's f32 rate; what limits the kernel is the latency of the
// sequential steps with only B blocks (8 at SA1) on a 132-SM card.
// Design: one 1024-thread block per batch row. The row's min-distance
// array lives in dynamic shared memory (40000 x 4 B = 160 KB at SA1; rows
// above the shared-memory limit use a global scratch row instead); the
// coordinates are read through the read-only path each step, and one row
// (480 KB) stays resident in L2. The argmax is a (value, index) warp
// shuffle reduction, then one more across the 32 warps, two barriers a
// step. Splitting a row across a thread-block cluster is left for later.
#include <cfloat>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kMagEps = 1e-3f;
constexpr float kInitDist = 1e10f;
// min-distance rows up to this many points live in shared memory
constexpr int kSmemPoints = 51200;  // 200 KB of the 227 KB a block may use

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

// (v, i) <- the better of (v, i) and (ov, oi): larger value, then lower index
__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    take_better(v, i, ov, oi);
  }
}

template <bool kInSmem>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, int n, int npoint,
           float* __restrict__ scratch, int* __restrict__ out) {
  extern __shared__ float smem_mind[];
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ int picked;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* __restrict__ p = xyz + static_cast<size_t>(row) * n * 3;
  float* mind = kInSmem ? smem_mind : scratch + static_cast<size_t>(row) * n;
  int* o = out + static_cast<size_t>(row) * npoint;

  for (int k = tid; k < n; k += kThreads) {
    const float x = __ldg(p + 3 * k), y = __ldg(p + 3 * k + 1), z = __ldg(p + 3 * k + 2);
    mind[k] = sq3(x, y, z) > kMagEps ? kInitDist : -1.0f;
  }
  if (tid == 0) o[0] = 0;
  int last = 0;
  __syncthreads();

  for (int s = 1; s < npoint; ++s) {
    const float lx = __ldg(p + 3 * last);
    const float ly = __ldg(p + 3 * last + 1);
    const float lz = __ldg(p + 3 * last + 2);
    float best_v = -FLT_MAX;
    int best_i = INT_MAX;
    for (int k = tid; k < n; k += kThreads) {
      const float dx = __fsub_rn(__ldg(p + 3 * k), lx);
      const float dy = __fsub_rn(__ldg(p + 3 * k + 1), ly);
      const float dz = __fsub_rn(__ldg(p + 3 * k + 2), lz);
      // invalid points hold -1 and d >= 0, so the plain min keeps them at -1
      const float m = fminf(mind[k], sq3(dx, dy, dz));
      mind[k] = m;
      if (m > best_v) {  // strict: the lowest index of this thread wins ties
        best_v = m;
        best_i = k;
      }
    }
    warp_argmax(best_v, best_i);
    if (lane == 0) {
      warp_v[warp] = best_v;
      warp_i[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best_v = warp_v[lane];
      best_i = warp_i[lane];
      warp_argmax(best_v, best_i);
      if (lane == 0) {
        picked = best_i;
        o[s] = best_i;
      }
    }
    __syncthreads();
    last = picked;
  }
}

}  // namespace

extern "C" int spacap_fps_smem_points() { return kSmemPoints; }

// xyz (b, n, 3) f32 contiguous -> out (b, npoint) int32. scratch is a
// (b, n) f32 buffer, needed only when n > spacap_fps_smem_points().
// Returns the cudaError_t of the launch.
extern "C" int spacap_fps(const float* xyz, int b, int n, int npoint,
                          float* scratch, int* out, void* stream) {
  if (b <= 0 || n <= 0 || npoint <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= kSmemPoints) {
    const int bytes = n * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        fps_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    fps_kernel<true><<<b, kThreads, bytes, st>>>(xyz, n, npoint, nullptr, out);
  } else {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    fps_kernel<false><<<b, kThreads, 0, st>>>(xyz, n, npoint, scratch, out);
  }
  return static_cast<int>(cudaGetLastError());
}
