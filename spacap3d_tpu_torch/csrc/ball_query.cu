// Ball query on Hopper (sm_90a).
//
// Replaces the TPU kernel spacap3d_tpu/ops/ball_query_pallas.py::
// ball_query_pallas (_bq_kernel), and serves every call site of the eval
// forward (SA1-SA4 and vote aggregation). Contract
// (spacap3d_tpu/ops/ball_query.py:3-10): for each centre, the first ns
// point indices in input order with d2 < r2; empty slots repeat the first
// hit; a centre with no hit gets a zero row.
//
// Arithmetic: d2 = (|c|^2 + |p|^2) - 2 (c . p), where each three-term sum
// is the chain fma(a_z, b_z, fma(a_y, b_y, a_x * b_x)) that the JAX oracle
// (_ball_query_xla) compiles to on the CPU. r2 is float32(r * r) rounded
// once from the double product on the host, as JAX does with the Python
// radius; squaring a float radius here would flip boundary hits at
// r = 0.2, 0.4 and 0.8. The intrinsics are never contracted by nvcc, so
// the plain PyTorch version (ops/ball_query.py) agrees bit for bit.
//
// Bound on the H100: the pairwise distance work (8 flops a pair over the
// points scanned before the ns-th hit) against the f32 rate; the bytes
// (points, centres and indices, each once) are a few MB. Design: one warp
// per centre scans the row's points in input order, 32 at a time; a
// ballot finds the hits, popc of the lower lanes ranks them, and the warp
// stops at ns hits. No TPU-style prefix-sum tiling: the ballot is the
// prefix sum. Points are read from L2 by every warp; sharing point tiles
// through shared memory across a block's centres is left for later.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return __fmaf_rn(az, bz, __fmaf_rn(ay, by, __fmul_rn(ax, bx)));
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ball_query_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
                  int b, int n, int m, float r2, int ns, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long c = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (c >= static_cast<long long>(b) * m) return;  // the whole warp leaves together
  const long long row = c / m;
  const float* __restrict__ p = xyz + row * n * 3;
  const float cx = __ldg(centers + 3 * c);
  const float cy = __ldg(centers + 3 * c + 1);
  const float cz = __ldg(centers + 3 * c + 2);
  const float c2 = dot3(cx, cy, cz, cx, cy, cz);
  int* __restrict__ o = out + c * ns;

  int count = 0;  // warp-uniform
  int first = 0;  // warp-uniform
  for (int base = 0; base < n && count < ns; base += 32) {
    const int k = base + lane;
    bool hit = false;
    if (k < n) {
      const float px = __ldg(p + 3 * k);
      const float py = __ldg(p + 3 * k + 1);
      const float pz = __ldg(p + 3 * k + 2);
      const float p2 = dot3(px, py, pz, px, py, pz);
      const float cross = dot3(cx, cy, cz, px, py, pz);
      const float d2 = __fsub_rn(__fadd_rn(c2, p2), __fmul_rn(2.0f, cross));
      hit = d2 < r2;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (mask != 0u) {
      if (count == 0) first = base + __ffs(static_cast<int>(mask)) - 1;
      const int rank = count + __popc(mask & ((1u << lane) - 1u));
      if (hit && rank < ns) o[rank] = k;
      count += __popc(mask);
    }
  }
  const int fill = count > 0 ? first : 0;
  for (int s = min(count, ns) + lane; s < ns; s += 32) o[s] = fill;
}

}  // namespace

// xyz (b, n, 3), centers (b, m, 3) f32 contiguous -> out (b, m, ns) int32.
// Returns the cudaError_t of the launch.
extern "C" int spacap_ball_query(const float* xyz, const float* centers, int b, int n,
                                 int m, float r2, int ns, int* out, void* stream) {
  if (b <= 0 || n <= 0 || m <= 0 || ns <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long warps = static_cast<long long>(b) * m;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ball_query_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(xyz, centers, b, n, m, r2, ns, out);
  return static_cast<int>(cudaGetLastError());
}
