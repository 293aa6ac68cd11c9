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
// (_ball_query_xla) compiles to on the CPU. The last two steps are one
// fma(-2, c . p, |c|^2 + |p|^2): 2 (c . p) is exact in f32, so the fma
// rounds the same exact value once, as the subtraction does. r2 is
// float32(r * r) rounded once from the double product on the host, as JAX
// does with the Python radius; squaring a float radius here would flip
// boundary hits at r = 0.2, 0.4 and 0.8. The intrinsics are never
// contracted by nvcc, so the plain PyTorch version (ops/ball_query.py)
// agrees bit for bit. No tensor cores: a TF32 or bf16 cross term would
// move hits on the radius boundary.
//
// Bound on the H100: the pairs scanned (every point of the row before a
// centre's ns-th hit; at SA1 on scene-like clouds almost no centre fills,
// so all 40,000 points for each of 16,384 centres, 655 M pairs) at 8 flops
// a pair against the f32 rate. The scan issues at least 6 instructions a
// pair (3 for c . p, the add, the fold, the compare) beside the loads and
// votes, so what sets the time is instruction issue, a floor about twice
// the flop bound. The bytes (points, centres and indices, each once) are a
// few MB.
//
// Design: a block takes kWarps warps of C centres each (C = 4 or 1; the
// wrapper picks it, ops/ball_query.py::ball_query_warp_centres), all of one
// batch row, and walks that row's points in input order in tiles of kTile
// points. Every tile is read from L2 once per block instead of once per
// centre:
//   1. cp.async copies tile t + 2 (raw x, y, z, 4 bytes a copy, so any N
//      and any row offset is aligned) into one of two staging buffers while
//      the block scans tile t;
//   2. once a tile has landed, the block packs it as (x, y, z, |p|^2), each
//      |p|^2 computed once, padded to a whole number of 64-point steps
//      with points at |p|^2 = inf (d2 = inf: never a hit);
//   3. each warp scans the packed tile two 32-point chunks a step, each
//      lane one point of each against the warp's C centres held in
//      registers, so one shared-memory load serves C pairs. One vote finds
//      whether any of the C centres has a hit in the two chunks; only then
//      a ballot per centre and chunk finds its hits and popc of the lower
//      lanes ranks them, chunk by chunk in index order, as in the
//      one-warp-a-centre kernel it replaces.
// Early exit: a centre with ns hits compares against -inf from then on and
// a warp whose centres are all full stops scanning; the block stops
// loading tiles once none of its centres can take another hit
// (__syncthreads_or). C trades the instructions a pair (the loads and the
// vote are shared by C centres) against the warps in flight (b m / C):
// C = 4 where there are centres enough to keep every SM busy (SA1, SA2),
// C = 1 at the small call sites, where centres fill within a few chunks
// and the time is latency. 16 warps a block beat 4 and 8 at every call
// site (PERF.md, Findings).
//
// What still holds it back (H100 80GB HBM3, 700 W; PERF.md, Findings): at SA1
// it takes 0.256 ms, 3.8x faster than the one-warp-a-centre kernel. Its
// step issues 61 instructions for 8 pairs at C = 4 (cuobjdump), so at the
// 1,980 MHz it runs at the issue floor is 0.149 ms: the kernel reaches
// about 58% of it. SA1's 256 blocks give an SM at most two (32 warps; 64
// registers a thread allow no more at 512 threads), and each warp waits at
// two block barriers a tile. Untried: more chunks a vote (over 64
// registers, so one block an SM), or a ring of packed tiles on mbarriers
// that lets warps run without block barriers.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 1024;         // points a tile
constexpr int kWarps = 16;          // warps a block
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return __fmaf_rn(az, bz, __fmaf_rn(ay, by, __fmul_rn(ax, bx)));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Copies tile t of a row's raw x, y, z into buf and closes a cp.async group
// (an empty one past the row's end, so that every thread's groups count
// the tiles). This loop and the packing loop are unrolled whole at C = 4,
// where that saves registers and time at SA1, and not at C = 1, where it
// costs the small call sites about 10% (PERF.md, Findings).
template <int C>
__device__ __forceinline__ void issue_tile(float* buf, const float* __restrict__ row, int n,
                                           int t) {
  const int base = t * kTile;
  if (base < n) {
    const int floats = 3 * min(kTile, n - base);
    const float* src = row + 3LL * base;
    const uint32_t dst = smem_addr(buf);
#pragma unroll(C == 1 ? 1 : 3 * kTile / kThreads)
    for (int i = threadIdx.x; i < floats; i += kThreads) cp_async4(dst + 4 * i, src + i);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Takes the hits of one 32-point chunk (points start + lane), whose
// distances to the warp's C centres are d2: for each centre with a hit, a
// ballot finds them and popc of the lower lanes ranks them, in index order.
template <int C>
__device__ __forceinline__ void take_hits(const float (&d2)[C], float (&lim)[C],
                                          int (&count)[C], int (&first)[C], unsigned& live,
                                          int start, int lane, int ns, int* __restrict__ o) {
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const bool hit = d2[j] < lim[j];
    const unsigned mask = __ballot_sync(kFull, hit);
    if (mask == 0u) continue;
    if (count[j] == 0) first[j] = start + __ffs(static_cast<int>(mask)) - 1;
    const int rank = count[j] + __popc(mask & ((1u << lane) - 1u));
    if (hit && rank < ns) o[j * ns + rank] = start + lane;
    count[j] += __popc(mask);
    if (count[j] >= ns) {
      lim[j] = -__int_as_float(0x7f800000);
      live &= ~(1u << j);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
ball_query_kernel(const float* __restrict__ xyz, const float* __restrict__ centers, int n,
                  int m, float r2, int ns, int* __restrict__ out) {
  __shared__ float raw[2][3 * kTile];
  __shared__ float4 tile[kTile];
  const int lane = threadIdx.x & 31;
  const long long row = blockIdx.y;
  const int c0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * C;
  const float* __restrict__ p = xyz + row * n * 3;
  int* __restrict__ o = out + (row * m + c0) * ns;

  // the warp's centres; lim is r2 while a centre takes hits, -inf after
  // (and for slots past m), and bit j of live says which still do
  float cx[C], cy[C], cz[C], c2[C], lim[C];
  int count[C], first[C];
  unsigned live = 0;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    cx[j] = cy[j] = cz[j] = 0.0f;
    lim[j] = -__int_as_float(0x7f800000);
    count[j] = first[j] = 0;
    if (c0 + j < m) {
      const float* q = centers + (row * m + c0 + j) * 3;
      cx[j] = __ldg(q);
      cy[j] = __ldg(q + 1);
      cz[j] = __ldg(q + 2);
      lim[j] = r2;
      live |= 1u << j;
    }
    c2[j] = dot3(cx[j], cy[j], cz[j], cx[j], cy[j], cz[j]);
  }

  const int tiles = (n + kTile - 1) / kTile;
  issue_tile<C>(raw[0], p, n, 0);
  issue_tile<C>(raw[1], p, n, 1);
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<1>();   // this thread's copies of tile t have landed
    // every thread's have, and every warp is done with tile t - 1; stop
    // once no centre of the block can take another hit
    if (!__syncthreads_or(live != 0)) break;
    const int base = t * kTile;
    const int pts = min(kTile, n - base);
    const int padded = (pts + 63) & ~63;   // whole pairs of chunks
    const float* r = raw[t & 1];
#pragma unroll(C == 1 ? 1 : kTile / kThreads)
    for (int i = threadIdx.x; i < padded; i += kThreads) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(0x7f800000));
      if (i < pts) {
        v.x = r[3 * i];
        v.y = r[3 * i + 1];
        v.z = r[3 * i + 2];
        v.w = dot3(v.x, v.y, v.z, v.x, v.y, v.z);
      }
      tile[i] = v;
    }
    __syncthreads();      // the packed tile is in; raw[t & 1] is free
    issue_tile<C>(raw[t & 1], p, n, t + 2);
    if (live == 0) continue;
    // two chunks a step, one vote for both: the hit path is rare where
    // the time goes (SA1)
#pragma unroll 1
    for (int k = 0; k < padded; k += 64) {
      const float4 qa = tile[k + lane];
      const float4 qb = tile[k + 32 + lane];
      float da[C], db[C];
      bool any = false;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        da[j] = __fmaf_rn(-2.0f, dot3(cx[j], cy[j], cz[j], qa.x, qa.y, qa.z),
                          __fadd_rn(c2[j], qa.w));
        db[j] = __fmaf_rn(-2.0f, dot3(cx[j], cy[j], cz[j], qb.x, qb.y, qb.z),
                          __fadd_rn(c2[j], qb.w));
        any |= (da[j] < lim[j]) | (db[j] < lim[j]);
      }
      if (!__any_sync(kFull, any)) continue;
      take_hits<C>(da, lim, count, first, live, base + k, lane, ns, o);
      take_hits<C>(db, lim, count, first, live, base + k + 32, lane, ns, o);
      if (live == 0) break;
    }
  }
  cp_async_wait<0>();     // no copy may land after the block has left

#pragma unroll
  for (int j = 0; j < C; ++j) {
    if (c0 + j >= m) break;
    const int fill = count[j] > 0 ? first[j] : 0;
    for (int s = min(count[j], ns) + lane; s < ns; s += 32) o[j * ns + s] = fill;
  }
}

using Kernel = void (*)(const float*, const float*, int, int, float, int, int*);

// The build for C centres a warp; null for another C.
Kernel kernel_for(int warp_centres) {
  switch (warp_centres) {
    case 1: return ball_query_kernel<1>;
    case 4: return ball_query_kernel<4>;
    default: return nullptr;
  }
}

}  // namespace

// The points a tile and the warps a block (ops/ball_query.py mirrors both).
extern "C" int spacap_ball_query_tile_points() { return kTile; }
extern "C" int spacap_ball_query_warps() { return kWarps; }

// The launch at C = warp_centres (4 or 1): shared memory a block (bytes),
// how many such blocks an SM holds at once, and the device's SMs. Returns
// the cudaError_t.
extern "C" int spacap_ball_query_launch_info(int warp_centres, int* smem, int* blocks_per_sm,
                                             int* sms) {
  const Kernel k = kernel_for(warp_centres);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, reinterpret_cast<const void*>(k));
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem = static_cast<int>(fa.sharedSizeBytes);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, reinterpret_cast<const void*>(k), kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev));
}

// xyz (b, n, 3), centers (b, m, 3) f32 contiguous -> out (b, m, ns) int32,
// with warp_centres centres a warp (4 or 1). Returns the cudaError_t of the
// launch.
extern "C" int spacap_ball_query(const float* xyz, const float* centers, int b, int n, int m,
                                 float r2, int ns, int warp_centres, int* out, void* stream) {
  const Kernel k = kernel_for(warp_centres);
  if (b <= 0 || n <= 0 || m <= 0 || ns <= 0 || b > 65535 || k == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = kWarps * warp_centres;
  const dim3 grid(static_cast<unsigned>((m + per_block - 1) / per_block),
                  static_cast<unsigned>(b));
  k<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(xyz, centers, n, m, r2, ns, out);
  return static_cast<int>(cudaGetLastError());
}
