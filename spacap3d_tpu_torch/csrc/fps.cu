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
// the row's N points and an argmax over them. The operations are a few
// GFLOP, far below the card's f32 rate; what sets the time is the latency
// of one step, times 2047 steps at SA1.
//
// Design (fps_kernel_cluster): one row per thread-block cluster of C blocks
// (C in {1, 2, 4, 8, 16}; the wrapper picks the largest whose clusters are
// all resident at once). Block rank q owns the contiguous points
// [q P, (q + 1) P), P = ceil(N / C), so rank order is index order. Each
// thread holds K of them (x, y, z and the min distance) in registers, and
// the block keeps a copy of their coordinates in shared memory, all loaded
// once; after that a step touches global memory only to write out[row, s].
// A step:
//   1. each thread updates its K distances and takes its first maximum
//      by a pairwise tree (the lower index on the left keeps ties);
//   2. each warp takes its (largest value, then lowest index) with two
//      redux.sync on an order-preserving int key of the value, and lane 0
//      writes it to shared memory; one __syncthreads;
//   3. warp 0 forms the block's candidate (value, index, and the point's
//      coordinates from shared memory), and lane r < C stores it into slot
//      [s & 1][q] of rank r's shared memory with st.async, which completes
//      bytes on rank r's mbarrier of parity s & 1;
//   4. every warp of every block waits on its own mbarrier for the C
//      candidates (20 bytes each) and reduces them itself, so every block
//      gets the same winner and its coordinates with no second block
//      barrier and no global read. Rank 0 writes the index.
// A block waits for the data it needs, not for every thread of the
// cluster: one cluster barrier a step after plain st.shared::cluster
// stores measured 0.35 us a step slower on the H100 (PERF.md).
// Why the slots and mbarriers may be reused every other step: a block
// writes parity s & 1 of a peer again only at step s + 2, after it has
// received the step s + 1 candidates of every rank, the peer's among them;
// the peer sent that one after its __syncthreads of step s + 1, which each
// of its warps reaches only after it has read its step-s slots and passed
// its wait on the step-s phase. So a phase is complete and read before the
// next one's bytes can land, and its expect_tx (thread 0, at step s) comes
// after thread 0 itself waited on the phase before it.
//
// Rows of more than kMaxCluster * kBlockPoints points do not fit in a
// cluster's registers; they take fps_kernel_stream: one 1024-thread block
// a row, min distances in a global scratch row, coordinates read through
// the read-only path every step.
#include <cfloat>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "per_device.cuh"

namespace {

constexpr float kMagEps = 1e-3f;
constexpr float kInitDist = 1e10f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCluster = 16;     // non-portable above 8
constexpr int kBlockPoints = 8192;  // the most points one block holds (K x threads)
constexpr int kMinThreads = 128;    // the fewest threads a block gets by default
constexpr int kDefaultPerThread = 10;   // the points a thread aims at by default
constexpr int kCandBytes = 20;      // a candidate: key, index, x, y (16 bytes) and z
constexpr int kStreamThreads = 1024;

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

// ---------------------------------------------------------------------------
// The cluster kernel

// Points a thread holds (K), and the most threads a block of that K runs:
// registers allow 4 K + ~30 a thread.
constexpr int kPerThread[] = {1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 24, 32};
constexpr int kVariants = sizeof(kPerThread) / sizeof(kPerThread[0]);
__host__ __device__ constexpr int max_threads(int k) {
  return k <= 6 ? 1024 : k <= 12 ? 640 : k <= 24 ? 384 : 256;
}
template <int K>
struct MaxThreads {
  static constexpr int value = max_threads(K);
};

// A float's int key with the same order (no NaN; no -0.0 occurs: distances
// are sums of squares and the initial values are 1e10 and -1).
__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(v);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

// The warp's first maximum of (key, idx): the largest key, then the lowest
// index. Every lane gets it.
__device__ __forceinline__ void warp_best(int& key, int& idx) {
  const int top = __reduce_max_sync(kFull, key);
  idx = __reduce_min_sync(kFull, key == top ? idx : INT_MAX);
  key = top;
}

// The lowest lane whose own (key, idx) is the warp's winner.
__device__ __forceinline__ int winner_lane(bool mine) {
  return __ffs(__ballot_sync(kFull, mine)) - 1;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// The address of shared::cta address `addr` in cluster block `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
// 16 and 4 bytes into a peer's shared memory; each completes its bytes on
// the peer's mbarrier at `bar`
__device__ __forceinline__ void st_async(uint32_t addr, int4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Waits for the phase of parity `parity`; acquire at cluster scope, so the
// peers' st.async bytes are visible after it.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// grid (C, B), cluster (C, 1, 1): block x is the rank, y the row. Each
// block owns the points [rank * per_block, (rank + 1) * per_block) of its
// row, at most K * blockDim.x of them; dynamic shared memory holds
// K * blockDim.x float4s.
template <int K>
__global__ void __launch_bounds__(MaxThreads<K>::value)
fps_kernel_cluster(const float* __restrict__ xyz, int n, int npoint, int cluster, int per_block,
                   int* __restrict__ out) {
  extern __shared__ float4 sxyz[];       // this block's points, at index - lo
  __shared__ int2 warp_best_of[2][32];   // (key, index) of each warp's winner, by step parity
  __shared__ int4 cand_a[2][kMaxCluster];   // (key, index, x, y) of each rank's candidate
  __shared__ float cand_z[2][kMaxCluster];
  __shared__ __align__(8) unsigned long long bars[2];   // by step parity

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int threads = blockDim.x, warps = threads >> 5;
  const int rank = blockIdx.x;
  const float* __restrict__ p = xyz + static_cast<size_t>(blockIdx.y) * n * 3;
  int* o = out + static_cast<size_t>(blockIdx.y) * npoint;
  const int lo = rank * per_block;
  const int hi = min(lo + per_block, n);
  const bool writer = rank == 0 && tid == 0;
  const uint32_t bar0 = smem_addr(&bars[0]);

  if (tid == 0) {   // one local arrival a phase (thread 0's expect_tx)
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_arrive_relaxed();   // peers store to us only once every block has started

  // slots past the row's end hold -FLT_MAX: below every real point's -1,
  // they never win
  float px[K], py[K], pz[K], pm[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = lo + k * threads + tid;
    if (i < hi) {
      px[k] = __ldg(p + 3 * i);
      py[k] = __ldg(p + 3 * i + 1);
      pz[k] = __ldg(p + 3 * i + 2);
      pm[k] = sq3(px[k], py[k], pz[k]) > kMagEps ? kInitDist : -1.0f;
      sxyz[k * threads + tid] = make_float4(px[k], py[k], pz[k], 0.0f);
    } else {
      px[k] = py[k] = pz[k] = 0.0f;
      pm[k] = -FLT_MAX;
    }
  }
  float lx = __ldg(p), ly = __ldg(p + 1), lz = __ldg(p + 2);
  if (writer) o[0] = 0;
  __syncthreads();
  cluster_wait_acquire();
  // lane r < C sends to rank r: its slots and mbarriers there, both parities
  const int peer = lane < cluster ? lane : 0;
  const uint32_t to_a0 = map_rank(smem_addr(&cand_a[0][rank]), peer);
  const uint32_t to_a1 = map_rank(smem_addr(&cand_a[1][rank]), peer);
  const uint32_t to_z0 = map_rank(smem_addr(&cand_z[0][rank]), peer);
  const uint32_t to_z1 = map_rank(smem_addr(&cand_z[1][rank]), peer);
  const uint32_t to_bar = map_rank(bar0, peer);
  uint32_t phases = 0;   // bit q: the parity of mbarrier q's current phase

  for (int s = 1; s < npoint; ++s) {
    const int par = s & 1;
    // 1. this thread's first maximum
    float tv[K];
    int tk[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float dx = __fsub_rn(px[k], lx);
      const float dy = __fsub_rn(py[k], ly);
      const float dz = __fsub_rn(pz[k], lz);
      // invalid points hold -1 and d >= 0, so the plain min keeps them at -1
      const float m = fminf(pm[k], sq3(dx, dy, dz));
      pm[k] = m;
      tv[k] = m;
      tk[k] = k;
    }
#pragma unroll
    for (int w = 1; w < K; w *= 2) {
#pragma unroll
      for (int k = 0; k + w < K; k += 2 * w) {
        if (tv[k + w] > tv[k]) {   // strict: the lower index keeps a tie
          tv[k] = tv[k + w];
          tk[k] = tk[k + w];
        }
      }
    }
    // 2. the warp's
    int key = order_key(tv[0]), idx = lo + tk[0] * threads + tid;
    warp_best(key, idx);
    if (lane == 0) warp_best_of[par][warp] = make_int2(key, idx);
    const uint32_t bar = bar0 + 8 * par;
    if (tid == 0) mbar_expect_tx(bar, cluster * kCandBytes);
    __syncthreads();
    // 3. the block's, to every rank
    if (warp == 0) {
      const int2 w = lane < warps ? warp_best_of[par][lane] : make_int2(INT_MIN, INT_MAX);
      key = w.x;
      idx = w.y;
      warp_best(key, idx);
      const float4 c = sxyz[idx - lo];
      if (lane < cluster) {
        const int4 ka = make_int4(key, idx, __float_as_int(c.x), __float_as_int(c.y));
        st_async(par ? to_a1 : to_a0, ka, to_bar + 8 * par);
        st_async(par ? to_z1 : to_z0, c.z, to_bar + 8 * par);
      }
    }
    // 4. the cluster's, from the C candidates
    mbar_wait(bar, (phases >> par) & 1u);
    phases ^= 1u << par;
    const int4 a = lane < cluster ? cand_a[par][lane] : make_int4(INT_MIN, INT_MAX, 0, 0);
    const float z = lane < cluster ? cand_z[par][lane] : 0.0f;
    key = a.x;
    idx = a.y;
    warp_best(key, idx);
    const int src = winner_lane(a.x == key && a.y == idx);
    lx = __int_as_float(__shfl_sync(kFull, a.z, src));
    ly = __int_as_float(__shfl_sync(kFull, a.w, src));
    lz = __shfl_sync(kFull, z, src);
    if (writer) o[s] = idx;
  }
  // no block leaves while a peer's last stores may still be in flight
  if (cluster > 1) {
    cluster_arrive_release();
    cluster_wait_acquire();
  }
}

using ClusterKernel = void (*)(const float*, int, int, int, int, int*);
// the instantiation for kPerThread[v]
ClusterKernel cluster_kernel(int v) {
  static const ClusterKernel table[kVariants] = {
      fps_kernel_cluster<1>,  fps_kernel_cluster<2>,  fps_kernel_cluster<3>,
      fps_kernel_cluster<4>,  fps_kernel_cluster<5>,  fps_kernel_cluster<6>,
      fps_kernel_cluster<8>,  fps_kernel_cluster<10>, fps_kernel_cluster<12>,
      fps_kernel_cluster<16>, fps_kernel_cluster<24>, fps_kernel_cluster<32>};
  return table[v];
}

bool valid_cluster(int c) { return c == 1 || c == 2 || c == 4 || c == 8 || c == 16; }

// Shared memory a block of the variant takes: its points' coordinates.
int dynamic_smem(int threads, int k) { return threads * k * static_cast<int>(sizeof(float4)); }

// The variant and block size for `per_block` points and at most
// `threads_cap` threads: the smallest K whose block of ceil(per_block / K)
// threads (rounded up to a warp) fits both caps. False if none does. By
// default (threads_cap 0) the cap is the fewest threads that hold the
// points at K = kDefaultPerThread, and no fewer than kMinThreads: more
// warps lengthen the step's barrier and reductions, more points a thread
// its serial update. On the H100 that gave the fastest block at both
// main-path shapes (256 threads for 2,500 points, 128 for 1,024; PERF.md).
bool pick_variant(int per_block, int threads_cap, int* variant, int* threads) {
  if (threads_cap <= 0) {
    const int t = ((per_block + kDefaultPerThread - 1) / kDefaultPerThread + 31) / 32 * 32;
    threads_cap = t > kMinThreads ? t : kMinThreads;
  }
  for (int v = 0; v < kVariants; ++v) {
    const int k = kPerThread[v];
    const int t = ((per_block + k - 1) / k + 31) / 32 * 32;
    if (t <= threads_cap && t <= max_threads(k)) {
      *variant = v;
      *threads = t;
      return true;
    }
  }
  return false;
}

// Cluster sizes above 8 need the non-portable opt-in, and blocks above 48 KB
// of shared memory theirs: once per device, not every call.
cudaError_t allow_clusters() {
  static PerDevice guard;
  return guard([] {
    for (int v = 0; v < kVariants; ++v) {
      cudaError_t e = cudaFuncSetAttribute(
          cluster_kernel(v), cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return e;
      e = cudaFuncSetAttribute(cluster_kernel(v), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dynamic_smem(max_threads(kPerThread[v]), kPerThread[v]));
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  });
}

cudaLaunchConfig_t launch_config(int b, int cluster, int threads, int k, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster), static_cast<unsigned>(b), 1);
  cfg.blockDim = dim3(static_cast<unsigned>(threads), 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(dynamic_smem(threads, k));
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// ---------------------------------------------------------------------------
// The streaming kernel, for rows too long for a cluster

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
    const float ov = __shfl_down_sync(kFull, v, off);
    const int oi = __shfl_down_sync(kFull, i, off);
    take_better(v, i, ov, oi);
  }
}

__global__ void __launch_bounds__(kStreamThreads)
fps_kernel_stream(const float* __restrict__ xyz, int n, int npoint, float* __restrict__ scratch,
                  int* __restrict__ out) {
  constexpr int kWarps = kStreamThreads / 32;
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ int picked;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* __restrict__ p = xyz + static_cast<size_t>(row) * n * 3;
  float* mind = scratch + static_cast<size_t>(row) * n;
  int* o = out + static_cast<size_t>(row) * npoint;

  for (int k = tid; k < n; k += kStreamThreads) {
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
    for (int k = tid; k < n; k += kStreamThreads) {
      const float dx = __fsub_rn(__ldg(p + 3 * k), lx);
      const float dy = __fsub_rn(__ldg(p + 3 * k + 1), ly);
      const float dz = __fsub_rn(__ldg(p + 3 * k + 2), lz);
      const float m = fminf(mind[k], sq3(dx, dy, dz));
      mind[k] = m;
      if (m > best_v) {
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

// The most points one block of the cluster kernel holds; rows of up to
// 16 times this many take it.
extern "C" int spacap_fps_block_points() { return kBlockPoints; }

// The cluster kernel's launch for a row of n points split over `cluster`
// blocks (1, 2, 4, 8 or 16) with at most `threads_cap` threads a block (0:
// the default, see pick_variant): its threads a block, points a thread
// (K), shared memory a block (static and dynamic, bytes), and how many of
// its clusters the device holds at once (cudaOccupancyMaxActiveClusters).
// Returns the cudaError_t.
extern "C" int spacap_fps_launch_info(int n, int cluster, int threads_cap, int* threads,
                                      int* per_thread, int* smem, int* clusters) {
  if (n <= 0 || !valid_cluster(cluster)) return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = (n + cluster - 1) / cluster;
  int variant = 0;
  if (per_block > kBlockPoints || !pick_variant(per_block, threads_cap, &variant, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  *per_thread = kPerThread[variant];
  cudaError_t err = allow_clusters();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, cluster_kernel(variant));
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem = static_cast<int>(fa.sharedSizeBytes) + dynamic_smem(*threads, *per_thread);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(1, cluster, *threads, *per_thread, nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      clusters, reinterpret_cast<const void*>(cluster_kernel(variant)), &cfg));
}

// xyz (b, n, 3) f32 contiguous -> out (b, npoint) int32. cluster 1, 2, 4,
// 8 or 16: the cluster kernel, a row split over that many blocks of at
// most threads_cap threads (0: the default), ceil(n / cluster) <=
// spacap_fps_block_points(). cluster 0: the streaming kernel, with scratch
// a (b, n) f32 buffer. Returns the cudaError_t of the launch.
extern "C" int spacap_fps(const float* xyz, int b, int n, int npoint, int cluster,
                          int threads_cap, float* scratch, int* out, void* stream) {
  if (b <= 0 || n <= 0 || npoint <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster == 0) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    fps_kernel_stream<<<b, kStreamThreads, 0, st>>>(xyz, n, npoint, scratch, out);
    return static_cast<int>(cudaGetLastError());
  }
  if (!valid_cluster(cluster)) return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = (n + cluster - 1) / cluster;
  int variant = 0, threads = 0;
  if (per_block > kBlockPoints || !pick_variant(per_block, threads_cap, &variant, &threads))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_clusters();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(b, cluster, threads, kPerThread[variant], st, &attr);
  err = cudaLaunchKernelEx(&cfg, cluster_kernel(variant), xyz, n, npoint, cluster, per_block, out);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
