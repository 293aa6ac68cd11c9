// Fused greedy-decode kernels on Hopper (sm_90a): the generator's argmax and
// the position-wise FFN, each one launch with its intermediate kept on chip.
//
// Both issue wgmma on weights that ops/decode.py laid out once per decode
// (pack_generator, pack_ffn) as the shared-memory image the wgmma descriptors
// read, brought in chunk by chunk by bulk asynchronous copies, and both split
// their weights over a thread-block cluster. No library GEMM is called.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math_constants.h>
#include <stdint.h>

#include "per_device.cuh"

#ifdef SPACAP_FFN_TIMELINE
// Diagnostic build only (spacap3d_tpu_torch/tools/ffn_probe.py): thread 0 of
// each ffn block records %globaltimer (ns) at the kernel's phase boundaries.
constexpr int kTimelineBlocks = 8192, kTimelineMarks = 8;
__device__ unsigned long long g_ffn_timeline[kTimelineBlocks * kTimelineMarks];
#define FFN_MARK(i)                                                                    \
  do {                                                                                 \
    const int blk = blockIdx.y * gridDim.x + blockIdx.x;                               \
    if (threadIdx.x == 0 && blk < kTimelineBlocks) {                                   \
      unsigned long long t;                                                            \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));                            \
      g_ffn_timeline[blk * kTimelineMarks + (i)] = t;                                  \
    }                                                                                  \
  } while (0)
#else
#define FFN_MARK(i) \
  do {              \
  } while (0)
#endif

namespace {

using bf16 = __nv_bfloat16;
namespace cg = cooperative_groups;

constexpr int kMaxD = 256;

bool bad_shape(int r, int d) { return r <= 0 || d <= 0 || d % 16 != 0 || d > kMaxD; }

// ------------------------------------------------------- shared machinery
//
// Shared-memory images. A wgmma operand is read K-major without swizzle
// (descriptor layout type 0): the matrix is cut into core matrices of 8 rows
// by 8 bf16 (16 bytes), each stored as 128 contiguous bytes (row i of the core
// at byte 16 i); core (i, j), rows 8i.. and K columns 8j.., sits at byte
// 128 (i * K / 8 + j). So the leading byte offset (the next core along K) is
// 128 and the stride byte offset (the next 8 rows) is 16 K; one k16 step
// advances the start address by 256 bytes. ops/decode.py::pack_generator and
// pack_ffn write the weights in this layout, chunk by chunk, and the kernels
// write the x tile in it.

constexpr int kThreads = 128;      // one warpgroup: it issues the copies and the wgmma
constexpr int kRows = 64;          // rows of x a block: the wgmma M
constexpr int kMaxStages = 4;
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kSmemLimit = 232448; // 227 KB of dynamic shared memory a block
constexpr int kHead = 128;         // the ring's mbarriers; the tiles start at byte 128

__host__ __device__ constexpr int x_bytes(int dp) { return kRows * dp * 2; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor, no swizzle: start address, leading byte
// offset and stride byte offset, each in 16-byte units; base offset 0.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits for the completion of the barrier's phase of parity `parity`. A
// phase that never completes traps after about 2 s (2^32 cycles) instead of
// hanging the device.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 32)) __trap();
  }
}

// One contiguous global -> shared copy of `bytes`, completed on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The address of shared::cta address `addr` in cluster block `rank`'s
// shared memory, and 8-byte stores there.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float lo, float hi) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};" ::"r"(addr), "f"(lo), "f"(hi)
               : "memory");
}
__device__ __forceinline__ void st_cluster(uint32_t addr, uint32_t lo, uint32_t hi) {
  asm volatile("st.shared::cluster.v2.b32 [%0], {%1, %2};" ::"r"(addr), "r"(lo), "r"(hi)
               : "memory");
}
// 16 bytes global -> shared; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// Rows [row0, row0 + 64) of x (r, d) into the core-matrix layout at xs
// (64 x kDp), zero past r and d: 16-byte vector (m, kc) to core (m / 8, kc),
// row m % 8. Waits for the copies and makes them visible to wgmma.
template <int kDp>
__device__ __forceinline__ void load_x_tile(const bf16* __restrict__ x, int r, int d, int row0,
                                            unsigned char* xs) {
  constexpr int kVecs = kDp / 8;
  const uint32_t xa = smem_addr(xs);
  for (int v = threadIdx.x; v < kRows * kVecs; v += kThreads) {
    const int m = v / kVecs, kc = v % kVecs;
    const bool in = row0 + m < r && kc * 8 < d;
    const bf16* src = in ? x + static_cast<long long>(row0 + m) * d + kc * 8 : x;
    cp_async16(xa + ((m >> 3) * kVecs + kc) * 128 + (m & 7) * 16, src, in ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
  // generic-proxy writes, read next by wgmma through the async proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Waits until at most N committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving the definitions and uses of accumulator
// registers across the asm that brackets an asynchronous wgmma: placed before
// wgmma.fence and after wgmma.wait_group, it keeps every non-wgmma write to
// them (such as zeroing) out of the span where a wgmma owns them, which ptxas
// would otherwise answer by serializing the wgmma (C7513 / C7515).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SPACAP_ACC8(d, i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define SPACAP_ACC32(d) SPACAP_ACC8(d, 0), SPACAP_ACC8(d, 8), SPACAP_ACC8(d, 16), SPACAP_ACC8(d, 24)
#define SPACAP_ACC64(d)                                                                  \
  SPACAP_ACC32(d), SPACAP_ACC8(d, 32), SPACAP_ACC8(d, 40), SPACAP_ACC8(d, 48),          \
      SPACAP_ACC8(d, 56)

#define SPACAP_D32                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define SPACAP_D64                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "      \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, " \
  "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
  "%55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x N f32) = A (64 x 16) B (16 x N) + (scale_d ? d : 0), A and B bf16
// in shared memory (K-major descriptors), N = 64 or 128. Thread t of the
// warpgroup holds d[4j + q] at row 16 (t / 32) + (t % 32) / 4 + 8 (q / 2),
// column 8 j + 2 (t % 4) + q % 2.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SPACAP_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SPACAP_ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SPACAP_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : SPACAP_ACC64(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// Issues (one wgmma group) acc (64 x N) = x tile (64 x kDp) . chunk
// (N x kDp)^T, both K-major images in shared memory.
template <int kDp, int N>
__device__ __forceinline__ void issue_chunk(float (&acc)[N / 2], uint32_t xa, uint32_t wa) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < kDp / 16; ++k)
    wgmma_ss(acc, desc(xa + 256 * k, 128, 16 * kDp), desc(wa + 256 * k, 128, 16 * kDp), k);
  wgmma_commit();
}

// The launch of a kernel whose grid is `cluster` blocks along x (the cluster)
// by one 64-row tile of x along y.
cudaLaunchConfig_t launch_config(int r, int bytes, int cluster, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster), static_cast<unsigned>((r + kRows - 1) / kRows), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// -------------------------------------------------------------- generator
namespace gen {

constexpr int kChunk = 128;   // vocab columns a chunk: the wgmma N
constexpr int kNone = 0x7fffffff;   // the index of a candidate that never wins

// (value, index) order of the argmax: a larger value wins, an equal value with
// a lower index wins (torch.argmax / jnp.argmax: the first maximum).
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// one chunk of the packed image: W rows (kChunk x dp), then their kChunk
// biases in f32
__host__ __device__ constexpr int w_bytes(int dp) { return kChunk * dp * 2; }
__host__ __device__ constexpr int stage_bytes(int dp) { return w_bytes(dp) + kChunk * 4; }

// The launch's shared memory: mbarriers, the x tile, the ring, and rank 0's
// (value, index) slots, one a row and rank. As many stages as fit, up to 4,
// and no more than the chunks a block takes (at least 2 wherever it takes 2
// or more, as the pipeline needs: 2 stages fit at every d).
int smem_bytes(int nt, int chunks, int cluster, int* stages) {
  const int dp = 64 * nt, per_rank = (chunks + cluster - 1) / cluster;
  const int fixed = kHead + x_bytes(dp) + cluster * kRows * 8;
  int s = (kSmemLimit - fixed) / stage_bytes(dp);
  s = s < kMaxStages ? s : kMaxStages;
  s = s < per_rank ? s : per_rank;
  *stages = s > 1 ? s : 1;
  return fixed + *stages * stage_bytes(dp);
}

// This thread's (value, index) scan over its columns of one chunk, whose
// accumulator `acc` is complete: + the chunk's f32 bias, columns >= vocab
// masked by index (kMask: the chunk is ragged), then a pairwise tree over
// the row's kChunk / 4 columns, in which a right (higher) column replaces a left
// one only if strictly larger: the first maximum, in log2(kChunk / 4) dependent
// steps. The thread's chunks come in increasing order, so a strictly
// larger chunk maximum is the only one that replaces its running best.
template <bool kMask>
__device__ __forceinline__ void scan_chunk(const float (&acc)[kChunk / 2], const float* bias,
                                           int col, int vocab, int quad, float (&best)[2],
                                           int (&idx)[2]) {
  constexpr int kCols = kChunk / 4;   // a row's columns in this thread: 8 j + q, q < 2
  float2 b[kChunk / 8];
#pragma unroll
  for (int j = 0; j < kChunk / 8; ++j) b[j] = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * quad);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v[kCols];
    int c[kCols];
#pragma unroll
    for (int p = 0; p < kCols; ++p) {
      const int j = p / 2, q = p % 2;
      v[p] = acc[4 * j + 2 * h + q] + (q ? b[j].y : b[j].x);
      if (kMask && col + 8 * j + q >= vocab) v[p] = -CUDART_INF_F;
      c[p] = 8 * j + q;
    }
#pragma unroll
    for (int w = 1; w < kCols; w *= 2)
#pragma unroll
      for (int p = 0; p + w < kCols; p += 2 * w)
        if (v[p + w] > v[p]) {
          v[p] = v[p + w];
          c[p] = c[p + w];
        }
    if (v[0] > best[h]) {
      best[h] = v[0];
      idx[h] = col + c[0];
    }
  }
}

// Replaces spacap3d_tpu/ops/decode_pallas.py::generator_argmax
// (_gen_argmax_kernel, :57): out[i] = argmax_j (x[i] . w[j] + b[j]) over
// j < vocab, f32 accumulation, the bias added in f32 after the product, first
// maximum on ties; the (r, vocab) logits never reach device memory.
//
// Bound on the H100: operations. 2 r d vocab flops (2.37 GFLOP at r 2048,
// d 128, vocab 4528) are 2.4 us at the 989 TFLOP/s bf16 tensor-core rate; the
// bytes (x, w, b once, the indices) are 1.7 MB, 0.5 us at 3.35 TB/s. What
// holds it back (PERF.md, an H100 at 700 W): a chunk costs ~0.7 us against
// 0.28 us of wgmma at the peak rate (why is open: its 33 KB copy, its wgmma
// and its scan seem to overlap poorly within an SM), and ~6 us a call are
// fixed (first copies, cluster barriers, launch); each 64-row tile reads all
// of w from L2.
//
// Design. The first version (64 blocks of 32 rows, wmma fragments loaded
// from global memory, the logits staged through shared memory as f32 behind
// two block barriers a tile) filled half the SMs, read w from L2 in the
// (out, in) layout into every block, and missed the wgmma rate. Here:
// - A block is one warpgroup and takes 64 rows (the wgmma M) and one
//   contiguous range of vocab chunks; the S blocks of a thread-block cluster
//   split the vocab (the wrapper picks the largest S whose clusters all run
//   in one wave).
// - The x tile (64 x d_pad) is loaded once with cp.async, zero past r and d,
//   into the core-matrix layout.
// - Weights: pack_generator laid w out once per decode, chunk by chunk of
//   kChunk = 128 vocab columns, as this kernel's shared-memory image with the chunk's
//   biases in f32, so a chunk is one contiguous cp.async.bulk copy into a
//   ring of 2-4 stages, completed on an mbarrier; the next copies are in
//   flight while a chunk is multiplied.
// - Logits: wgmma m64n128k16 over d_pad / 16 k steps, both operands in shared
//   memory, into one of two accumulator sets in turn: chunk c + 1's group is
//   issued before chunk c's epilogue, so the tensor cores run while the
//   warps scan.
// - Epilogue on the accumulator registers: + bias, columns >= vocab masked
//   by index, a pairwise tree over each of the thread's two rows (shorter
//   dependent chains than a running scan) into a running (value, index); at
//   the end the 4 lanes of a row merge with two shuffles.
// - 128 columns a chunk: 64 (71 chunks, two blocks an SM, S = 7) took the
//   same time on the card (PERF.md, PR 6), and 256 cannot keep two
//   accumulator sets of 128 registers a thread.
// - Merge: each rank stores its 64 (value, index) pairs into rank 0's slots
//   (st.shared::cluster); after one cluster barrier rank 0 merges them in rank
//   order by (value, then lower index), a total order, and writes the rows
//   below r. No atomics: the same bits on every run. A rank that owns no chunk
//   stores (-inf, kNone), which loses to every real column.
template <int NT>  // d_pad = 64 NT
__global__ void __launch_bounds__(kThreads, 1)
gen_argmax_kernel(const bf16* __restrict__ x, const unsigned char* __restrict__ image, int r, int d,
                  int vocab, int chunks, int stages, long long* __restrict__ out) {
  constexpr int kDp = 64 * NT;
  constexpr int kStage = stage_bytes(kDp);
  constexpr int kW = w_bytes(kDp);
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bars = smem_addr(smem);   // mbarrier s at bars + 8 s
  unsigned char* xs = smem + kHead;
  unsigned char* ring = xs + x_bytes(kDp);
  float2* slots = reinterpret_cast<float2*>(ring + stages * kStage);   // [rank][row]

  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = blockIdx.y * kRows;
  const int c0 = rank * chunks / n_ranks;
  const int n = (rank + 1) * chunks / n_ranks - c0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // this block has started: its peers may store into it once they wait on this
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  __syncthreads();
  if (tid == 0) {
    for (int c = 0; c < n && c < stages; ++c) {
      mbar_expect_tx(bars + 8 * c, kStage);
      bulk_copy(smem_addr(ring + c * kStage), image + static_cast<long long>(c0 + c) * kStage,
                kStage, bars + 8 * c);
    }
  }
  load_x_tile<kDp>(x, r, d, row0, xs);
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, quad = lane & 3;
  const uint32_t xa = smem_addr(xs), ring_a = smem_addr(ring);
  float acc0[kChunk / 2], acc1[kChunk / 2];
#pragma unroll
  for (int i = 0; i < kChunk / 2; ++i) acc0[i] = acc1[i] = 0.0f;
  fence_regs(acc0);   // zeroed before any wgmma is in flight
  fence_regs(acc1);
  float best[2] = {-CUDART_INF_F, -CUDART_INF_F};
  int idx[2] = {kNone, kNone};

  // chunk c's group, once its stage has landed
  auto issue = [&](float(&acc)[kChunk / 2], int c) {
    const int st = c % stages;
    mbar_wait(bars + 8 * st, (c / stages) & 1);
    issue_chunk<kDp, kChunk>(acc, xa, ring_a + st * kStage);
  };
  // chunk c's group is complete: its scan, then its stage takes chunk c + stages
  auto finish = [&](float(&acc)[kChunk / 2], int c) {
    fence_regs(acc);
    const int st = c % stages, col0 = (c0 + c) * kChunk;
    const float* bias = reinterpret_cast<const float*>(ring + st * kStage + kW);
    if (col0 + kChunk <= vocab)
      scan_chunk<false>(acc, bias, col0 + 2 * quad, vocab, quad, best, idx);
    else
      scan_chunk<true>(acc, bias, col0 + 2 * quad, vocab, quad, best, idx);
    __syncthreads();   // every thread has read the stage's biases
    if (tid == 0 && c + stages < n) {
      mbar_expect_tx(bars + 8 * st, kStage);
      bulk_copy(ring_a + st * kStage, image + static_cast<long long>(c0 + c + stages) * kStage,
                kStage, bars + 8 * st);
    }
  };

  // chunk c + 1's group runs while chunk c is scanned
  if (n > 0) issue(acc0, 0);
  for (int c = 0; c < n; c += 2) {
    if (c + 1 < n) {
      issue(acc1, c + 1);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    finish(acc0, c);
    if (c + 1 < n) {
      if (c + 2 < n) {
        issue(acc0, c + 2);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      finish(acc1, c + 1);
    }
  }
  wgmma_wait<0>();   // none is pending: tells ptxas, which reuses the registers

  // the 4 lanes of a row hold its columns 2 quad.. of every 8
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best[h], off);
      const int oi = __shfl_xor_sync(0xffffffffu, idx[h], off);
      if (better(ov, oi, best[h], idx[h])) {
        best[h] = ov;
        idx[h] = oi;
      }
    }
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");   // every block has started
  if (quad == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * warp + (lane >> 2) + 8 * h;
      st_cluster(map_rank(smem_addr(slots + rank * kRows + m), 0), __float_as_uint(best[h]),
                 static_cast<uint32_t>(idx[h]));
    }
  }
  cluster.sync();   // every rank's pairs have landed in rank 0
  if (rank != 0 || tid >= kRows || row0 + tid >= r) return;
  float2 p = slots[tid];
  float bv = p.x;
  int bi = __float_as_int(p.y);
  for (int q = 1; q < n_ranks; ++q) {
    p = slots[q * kRows + tid];
    if (better(p.x, __float_as_int(p.y), bv, bi)) {
      bv = p.x;
      bi = __float_as_int(p.y);
    }
  }
  out[row0 + tid] = bi == kNone ? 0 : bi;   // every logit -inf: the first column
}

template <int NT>
cudaError_t allow_smem() {
  static PerDevice guard;
  return guard([] {
    return cudaFuncSetAttribute(gen_argmax_kernel<NT>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  });
}

template <int NT>
cudaError_t launch(const bf16* x, const unsigned char* image, int r, int d, int vocab, int chunks,
                   int cluster, long long* out, cudaStream_t stream) {
  cudaError_t err = allow_smem<NT>();
  if (err != cudaSuccess) return err;
  int stages = 0;
  const int bytes = smem_bytes(NT, chunks, cluster, &stages);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(r, bytes, cluster, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, gen_argmax_kernel<NT>, x, image, r, d, vocab, chunks, stages, out);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int NT>
cudaError_t max_clusters(int bytes, int cluster, int* count) {
  const cudaError_t err = allow_smem<NT>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(kRows, bytes, cluster, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(count, gen_argmax_kernel<NT>, &cfg);
}

bool bad_args(int r, int d, int vocab, int chunks, int cluster) {
  return bad_shape(r, d) || vocab <= 0 || chunks != (vocab + kChunk - 1) / kChunk ||
         cluster < 1 || cluster > kMaxCluster;
}

}  // namespace gen

namespace ffn {

constexpr int kChunk = 64;         // d_ff columns a chunk: the first product's wgmma N

// one chunk of the packed image: W1 rows (kChunk x dp), W2 columns (dp x kChunk),
// then b1 (kChunk f32)
__host__ __device__ constexpr int w_bytes(int dp) { return kChunk * dp * 2; }
__host__ __device__ constexpr int stage_bytes(int dp) { return 2 * w_bytes(dp) + kChunk * 4; }
__host__ __device__ constexpr int part_ld(int dp) { return dp + 8; }   // f32 row: 8 banks apart row to row
// rows of the 64-row tile that each of `cluster` blocks reduces, at most
__host__ __device__ constexpr int share_rows(int cluster) { return (kRows + cluster - 1) / cluster; }
// the slots a block receives the cluster's partials of its rows in
__host__ __device__ constexpr int slot_bytes(int dp, int cluster) {
  return cluster * share_rows(cluster) * part_ld(dp) * 4;
}

// The launch's shared memory: mbarriers, the x tile, the ring, and the slots
// of the reduction. The slots lie apart from the ring where that leaves room
// for 3 stages (or for all the chunks a block takes), so that a block may
// receive partials while its peers still multiply; else they reuse the ring
// after a cluster barrier. As many stages as fit, up to 4, and no more than
// the chunks a block takes: so at least 2 wherever it takes 2 or more, as the
// pipeline needs.
int smem_bytes(int nt, int chunks, int cluster, int* stages, int* apart) {
  const int dp = 64 * nt, per_rank = (chunks + cluster - 1) / cluster;
  const int fixed = kHead + x_bytes(dp), slots = slot_bytes(dp, cluster);
  const int cap = per_rank < kMaxStages ? per_rank : kMaxStages;
  int s = (kSmemLimit - fixed - slots) / stage_bytes(dp);
  s = s < cap ? s : cap;
  if (s >= (cap < 3 ? cap : 3)) {
    *stages = s;
    *apart = 1;
    return fixed + s * stage_bytes(dp) + slots;
  }
  s = (kSmemLimit - fixed) / stage_bytes(dp);
  s = s < cap ? s : cap;
  s = s > 1 ? s : 1;
  *stages = s;
  *apart = 0;
  const int ring = s * stage_bytes(dp);
  return fixed + (ring > slots ? ring : slots);
}

// d += A (64 x 16, bf16 pairs in registers) B (16 x 64, shared memory). Thread
// t holds a[0] = A[g][2c..2c+1], a[1] = A[g+8][2c..], a[2] = A[g][8+2c..],
// a[3] = A[g+8][8+2c..] with g = 16 (t / 32) + (t % 32) / 4 and c = t % 4:
// the accumulator layout above, two 8-column blocks a k16 step.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SPACAP_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : SPACAP_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t relu_pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(fmaxf(lo, 0.0f), fmaxf(hi, 0.0f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// + b1 (f32, in the stage), relu, bf16: the accumulator's 8-column block j
// becomes half of the A fragment of k16 step j / 2.
__device__ __forceinline__ void hidden_to_a(const float (&h)[32], const float* b1, int quad,
                                            uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(b1 + 8 * j + 2 * quad);
    a[j >> 1][(j & 1) * 2] = relu_pack(h[4 * j] + b.x, h[4 * j + 1] + b.y);
    a[j >> 1][(j & 1) * 2 + 1] = relu_pack(h[4 * j + 2] + b.x, h[4 * j + 3] + b.y);
  }
}

// Issues (one wgmma group) out (64 x dp) += hidden chunk (64 x 64, A in
// registers) . W2 chunk (dp x 64)^T, the W2 image at wa.
template <int NT>
__device__ __forceinline__ void issue_out(float (&acc)[NT][32], const uint32_t (&a)[4][4],
                                          uint32_t wa) {
#pragma unroll
  for (int t = 0; t < NT; ++t) fence_regs(acc[t]);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int t = 0; t < NT; ++t)
      wgmma_rs(acc[t], a[k], desc(wa + t * 64 * kChunk * 2 + 256 * k, 128, 16 * kChunk));
  wgmma_commit();
}

// Replaces spacap3d_tpu/ops/decode_pallas.py::ffn (_ffn_kernel, :127):
// out = bf16(bf16(relu(x @ w1^T + b1)) @ w2^T + b2), f32 accumulation, b1
// added in f32 after the product, the hidden rounded to bf16 (round to nearest
// even) before the second product, the output rounded once; the (r, d_ff)
// hidden never reaches device memory.
//
// Bound on the H100: operations. 4 r d d_ff flops (2.15 GFLOP at r 2048,
// d 128, d_ff 2048) are 2.17 us at 989 TFLOP/s bf16; x, the weights and the
// output are 2.1 MB, 0.6 us at 3.35 TB/s. What holds it back is latency: each
// chunk is a chain of dependent wgmma and a wait, and each launch pays for its
// first copies and its cluster barrier. (Every 64-row tile reads all the
// weights from L2, 32 MB at r 2048; that costs about 6% on the card.)
//
// Design. A block is one warpgroup and takes 64 rows (the wgmma M) and one
// slice of d_ff; the S blocks of a thread-block cluster split d_ff (S = 3 at
// r 2048: 96 blocks, the most that the card holds in one wave).
// - The x tile (64 x d_pad) is loaded once with cp.async, zero past r and d,
//   into the core-matrix layout.
// - Weights: pack_ffn laid W1 and W2 out once per decode, chunk by chunk of 64
//   d_ff columns, as this kernel's shared-memory image (with b1 in f32), so a
//   chunk is one contiguous cp.async.bulk copy into a ring of 1-4 stages,
//   completed on an mbarrier; the copies of the next stages are in flight
//   while a chunk is multiplied. No tensor map is encoded per call.
// - Hidden chunk: wgmma m64n64k16 over d_pad / 16 k steps (A = the x tile,
//   B = the W1 chunk, both in shared memory). + b1, relu and bf16 rounding run
//   on the accumulator registers, whose layout is the A-operand layout of the
//   next product: the hidden never leaves registers.
// - Output: wgmma m64n64k16 with A in registers (4 k steps) for each 64-column
//   tile of d_pad, accumulated in registers across the block's chunks.
// - Pipeline: the wgmma groups go in the order hidden(c + 1), out(c), so the
//   tensor cores run out(c) while the warps turn hidden(c + 1) into A
//   fragments (two buffers in turn); a stage is refilled once out(c) is done,
//   behind one block barrier a chunk.
// - Reduction: block s of the cluster owns rows [64 s / S, 64 (s + 1) / S) of
//   the tile. Each block stores its f32 partial rows from registers into
//   their owner's slots (slot = its rank; st.shared::cluster to the other
//   blocks); after one cluster barrier each owner sums the S partials of its
//   rows in rank order from its own shared memory, adds b2, rounds once and
//   stores the rows below r. No atomics: the same bits on every run. The slots
//   lie apart from the ring where they fit (d_pad <= 192), so a block pushes
//   while its peers still multiply; else a cluster barrier first waits until
//   every ring of the cluster is free.
//
// Partial mode (kPartial; ffn_partial_kernel), for tensor parallelism: the
// weights are one rank's slice of d_ff, and the owner block stores the sum
// of the S partials of its rows in f32, without b2 and without rounding; the
// caller sums the ranks' partials, adds b2 and rounds once. Only the
// epilogue differs. Bound at r 2048, d 128: operations, 4 r d d_ff flops over
// 989 TFLOP/s, 1.09 us at a slice of 1024 (tp 2) and 0.54 us at 512 (tp 4),
// against 2.1 and 1.8 MB (x, the slice, the f32 output) over 3.35 TB/s, 0.63
// and 0.55 us.
template <int NT, bool kPartial>  // 64-column output tiles: d_pad = 64 NT
__device__ __forceinline__ void ffn_tile(const bf16* __restrict__ x,
                                         const unsigned char* __restrict__ image,
                                         const float* __restrict__ b2, int r, int d, int chunks,
                                         int stages, int apart, void* __restrict__ out) {
  constexpr int kDp = 64 * NT;
  constexpr int kStage = stage_bytes(kDp);
  constexpr int kW = w_bytes(kDp);
  constexpr int kLd = part_ld(kDp);
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bars = smem_addr(smem);   // mbarrier s at bars + 8 s
  unsigned char* xs = smem + kHead;
  unsigned char* ring = xs + x_bytes(kDp);
  float* slots = reinterpret_cast<float*>(ring + (apart ? stages * kStage : 0));

  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = blockIdx.y * kRows;
  const int c0 = rank * chunks / n_ranks;
  const int n = (rank + 1) * chunks / n_ranks - c0;
  const int tid = threadIdx.x;
  // the four output columns this thread stores; b2 read early, off the tail
  const int v4 = d / 4, col = (tid % v4) * 4;
  float4 bb = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if constexpr (!kPartial) bb = *reinterpret_cast<const float4*>(b2 + col);

  FFN_MARK(0);   // start
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // this block has started: its peers may store into it once they wait on this
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  __syncthreads();
  FFN_MARK(1);   // mbarriers ready
  if (tid == 0) {
    for (int c = 0; c < n && c < stages; ++c) {
      mbar_expect_tx(bars + 8 * c, kStage);
      bulk_copy(smem_addr(ring + c * kStage), image + static_cast<long long>(c0 + c) * kStage,
                kStage, bars + 8 * c);
    }
  }
  load_x_tile<kDp>(x, r, d, row0, xs);
  __syncthreads();
  FFN_MARK(2);   // x tile loaded

  const int warp = tid >> 5, lane = tid & 31, quad = lane & 3;
  const uint32_t xa = smem_addr(xs), ring_a = smem_addr(ring);
  float acc[NT][32];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[t][i] = 0.0f;
  float h[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) h[i] = 0.0f;
#pragma unroll
  for (int t = 0; t < NT; ++t) fence_regs(acc[t]);   // zeroed before any wgmma is in flight
  fence_regs(h);
  uint32_t a0[4][4], a1[4][4];   // A fragments of two chunks in turn

  // Chunk c, with the wgmma groups committed in the order hidden(c + 1),
  // out(c): hidden(c) is complete at the top of step c while out(c - 1) may
  // still run under the epilogue, which writes the other A buffer.
  auto step = [&](int c, uint32_t(&a)[4][4]) {
    const int st = c % stages;
    wgmma_wait<1>();
    fence_regs(h);
    hidden_to_a(h, reinterpret_cast<const float*>(ring + st * kStage + 2 * kW), quad, a);
    wgmma_wait<0>();   // out(c - 1) is done: chunk c - 1's stage is free
    __syncthreads();
    if (tid == 0 && c >= 1 && c - 1 + stages < n) {
      const int free = (c - 1) % stages;
      mbar_expect_tx(bars + 8 * free, kStage);
      bulk_copy(ring_a + free * kStage, image + static_cast<long long>(c0 + c - 1 + stages) * kStage,
                kStage, bars + 8 * free);
    }
    if (c + 1 < n) {
      const int nx = (c + 1) % stages;
      mbar_wait(bars + 8 * nx, ((c + 1) / stages) & 1);
      issue_chunk<kDp, kChunk>(h, xa, ring_a + nx * kStage);
    }
    issue_out<NT>(acc, a, ring_a + st * kStage + kW);
  };

  if (n > 0) {
    mbar_wait(bars, 0);
    FFN_MARK(3);   // first chunk landed
    issue_chunk<kDp, kChunk>(h, xa, ring_a);
    wgmma_commit();   // an empty group in out(-1)'s place
  }
  for (int c = 0; c < n; c += 2) {
    step(c, a0);
    if (c + 1 < n) step(c + 1, a1);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int t = 0; t < NT; ++t) fence_regs(acc[t]);

  FFN_MARK(4);   // chunks done

  // each partial row into its owner's slot `rank`
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");   // every block has started
  if (!apart) cluster.sync();   // the slots reuse the rings: every ring of the cluster is free
  const int cap = share_rows(n_ranks);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = 16 * warp + (lane >> 2) + 8 * half;
    int owner = 0;
    while ((owner + 1) * kRows / n_ranks <= m) ++owner;
    float* row = slots + (rank * cap + m - owner * kRows / n_ranks) * kLd;
    if (owner == rank) {
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(row + 64 * t + 8 * j + 2 * quad) =
              make_float2(acc[t][4 * j + 2 * half], acc[t][4 * j + 2 * half + 1]);
    } else {
      const uint32_t dst = map_rank(smem_addr(row), owner);
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          st_cluster(dst + 4 * (64 * t + 8 * j + 2 * quad), acc[t][4 * j + 2 * half],
                     acc[t][4 * j + 2 * half + 1]);
    }
  }
  FFN_MARK(5);   // partials stored
  cluster.sync();   // every partial has landed; from here on only local memory
  FFN_MARK(6);   // cluster barrier passed

  // rows [ra, ra + rows) of the tile: the S slots summed in rank order
  const int ra = rank * kRows / n_ranks, rows = (rank + 1) * kRows / n_ranks - ra;
  const int row_step = kThreads / v4;
  if (tid >= row_step * v4) return;
  for (int m = tid / v4; m < rows; m += row_step) {
    const float* p = slots + m * kLd + col;
    float4 sum = *reinterpret_cast<const float4*>(p);
    for (int q = 1; q < n_ranks; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(p + q * cap * kLd);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    if (row0 + ra + m >= r) continue;
    const long long at = static_cast<long long>(row0 + ra + m) * d + col;
    if constexpr (kPartial) {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + at) = sum;
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(sum.x + bb.x, sum.y + bb.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(sum.z + bb.z, sum.w + bb.w);
      *reinterpret_cast<uint2*>(static_cast<bf16*>(out) + at) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
    }
  }
  FFN_MARK(7);   // rows stored
}

// out (r, d) bf16 = the whole FFN
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
ffn_kernel(const bf16* __restrict__ x, const unsigned char* __restrict__ image,
           const float* __restrict__ b2, int r, int d, int chunks, int stages, int apart,
           bf16* __restrict__ out) {
  ffn_tile<NT, false>(x, image, b2, r, d, chunks, stages, apart, out);
}

// out (r, d) f32 = this d_ff slice's partial sum, before b2 and rounding (b2
// is not read)
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
ffn_partial_kernel(const bf16* __restrict__ x, const unsigned char* __restrict__ image,
                   const float* __restrict__ b2, int r, int d, int chunks, int stages, int apart,
                   float* __restrict__ out) {
  ffn_tile<NT, true>(x, image, b2, r, d, chunks, stages, apart, out);
}

template <int NT, bool kPartial>
auto kernel() {
  if constexpr (kPartial) {
    return ffn_partial_kernel<NT>;
  } else {
    return ffn_kernel<NT>;
  }
}

// The shared-memory opt-in, once per device and instantiation, not every call.
template <int NT, bool kPartial>
cudaError_t allow_smem() {
  static PerDevice guard;
  return guard([] {
    return cudaFuncSetAttribute(kernel<NT, kPartial>(),
                                cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  });
}

template <int NT, bool kPartial, typename Out>
cudaError_t launch(const bf16* x, const unsigned char* image, const float* b2, int r, int d,
                   int chunks, int cluster, Out* out, cudaStream_t stream) {
  cudaError_t err = allow_smem<NT, kPartial>();
  if (err != cudaSuccess) return err;
  int stages = 0, apart = 0;
  const int bytes = smem_bytes(NT, chunks, cluster, &stages, &apart);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(r, bytes, cluster, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel<NT, kPartial>(), x, image, b2, r, d, chunks, stages,
                           apart, out);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int NT, bool kPartial>
cudaError_t max_clusters(int bytes, int cluster, int* count) {
  const cudaError_t err = allow_smem<NT, kPartial>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(kRows, bytes, cluster, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(count, kernel<NT, kPartial>(), &cfg);
}

bool bad_args(int r, int d, int chunks, int cluster) {
  return bad_shape(r, d) || chunks <= 0 || cluster < 1 || cluster > kMaxCluster;
}

// Either kernel at d_pad = d rounded up to 64.
template <bool kPartial, typename Out>
cudaError_t dispatch(const void* x, const void* image, const void* b2, int r, int d, int chunks,
                     int cluster, void* out, void* stream) {
  const auto* xp = static_cast<const bf16*>(x);
  const auto* ip = static_cast<const unsigned char*>(image);
  const auto* bp = static_cast<const float*>(b2);
  auto* op = static_cast<Out*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch ((d + 63) / 64) {
    case 1: return launch<1, kPartial>(xp, ip, bp, r, d, chunks, cluster, op, s);
    case 2: return launch<2, kPartial>(xp, ip, bp, r, d, chunks, cluster, op, s);
    case 3: return launch<3, kPartial>(xp, ip, bp, r, d, chunks, cluster, op, s);
    default: return launch<4, kPartial>(xp, ip, bp, r, d, chunks, cluster, op, s);
  }
}

template <bool kPartial>
cudaError_t launch_info(int d, int chunks, int cluster, int* stages, int* smem, int* clusters) {
  const int nt = (d + 63) / 64;
  int apart = 0;
  *smem = smem_bytes(nt, chunks, cluster, stages, &apart);
  switch (nt) {
    case 1: return max_clusters<1, kPartial>(*smem, cluster, clusters);
    case 2: return max_clusters<2, kPartial>(*smem, cluster, clusters);
    case 3: return max_clusters<3, kPartial>(*smem, cluster, clusters);
    default: return max_clusters<4, kPartial>(*smem, cluster, clusters);
  }
}

}  // namespace ffn

}  // namespace

// x (r, d) bf16 contiguous and 16-byte aligned; image: pack_generator's
// chunks (`chunks` = ceil(vocab / 128) of 128 vocab columns at d_pad = d
// rounded up to 64); `cluster` blocks (1-8) split the vocab -> out (r,)
// int64. Returns the cudaError_t of the launch.
extern "C" int spacap_generator_argmax(const void* x, const void* image, int r, int d, int vocab,
                                       int chunks, int cluster, long long* out, void* stream) {
  if (gen::bad_args(r, d, vocab, chunks, cluster)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xp = static_cast<const bf16*>(x);
  const auto* ip = static_cast<const unsigned char*>(image);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((d + 63) / 64) {
    case 1: err = gen::launch<1>(xp, ip, r, d, vocab, chunks, cluster, out, s); break;
    case 2: err = gen::launch<2>(xp, ip, r, d, vocab, chunks, cluster, out, s); break;
    case 3: err = gen::launch<3>(xp, ip, r, d, vocab, chunks, cluster, out, s); break;
    default: err = gen::launch<4>(xp, ip, r, d, vocab, chunks, cluster, out, s); break;
  }
  return static_cast<int>(err);
}

// The launch spacap_generator_argmax makes for (d, vocab, chunks, cluster):
// its ring stages, its dynamic shared memory in bytes, and how many of its
// clusters the device holds at once. Returns the cudaError_t.
extern "C" int spacap_generator_launch_info(int d, int vocab, int chunks, int cluster, int* stages,
                                            int* smem, int* clusters) {
  if (gen::bad_args(1, d, vocab, chunks, cluster)) return static_cast<int>(cudaErrorInvalidValue);
  const int nt = (d + 63) / 64;
  *smem = gen::smem_bytes(nt, chunks, cluster, stages);
  cudaError_t err;
  switch (nt) {
    case 1: err = gen::max_clusters<1>(*smem, cluster, clusters); break;
    case 2: err = gen::max_clusters<2>(*smem, cluster, clusters); break;
    case 3: err = gen::max_clusters<3>(*smem, cluster, clusters); break;
    default: err = gen::max_clusters<4>(*smem, cluster, clusters); break;
  }
  return static_cast<int>(err);
}

// x (r, d) bf16 contiguous and 16-byte aligned; image: pack_ffn's chunks
// (`chunks` of 64 d_ff columns at d_pad = d rounded up to 64); b2 (d_pad,) f32;
// `cluster` blocks (1-8) split d_ff -> out (r, d) bf16. Returns the cudaError_t.
extern "C" int spacap_ffn(const void* x, const void* image, const void* b2, int r, int d,
                          int chunks, int cluster, void* out, void* stream) {
  if (ffn::bad_args(r, d, chunks, cluster)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      ffn::dispatch<false, bf16>(x, image, b2, r, d, chunks, cluster, out, stream));
}

// As spacap_ffn on the chunks of one tensor-parallel rank's d_ff slice, with
// no b2: out (r, d) f32 = the slice's partial sum, unrounded, 16-byte aligned.
extern "C" int spacap_ffn_partial(const void* x, const void* image, int r, int d, int chunks,
                                  int cluster, void* out, void* stream) {
  if (ffn::bad_args(r, d, chunks, cluster)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      ffn::dispatch<true, float>(x, image, nullptr, r, d, chunks, cluster, out, stream));
}

// The launch spacap_ffn makes for (d, chunks, cluster): its ring stages, its
// dynamic shared memory in bytes, and how many of its clusters the device
// holds at once (cudaOccupancyMaxActiveClusters). Returns the cudaError_t.
extern "C" int spacap_ffn_launch_info(int d, int chunks, int cluster, int* stages, int* smem,
                                      int* clusters) {
  if (ffn::bad_args(1, d, chunks, cluster)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(ffn::launch_info<false>(d, chunks, cluster, stages, smem, clusters));
}

// The same for spacap_ffn_partial.
extern "C" int spacap_ffn_partial_launch_info(int d, int chunks, int cluster, int* stages,
                                              int* smem, int* clusters) {
  if (ffn::bad_args(1, d, chunks, cluster)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(ffn::launch_info<true>(d, chunks, cluster, stages, smem, clusters));
}

#ifdef SPACAP_FFN_TIMELINE
// Copies the first n marks (8 a block, block-major) of the last ffn launch.
extern "C" int spacap_ffn_timeline(unsigned long long* host, int n) {
  if (n > kTimelineBlocks * kTimelineMarks) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, g_ffn_timeline, sizeof(unsigned long long) * n));
}
#endif
