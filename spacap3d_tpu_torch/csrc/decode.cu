// Fused greedy-decode kernels on Hopper (sm_90a): the generator's argmax and
// the position-wise FFN, each one launch with its intermediate kept on chip.
//
// Both multiply bf16 operands on the tensor cores through nvcuda::wmma
// (16x16x16 fragments, f32 accumulators), read the weights in the port's
// (out, in) layout as column-major B fragments straight from global memory
// (L2 serves every block after the first), and stage the activation tile in
// shared memory. No library GEMM is called.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math_constants.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 32;               // rows of x per block: two 16-row fragments
constexpr int kTile = kWarps * 16;      // columns per tile: one 16-column fragment a warp
constexpr int kPad = 8;                 // bf16 row padding of the shared tiles
constexpr int kTileLd = kTile + 8;      // f32 staging row: 136 = 8 mod 32 banks
constexpr int kMaxD = 256;              // d <= 256: two output fragments a warp in ffn
constexpr int kMaxDFrags = kMaxD / 16 / kWarps;

// Rows [row0, row0 + kRows) of x (r, d) into shared memory (row stride d + kPad),
// zero past row r. d % 16 == 0 and x 16-byte aligned, so rows move as uint4.
__device__ __forceinline__ void load_x_tile(const bf16* __restrict__ x, int r, int d,
                                            int row0, bf16* xs) {
  const int vec_per_row = d / 8;
  for (int v = threadIdx.x; v < kRows * vec_per_row; v += kThreads) {
    const int rr = v / vec_per_row, cc = (v % vec_per_row) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + rr < r)
      val = *reinterpret_cast<const uint4*>(x + static_cast<long long>(row0 + rr) * d + cc);
    *reinterpret_cast<uint4*>(xs + rr * (d + kPad) + cc) = val;
  }
}

// (value, index) order of the argmax: a larger value wins, an equal value with
// a lower index wins (torch.argmax / jnp.argmax: the first maximum).
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Replaces spacap3d_tpu/ops/decode_pallas.py::generator_argmax (_gen_argmax_kernel):
// out[i] = argmax_j (x[i] . w[j] + b[j]) over j < vocab, f32 accumulation, the
// bias added in f32 after the product, first maximum on ties; the (r, vocab)
// logits never reach device memory.
//
// Bound on the H100: operations. 2 r d vocab flops (2.37 GFLOP at r 2048,
// d 128, vocab 4528) are 2.4 us at the 989 TFLOP/s bf16 tensor-core rate; the
// bytes (x, w, b once, the indices) are 1.7 MB, 0.5 us at 3.35 TB/s.
// Design: one block per 32 rows walks the vocab in 128-column tiles; each of
// 8 warps multiplies the shared x tile by one 16-column fragment of w, the
// tile's f32 logits go through shared memory, and each thread keeps a running
// (value, index) over a fixed column set of its row, compared lexicographically
// so that the visiting order cannot change the winner. Columns >= vocab are
// never candidates. Every block reads all of w from L2 (64 blocks at r 2048);
// the blocks fill half the SMs and issue wmma, not wgmma: both are for later.
__global__ void __launch_bounds__(kThreads)
gen_argmax_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const bf16* __restrict__ b, int r, int d, int vocab, long long* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);                                   // kRows x (d + kPad)
  float* ls = reinterpret_cast<float*>(smem + kRows * (d + kPad) * sizeof(bf16));  // kRows x kTileLd
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRows;
  load_x_tile(x, r, d, row0, xs);
  __syncthreads();

  // scan ownership: 8 threads a row, thread `part` takes columns part, part + 8, ...
  const int srow = threadIdx.x >> 3, part = threadIdx.x & 7;
  float best = -CUDART_INF_F;
  int best_idx = 0;
  for (int col0 = 0; col0 < vocab; col0 += kTile) {
    const int cb = col0 + warp * 16;
    if (cb < vocab) {  // w holds rows up to vocab rounded up to 16: the fragment is in bounds
      FragC acc[2];
      wmma::fill_fragment(acc[0], 0.0f);
      wmma::fill_fragment(acc[1], 0.0f);
      const bf16* wp = w + static_cast<long long>(cb) * d;
#pragma unroll 4
      for (int k = 0; k < d; k += 16) {
        FragB fb;
        wmma::load_matrix_sync(fb, wp + k, d);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          FragA fa;
          wmma::load_matrix_sync(fa, xs + i * 16 * (d + kPad) + k, d + kPad);
          wmma::mma_sync(acc[i], fa, fb, acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::store_matrix_sync(ls + i * 16 * kTileLd + warp * 16, acc[i], kTileLd,
                                wmma::mem_row_major);
    }
    __syncthreads();
    for (int c = part; c < kTile; c += 8) {
      const int col = col0 + c;
      if (col < vocab) {
        const float v = ls[srow * kTileLd + c] + __bfloat162float(b[col]);
        if (better(v, col, best, best_idx)) {
          best = v;
          best_idx = col;
        }
      }
    }
    __syncthreads();
  }
  // the 8 threads of a row are 8 neighbouring lanes
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, best_idx, off);
    if (better(ov, oi, best, best_idx)) {
      best = ov;
      best_idx = oi;
    }
  }
  if (part == 0 && row0 + srow < r) out[row0 + srow] = best_idx;
}

// Replaces spacap3d_tpu/ops/decode_pallas.py::ffn (_ffn_kernel):
// out = bf16(bf16(relu(x @ w1^T + b1)) @ w2^T + b2), f32 accumulation, the
// hidden rounded to bf16 (round to nearest even) before the second product,
// the output rounded once; the (r, d_ff) hidden never reaches device memory.
//
// Bound on the H100: operations. 4 r d d_ff flops (2.15 GFLOP at r 2048,
// d 128, d_ff 2048) are 2.2 us at 989 TFLOP/s; x, the weights and the output
// are 2.1 MB, 0.6 us at 3.35 TB/s. Design: one block per 32 rows walks d_ff in
// 128-wide chunks. For each chunk the 8 warps compute the hidden chunk (one
// 16-column fragment each) from the shared x tile, add b1, apply relu and round
// it into a shared bf16 tile; then each warp accumulates its output fragments
// (d / 16 spread over the warps) from that tile, in registers across chunks.
// At the end the f32 output goes through shared memory for b2 and the store.
// As in gen_argmax_kernel, every block reads all weights from L2.
__global__ void __launch_bounds__(kThreads)
ffn_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1, const bf16* __restrict__ b1,
           const bf16* __restrict__ w2, const bf16* __restrict__ b2, int r, int d, int f,
           bf16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);                       // kRows x (d + kPad)
  bf16* hs = xs + kRows * (d + kPad);                             // kRows x (kTile + kPad)
  float* st = reinterpret_cast<float*>(hs + kRows * (kTile + kPad));  // f32 staging
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRows;
  load_x_tile(x, r, d, row0, xs);

  FragC acc_o[2][kMaxDFrags];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kMaxDFrags; ++j) wmma::fill_fragment(acc_o[i][j], 0.0f);
  __syncthreads();

  for (int f0 = 0; f0 < f; f0 += kTile) {
    const int chunk = min(kTile, f - f0);   // a multiple of 16
    const int hb = warp * 16;               // this warp's hidden columns in the chunk
    if (hb < chunk) {
      FragC acc[2];
      wmma::fill_fragment(acc[0], 0.0f);
      wmma::fill_fragment(acc[1], 0.0f);
      const bf16* wp = w1 + static_cast<long long>(f0 + hb) * d;
#pragma unroll 4
      for (int k = 0; k < d; k += 16) {
        FragB fb;
        wmma::load_matrix_sync(fb, wp + k, d);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          FragA fa;
          wmma::load_matrix_sync(fa, xs + i * 16 * (d + kPad) + k, d + kPad);
          wmma::mma_sync(acc[i], fa, fb, acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::store_matrix_sync(st + i * 16 * kTileLd + hb, acc[i], kTileLd, wmma::mem_row_major);
      __syncwarp();
      // this warp's 32 x 16 slice: + b1, relu, round to bf16
      for (int e = lane; e < kRows * 16; e += 32) {
        const int rr = e >> 4, cc = hb + (e & 15);
        const float v = st[rr * kTileLd + cc] + __bfloat162float(b1[f0 + cc]);
        hs[rr * (kTile + kPad) + cc] = __float2bfloat16_rn(fmaxf(v, 0.0f));
      }
    }
    __syncthreads();
    for (int k = 0; k < chunk; k += 16) {
#pragma unroll
      for (int j = 0; j < kMaxDFrags; ++j) {
        const int oc = (warp + j * kWarps) * 16;   // output columns of this fragment
        if (oc < d) {
          FragB fb;
          wmma::load_matrix_sync(fb, w2 + static_cast<long long>(oc) * f + f0 + k, f);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            FragA fa;
            wmma::load_matrix_sync(fa, hs + i * 16 * (kTile + kPad) + k, kTile + kPad);
            wmma::mma_sync(acc_o[i][j], fa, fb, acc_o[i][j]);
          }
        }
      }
    }
    __syncthreads();   // hs and st are rewritten by the next chunk
  }

  const int ld_o = d + kPad;
#pragma unroll
  for (int j = 0; j < kMaxDFrags; ++j) {
    const int oc = (warp + j * kWarps) * 16;
    if (oc < d) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::store_matrix_sync(st + i * 16 * ld_o + oc, acc_o[i][j], ld_o, wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kRows * d; e += kThreads) {
    const int rr = e / d, cc = e % d;
    if (row0 + rr < r)
      out[static_cast<long long>(row0 + rr) * d + cc] =
          __float2bfloat16_rn(st[rr * ld_o + cc] + __bfloat162float(b2[cc]));
  }
}

int shared_bytes_gen(int d) {
  return kRows * (d + kPad) * static_cast<int>(sizeof(bf16)) + kRows * kTileLd * 4;
}

int shared_bytes_ffn(int d) {
  const int staging = kRows * (d + kPad > kTileLd ? d + kPad : kTileLd) * 4;
  return kRows * (d + kPad) * static_cast<int>(sizeof(bf16)) +
         kRows * (kTile + kPad) * static_cast<int>(sizeof(bf16)) + staging;
}

template <typename Kernel>
cudaError_t set_shared(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

bool bad_shape(int r, int d) { return r <= 0 || d <= 0 || d % 16 != 0 || d > kMaxD; }

}  // namespace

// x (r, d) bf16, w (ceil16(vocab), d) bf16, b (>= vocab) bf16, all contiguous and
// 16-byte aligned -> out (r,) int64. Returns the cudaError_t of the launch.
extern "C" int spacap_generator_argmax(const void* x, const void* w, const void* b, int r, int d,
                                       int vocab, long long* out, void* stream) {
  if (bad_shape(r, d) || vocab <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = shared_bytes_gen(d);
  cudaError_t err = set_shared(gen_argmax_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((r + kRows - 1) / kRows);
  gen_argmax_kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(b), r, d,
      vocab, out);
  return static_cast<int>(cudaGetLastError());
}

// x (r, d), w1 (f, d), b1 (f,), w2 (d, f), b2 (d,) bf16, contiguous and 16-byte
// aligned, d and f multiples of 16 -> out (r, d) bf16. Returns the cudaError_t.
extern "C" int spacap_ffn(const void* x, const void* w1, const void* b1, const void* w2,
                          const void* b2, int r, int d, int f, void* out, void* stream) {
  if (bad_shape(r, d) || f <= 0 || f % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = shared_bytes_ffn(d);
  cudaError_t err = set_shared(ffn_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((r + kRows - 1) / kRows);
  ffn_kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(b2), r, d, f,
      static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}
