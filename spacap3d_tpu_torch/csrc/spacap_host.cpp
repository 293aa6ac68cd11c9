// spacap_host: the port's host-side C++ for the input pipeline and the
// detection eval.
//
// The port's own copy of the JAX package's host library
// (native/spacap_host.cpp), with the same entry points, arithmetic and op
// order, so that the two give equal results. It replaces the hot
// per-item numpy work of the reference's DataLoader workers
// (scripts/train.py:119): the 40k-point subsample and row gathers, the
// floor percentile, the per-instance vote targets, the point-in-box counts
// and the greedy NMS of the eval. The Python loader threads call it
// through ctypes, which releases the interpreter lock for each call.
// Randomness stays in numpy's RandomState (mt_permutation_head runs on its
// exported state), so items stay bit-identical to the numpy versions.
//
// Built at first use by spacap3d_tpu_torch/ops/_build.py::host_library
// (g++ -O3 -ffp-contract=off; no -march): the one multiply-add whose
// rounding matters, in percentile, is an explicit std::fma, so the result
// does not depend on the host CPU or on what the compiler contracts.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

// dst[i, :] = src[idx[i], :]
void gather_rows_f32(const float* src, const int64_t* idx, float* dst,
                     int64_t n_out, int64_t n_feat) {
  for (int64_t i = 0; i < n_out; ++i) {
    std::memcpy(dst + i * n_feat, src + idx[i] * n_feat,
                sizeof(float) * n_feat);
  }
}

void gather_rows_f64(const double* src, const int64_t* idx, double* dst,
                     int64_t n_out, int64_t n_feat) {
  for (int64_t i = 0; i < n_out; ++i) {
    std::memcpy(dst + i * n_feat, src + idx[i] * n_feat,
                sizeof(double) * n_feat);
  }
}

void gather_i64(const int64_t* src, const int64_t* idx, int64_t* dst,
                int64_t n_out) {
  for (int64_t i = 0; i < n_out; ++i) dst[i] = src[idx[i]];
}

// dst[i * dst_stride + j] = (float)src[idx[i] * src_stride + j], j < n_cols:
// the chosen rows of a column range, cast to float32, written into strided
// rows (the columns of a batch row); strides count elements. Only the
// chosen rows are read, and nothing is staged.
void gather_cols_f32_f32(const float* src, int64_t src_stride,
                         const int64_t* idx, float* dst, int64_t dst_stride,
                         int64_t n_out, int64_t n_cols) {
  for (int64_t i = 0; i < n_out; ++i) {
    std::memcpy(dst + i * dst_stride, src + idx[i] * src_stride,
                sizeof(float) * n_cols);
  }
}

void gather_cols_f64_f32(const double* src, int64_t src_stride,
                         const int64_t* idx, float* dst, int64_t dst_stride,
                         int64_t n_out, int64_t n_cols) {
  for (int64_t i = 0; i < n_out; ++i) {
    const double* s = src + idx[i] * src_stride;
    float* d = dst + i * dst_stride;
    for (int64_t j = 0; j < n_cols; ++j) d[j] = (float)s[j];
  }
}

// numpy-compatible linear-interpolation percentile of values[0..n)
double percentile(const double* values, int64_t n, double q) {
  std::vector<double> v(values, values + n);
  double pos = q / 100.0 * (double)(n - 1);
  int64_t lo = (int64_t)std::floor(pos);
  int64_t hi = std::min(lo + 1, n - 1);
  std::nth_element(v.begin(), v.begin() + lo, v.end());
  double vlo = v[lo];
  double vhi = vlo;
  if (hi != lo) {
    vhi = *std::min_element(v.begin() + lo + 1, v.end());
  }
  // One rounding: the JAX package's build (-march=native) contracts this
  // multiply-add into an FMA on a host that has one; std::fma gives that
  // value on every host.
  return std::fma(vhi - vlo, pos - (double)lo, vlo);
}

// GT vote targets (reference lib/dataset.py:421-430 semantics, SURVEY.md
// §2.4): for every point of a detection-class instance, vote = instance
// AABB center - point. The instance's class is the semantic label of its
// first point. valid_sem is a 41-slot 0/1 lookup of detection nyu40 ids.
void compute_votes(const double* xyz, const int64_t* ins, const int64_t* sem,
                   const uint8_t* valid_sem, int64_t n, double* votes /*n*9*/,
                   double* mask /*n*/) {
  std::unordered_map<int64_t, int64_t> first;  // instance -> slot
  std::vector<double> mins, maxs;
  std::vector<uint8_t> valid;
  std::vector<int64_t> slot_of(n);
  for (int64_t i = 0; i < n; ++i) {
    auto it = first.find(ins[i]);
    int64_t s;
    if (it == first.end()) {
      s = (int64_t)valid.size();
      first.emplace(ins[i], s);
      mins.insert(mins.end(), {xyz[i * 3], xyz[i * 3 + 1], xyz[i * 3 + 2]});
      maxs.insert(maxs.end(), {xyz[i * 3], xyz[i * 3 + 1], xyz[i * 3 + 2]});
      int64_t sl = sem[i];
      valid.push_back((sl >= 0 && sl <= 40) ? valid_sem[sl] : 0);
    } else {
      s = it->second;
      for (int d = 0; d < 3; ++d) {
        mins[s * 3 + d] = std::min(mins[s * 3 + d], xyz[i * 3 + d]);
        maxs[s * 3 + d] = std::max(maxs[s * 3 + d], xyz[i * 3 + d]);
      }
    }
    slot_of[i] = s;
  }
  for (int64_t i = 0; i < n; ++i) {
    int64_t s = slot_of[i];
    if (valid[s]) {
      mask[i] = 1.0;
      for (int d = 0; d < 3; ++d) {
        double c = 0.5 * (mins[s * 3 + d] + maxs[s * 3 + d]);
        double v = c - xyz[i * 3 + d];
        votes[i * 9 + d] = v;
        votes[i * 9 + 3 + d] = v;
        votes[i * 9 + 6 + d] = v;
      }
    } else {
      mask[i] = 0.0;
      for (int d = 0; d < 9; ++d) votes[i * 9 + d] = 0.0;
    }
  }
}

// Count of scene points inside each axis-aligned box (for eval's
// remove_empty_box, reference ap_helper.py:69-79). boxes given as
// (k, 6) [lo_xyz, hi_xyz]; counts out (k,). When cap > 0, counting a box
// stops at cap hits — the caller only tests counts >= 5, so the common
// dense box finishes after a few points instead of scanning all 40k.
static void points_in_boxes_range(const float* sx, const float* sy,
                                  const float* sz, const int64_t* offs,
                                  int64_t nb, float xmin, float inv,
                                  const double* boxes, int64_t b0, int64_t b1,
                                  int32_t cap, int32_t* counts) {
  auto bucket_of = [&](float x) {
    int64_t b = (int64_t)((x - xmin) * inv);
    return std::min<int64_t>(std::max<int64_t>(b, 0), nb - 1);
  };
  for (int64_t b = b0; b < b1; ++b) {
    const double* bx = boxes + b * 6;
    const float lox = (float)bx[0], loy = (float)bx[1], loz = (float)bx[2];
    const float hix = (float)bx[3], hiy = (float)bx[4], hiz = (float)bx[5];
    // points are bucketed by x: only buckets overlapping [lox, hix] can
    // hit (x re-tested below — bucket edges are coarse)
    const int64_t i0 = offs[bucket_of(lox)];
    const int64_t i1 = offs[bucket_of(hix) + 1];
    int32_t c = 0;
    for (int64_t i = i0; i < i1; ++i) {
      if (sx[i] >= lox && sx[i] <= hix && sy[i] >= loy && sy[i] <= hiy &&
          sz[i] >= loz && sz[i] <= hiz) {
        if (++c >= cap && cap > 0) break;
      }
    }
    counts[b] = c;
  }
}

void points_in_boxes(const float* pc /*n*3*/, int64_t n,
                     const double* boxes /*k*6*/, int64_t k,
                     int32_t cap, int32_t* counts) {
  // One O(n) bucketing by x amortized over all k boxes turns each box's
  // scan from O(n) into O(points in the box's x-slab) — a ScanNet box
  // spans ~10-30% of the scene in x, and the early-out cap (callers only
  // test counts >= 5) usually fires within a few hits. 256 uniform
  // buckets and a counting-sort scatter replace a comparison sort; the
  // scan re-tests x so bucket granularity is
  // correctness-neutral. Count is scan-order-independent (saturates at
  // cap), so results are identical to the naive loop.
  if (n == 0) {
    for (int64_t b = 0; b < k; ++b) counts[b] = 0;
    return;
  }
  constexpr int64_t NB = 256;
  float xmin = pc[0], xmax = pc[0];
  for (int64_t i = 1; i < n; ++i) {
    const float x = pc[i * 3];
    xmin = std::min(xmin, x);
    xmax = std::max(xmax, x);
  }
  const float inv = (xmax > xmin) ? NB / (xmax - xmin) : 0.0f;
  auto bucket_of = [&](float x) {
    int64_t b = (int64_t)((x - xmin) * inv);
    return std::min<int64_t>(std::max<int64_t>(b, 0), NB - 1);
  };
  std::vector<int64_t> offs(NB + 1, 0);
  std::vector<int64_t> bkt(n);
  for (int64_t i = 0; i < n; ++i) {
    bkt[i] = bucket_of(pc[i * 3]);
    ++offs[bkt[i] + 1];
  }
  for (int64_t b = 0; b < NB; ++b) offs[b + 1] += offs[b];
  std::vector<float> sx(n), sy(n), sz(n);
  {
    std::vector<int64_t> cur(offs.begin(), offs.end() - 1);
    for (int64_t i = 0; i < n; ++i) {
      const int64_t p = cur[bkt[i]]++;
      sx[p] = pc[i * 3];
      sy[p] = pc[i * 3 + 1];
      sz[p] = pc[i * 3 + 2];
    }
  }

  const int64_t want = (k + 31) / 32;  // ≥32 boxes per thread
  int64_t nthreads = std::min<int64_t>(
      {(int64_t)std::thread::hardware_concurrency(), 4, want, k});
  if (nthreads <= 1 || k < 8) {
    points_in_boxes_range(sx.data(), sy.data(), sz.data(), offs.data(), NB,
                          xmin, inv, boxes, 0, k, cap, counts);
    return;
  }
  std::vector<std::thread> ts;
  const int64_t chunk = (k + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    const int64_t b0 = t * chunk, b1 = std::min(k, b0 + chunk);
    if (b0 >= b1) break;
    ts.emplace_back(points_in_boxes_range, sx.data(), sy.data(), sz.data(),
                    offs.data(), NB, xmin, inv, boxes, b0, b1, cap, counts);
  }
  for (auto& th : ts) th.join();
}

// Full greedy NMS: per-pick on-demand double-precision AABB IoU (same
// formula and op order as the reference, utils/nms.py:71-150 — inter =
// prod(max(min(hi_i,hi_j)-max(lo_i,lo_j),0)); o = inter/(a_i+a_j-inter
// +eps)) instead of materializing the K x K overlap matrix. ``dims`` is
// 2 (x1,y1/x2,y2 NMS) or 3. ``order`` is ascending by score; picks pop
// from the end. ``cls`` is consulted only when use_cls != 0.
int64_t greedy_nms(const double* lo /*n*dims*/, const double* hi,
                   const double* cls, const int64_t* order,
                   int64_t n, int64_t dims, double thresh, double union_eps,
                   int64_t use_cls, int64_t* pick_out) {
  std::vector<double> area(n);
  for (int64_t i = 0; i < n; ++i) {
    double a = 1.0;
    for (int64_t d = 0; d < dims; ++d) a *= hi[i * dims + d] - lo[i * dims + d];
    area[i] = a;
  }
  std::vector<uint8_t> alive(n, 1);
  int64_t npick = 0;
  for (int64_t p = n - 1; p >= 0; --p) {
    if (!alive[p]) continue;
    const int64_t i = order[p];
    pick_out[npick++] = i;
    for (int64_t q = 0; q < p; ++q) {
      if (!alive[q]) continue;
      const int64_t j = order[q];
      double inter = 1.0;
      for (int64_t d = 0; d < dims; ++d) {
        const double l = std::max(lo[i * dims + d], lo[j * dims + d]);
        const double h = std::min(hi[i * dims + d], hi[j * dims + d]);
        inter *= std::max(h - l, 0.0);
      }
      double o = inter / (area[i] + area[j] - inter + union_eps);
      // Matches the numpy matrix version (data/native.py::greedy_nms_plain),
      // as the JAX package's eval/detection.py fallback does: it
      // keeps where (o * cls_eq) <= thresh: a NaN overlap (0/0 on
      // degenerate zero-volume boxes at eps=0) fails the <= and is
      // SUPPRESSED. Note this inverts the upstream utils/nms.py
      // semantics (np.delete on o>thresh KEEPS NaN, since NaN>t is
      // false) — reachable only for degenerate boxes with union_eps=0;
      // multiply (not branch) so NaN propagates identically to numpy.
      if (use_cls) o = o * (cls[i] == cls[j] ? 1.0 : 0.0);
      if (!(o <= thresh)) alive[q] = 0;
    }
  }
  return npick;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// numpy-legacy MT19937 no-replacement subsample.
//
// random_sampling (utils/pc_utils.py:32-40 semantics) is
// RandomState.choice(n, k, replace=False) == permutation(n)[:k], whose
// Fisher-Yates shuffle draws n-1 bounded randoms from the legacy stream
// (in numpy it is the per-row cost of the mul_eval grid).
// This reimplements numpy's exact legacy pipeline (mt19937_next
// tempering + randomkit rk_interval masked rejection, 32-bit path — n is
// always < 2^32 here) directly on the RandomState's exported state:
// `key` is mutated in place and the new `pos` returned, so Python
// set_state() continues the stream bit-identically to numpy having run.

static inline uint32_t mt_next32(uint32_t* key, int64_t* pos) {
  if (*pos >= 624) {  // regenerate (numpy mt19937_gen)
    for (int i = 0; i < 624; ++i) {
      const uint32_t y =
          (key[i] & 0x80000000u) | (key[(i + 1) % 624] & 0x7fffffffu);
      key[i] = key[(i + 397) % 624] ^ (y >> 1) ^ ((y & 1u) ? 0x9908b0dfu : 0u);
    }
    *pos = 0;
  }
  uint32_t y = key[(*pos)++];
  y ^= (y >> 11);
  y ^= (y << 7) & 0x9d2c5680u;
  y ^= (y << 15) & 0xefc60000u;
  y ^= (y >> 18);
  return y;
}

static inline uint32_t mt_interval(uint32_t maxv, uint32_t* key,
                                   int64_t* pos) {
  if (maxv == 0) return 0;
  uint32_t mask = maxv;
  mask |= mask >> 1; mask |= mask >> 2; mask |= mask >> 4;
  mask |= mask >> 8; mask |= mask >> 16;
  uint32_t value;
  while ((value = (mt_next32(key, pos) & mask)) > maxv) {}
  return value;
}

extern "C" {

// permutation(n)[:k] on an exported RandomState (key[624], pos).
// Returns the new pos; key is updated in place.
int64_t mt_permutation_head(uint32_t* key, int64_t pos, int64_t n,
                            int64_t k, int64_t* out) {
  std::vector<int64_t> arr((size_t)n);
  for (int64_t i = 0; i < n; ++i) arr[(size_t)i] = i;
  for (int64_t i = n - 1; i >= 1; --i) {
    const uint32_t j = mt_interval((uint32_t)i, key, &pos);
    std::swap(arr[(size_t)i], arr[j]);
  }
  std::copy(arr.begin(), arr.begin() + k, out);
  return pos;
}

}  // extern "C"
