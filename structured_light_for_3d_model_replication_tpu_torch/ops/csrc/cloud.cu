// Point-cloud kernels of the merge path and the clean chain, for Hopper
// (sm_90a).
//
// Five kernels (Pallas originals in structured_light_for_3d_model_replication_
// tpu/ops/pallas_kernels.py):
//
//   radius_count_kernel   replaces _radius_kernel (call _radius_call, entry
//                         radius_count_pallas): per point, the number of other
//                         points with d2 <= r^2, self excluded by index. One
//                         thread per query, the cloud streamed through shared
//                         memory in tiles, an int count in a register. d2 is
//                         taken by coordinate differences, not by the TPU's
//                         |q|^2+|b|^2-2q.b expansion, so a pair's verdict
//                         depends on its two points alone (the function the
//                         JAX package's exact twin radius_count_np computes).
//                         Invalid rows are the caller's to park far away; the
//                         kernel masks its own ragged edge, so no padding.
//   nn1_kernel            replaces _nn1_kernel (call _nn1_call): brute 1-NN.
//                         One thread per query, the base staged through shared
//                         memory in tiles, running min/argmin in registers. The
//                         scan is sequential with a strict '<', so ties go to
//                         the lowest base index (the Pallas kernel's rule, :414).
//                         Distances are taken by coordinate differences, which
//                         is also what the Pallas path reports (knn.exact_d2):
//                         no |q|^2+|b|^2-2q.b cancellation in the selection.
//                         A leading pair axis (grid.y) makes one launch serve
//                         every pair of a register_pairs group.
//   ransac_score_kernel   replaces _ransac_score_kernel: inlier counts of T
//                         rigid hypotheses, d2 = sc + 2 * (H[t] . P[n]) with
//                         the 16-term dot summed in a fixed order. One thread
//                         per hypothesis keeps its H row in registers; P and
//                         sc are staged in shared memory; grid.y splits the
//                         correspondences and the counts meet by integer
//                         atomicAdd (exact, any order).
//   knn_mean_kernel       replaces _knn_mean_kernel: exact mean distance to
//                         the k nearest candidates among the whole cloud.
//   slab_knn_mean_kernel  replaces _slab_bisect_kernel: the same statistic over
//                         a 2*wblk window of an x-sorted cloud. The block finds
//                         its own window start (lower_bound of the tile's first
//                         x minus r, aligned down to wblk, at most nblk - 2):
//                         that was the TPU's scalar prefetch.
//
// The two k-NN-mean kernels share one device routine (knn_mean_tile): a block
// of 32 warps takes 64 queries, two a warp. For each query the k-th smallest
// squared distance is found by 31 passes of bisection on the f32 bit pattern
// (monotone for non-negative floats); each pass counts the candidates <= mid,
// a lane at a time, and __reduce_add_sync totals the warp. Then one masked
// sum of sqrt(d2) over the candidates strictly below the k-th, plus the tie
// correction (k - #less) * sqrt(t). Self-exclusion is by global index: the
// query's own slot gets bits 2^31 - 2, above every cutoff.
//
// What bounds them: operations. nn1 and radius_count do ~9 float operations
// per (query, base) pair and read 12 bytes a query; the k-NN means repeat ~12 per
// (query, candidate) pair in each of 33 passes; RANSAC scoring does 34 per
// (hypothesis, correspondence). All are far above the card's bytes-per-
// operation balance, so the design keeps every operand on chip: the base
// tile, the hypothesis row, the P rows and the candidate window sit in
// shared memory or registers, and device memory is read about once. The
// slab window as SoA f32 is 2 * 8192 * 3 * 4 = 196,608 B: above the 48 KB
// static limit, so it is dynamic shared memory after cudaFuncSetAttribute.
// The whole-cloud kernel (<= 32768 points, 393 KB) cannot hold its cloud,
// so it streams the cloud through the same 16384-point buffer, from L2,
// once per pass.
//
// Float order: every distance is ((dx*dx + dy*dy) + dz*dz), each step with
// __fsub_rn/__fmul_rn/__fadd_rn, so no FMA contraction changes a bit against
// the plain PyTorch versions (ops/kernels.py). sqrtf stays IEEE (no
// fast-math). Plain C interface for ctypes; every entry returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNnThreads = 128;     // queries per nn1 block = base tile
constexpr int kRcThreads = 256;     // queries per radius_count block = base tile
constexpr int kRsThreads = 128;     // hypotheses per ransac block
constexpr int kRsChunk = 512;       // correspondences per ransac block
constexpr int kRsTile = 128;        // correspondences staged per sync
constexpr int kKnnWarps = 32;
constexpr int kKnnQpw = 2;          // queries a warp carries
constexpr int kKnnTile = kKnnWarps * kKnnQpw;
constexpr int kKnnThreads = kKnnWarps * 32;
constexpr int kChunk = 16384;       // candidates resident in shared memory
constexpr int kSelfBits = 0x7FFFFFFE;
constexpr int kBisect = 31;

__device__ __forceinline__ float d2_diff(float qx, float qy, float qz, float cx, float cy, float cz) {
  const float dx = __fsub_rn(qx, cx);
  const float dy = __fsub_rn(qy, cy);
  const float dz = __fsub_rn(qz, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// ---------------------------------------------------------------------------
// nn1
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kNnThreads)
nn1_kernel(const float* __restrict__ q, const float* __restrict__ base, int32_t* __restrict__ idx_out,
           float* __restrict__ d2_out, int nq, int nb) {
  __shared__ float4 tile[kNnThreads];
  const long long p = blockIdx.y;
  const float* qp = q + p * nq * 3;
  const float* bp = base + p * nb * 3;
  const int i = blockIdx.x * kNnThreads + threadIdx.x;
  const bool live = i < nq;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = qp[3LL * i];
    qy = qp[3LL * i + 1];
    qz = qp[3LL * i + 2];
  }
  float best = __int_as_float(0x7f800000);  // +inf
  int best_j = 0;
  for (int t0 = 0; t0 < nb; t0 += kNnThreads) {
    const int j = t0 + threadIdx.x;
    if (j < nb) tile[threadIdx.x] = make_float4(bp[3LL * j], bp[3LL * j + 1], bp[3LL * j + 2], 0.f);
    __syncthreads();
    const int n = min(kNnThreads, nb - t0);
#pragma unroll 8
    for (int c = 0; c < n; ++c) {
      const float4 b = tile[c];
      const float d = d2_diff(qx, qy, qz, b.x, b.y, b.z);
      if (d < best) {
        best = d;
        best_j = t0 + c;
      }
    }
    __syncthreads();
  }
  if (live) {
    idx_out[p * nq + i] = best_j;
    d2_out[p * nq + i] = best;
  }
}

// ---------------------------------------------------------------------------
// radius_count
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kRcThreads)
radius_count_kernel(const float* __restrict__ pts, int n, float r2, int32_t* __restrict__ counts) {
  __shared__ float4 tile[kRcThreads];
  const int i = blockIdx.x * kRcThreads + threadIdx.x;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (i < n) {
    qx = pts[3LL * i];
    qy = pts[3LL * i + 1];
    qz = pts[3LL * i + 2];
  }
  int cnt = 0;
  for (int t0 = 0; t0 < n; t0 += kRcThreads) {
    const int j = t0 + threadIdx.x;
    if (j < n) tile[threadIdx.x] = make_float4(pts[3LL * j], pts[3LL * j + 1], pts[3LL * j + 2], 0.f);
    __syncthreads();
    const int m = min(kRcThreads, n - t0);
#pragma unroll 8
    for (int c = 0; c < m; ++c) {
      const float4 b = tile[c];
      const float d = d2_diff(qx, qy, qz, b.x, b.y, b.z);
      cnt += (d <= r2 && t0 + c != i) ? 1 : 0;
    }
    __syncthreads();
  }
  if (i < n) counts[i] = cnt;
}

// ---------------------------------------------------------------------------
// ransac_score
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kRsThreads)
ransac_score_kernel(const float* __restrict__ h, const float* __restrict__ pm, const float* __restrict__ sc,
                    float md2, int32_t* __restrict__ counts, int T, int N) {
  __shared__ float rows[kRsTile][17];  // P row (16) and sc
  const int t = blockIdx.x * kRsThreads + threadIdx.x;
  float hr[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) hr[c] = t < T ? h[16LL * t + c] : 0.f;
  const int n0 = blockIdx.y * kRsChunk;
  const int n1 = min(N, n0 + kRsChunk);
  int cnt = 0;
  for (int s = n0; s < n1; s += kRsTile) {
    for (int e = threadIdx.x; e < kRsTile * 17; e += kRsThreads) {
      const int r = e / 17, c = e % 17, n = s + r;
      float v;
      if (n < n1) v = c < 16 ? pm[16LL * n + c] : sc[n];
      else v = c < 16 ? 0.f : __int_as_float(0x7f800000);
      rows[r][c] = v;
    }
    __syncthreads();
    const int m = min(kRsTile, n1 - s);
    for (int r = 0; r < m; ++r) {
      float acc = __fmul_rn(hr[0], rows[r][0]);
#pragma unroll
      for (int c = 1; c < 16; ++c) acc = __fadd_rn(acc, __fmul_rn(hr[c], rows[r][c]));
      const float d2 = __fadd_rn(rows[r][16], __fmul_rn(2.f, acc));
      cnt += d2 <= md2 ? 1 : 0;
    }
    __syncthreads();
  }
  if (t < T && cnt) atomicAdd(&counts[t], cnt);
}

// ---------------------------------------------------------------------------
// k-NN mean: one routine, two candidate sets
// ---------------------------------------------------------------------------

__device__ __forceinline__ void stage(float* sx, float* sy, float* sz, const float* __restrict__ pts, int c0,
                                      int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float* p = pts + 3LL * (c0 + i);
    sx[i] = p[0];
    sy[i] = p[1];
    sz[i] = p[2];
  }
}

// Block-wide: the block's 64 queries [tq0, tq0 + 64) of pts [L, 3] against
// the candidates [c0, c0 + nc). Writes mean, count(d2 <= r2 cutoff) and,
// where win_end is given, the window's exclusive end.
__device__ void knn_mean_tile(const float* __restrict__ pts, int L, int tq0, int c0, int nc, int k, int r2b,
                              float* __restrict__ mean_out, int32_t* __restrict__ cnt_out,
                              int32_t* __restrict__ end_out) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = smem + kChunk;
  float* sz = smem + 2 * kChunk;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float qx[kKnnQpw], qy[kKnnQpw], qz[kKnnQpw];
  int qg[kKnnQpw];
#pragma unroll
  for (int j = 0; j < kKnnQpw; ++j) {
    qg[j] = tq0 + warp * kKnnQpw + j;
    const long long qi = min(qg[j], L - 1);
    qx[j] = pts[3 * qi];
    qy[j] = pts[3 * qi + 1];
    qz[j] = pts[3 * qi + 2];
  }
  const bool resident = nc <= kChunk;
  if (resident) {
    stage(sx, sy, sz, pts, c0, nc);
    __syncthreads();
  }
  // one pass over every candidate; visit(j, bits) for each of the warp's queries
  auto sweep = [&](auto&& visit) {
    for (int s = 0; s < nc; s += kChunk) {
      const int n = min(kChunk, nc - s);
      if (!resident) {
        __syncthreads();
        stage(sx, sy, sz, pts, c0 + s, n);
        __syncthreads();
      }
      for (int c = lane; c < n; c += 32) {
        const float cx = sx[c], cy = sy[c], cz = sz[c];
        const int cg = c0 + s + c;
#pragma unroll
        for (int j = 0; j < kKnnQpw; ++j) {
          const float d = d2_diff(qx[j], qy[j], qz[j], cx, cy, cz);
          visit(j, cg == qg[j] ? kSelfBits : __float_as_int(d));
        }
      }
    }
  };

  int ok[kKnnQpw] = {};
  sweep([&](int j, int bits) { ok[j] += bits <= r2b ? 1 : 0; });
  int lo[kKnnQpw], hi[kKnnQpw];
#pragma unroll
  for (int j = 0; j < kKnnQpw; ++j) {
    ok[j] = __reduce_add_sync(0xffffffffu, ok[j]);
    lo[j] = 0;
    hi[j] = r2b + 1;
  }
  for (int it = 0; it < kBisect; ++it) {
    int mid[kKnnQpw], cnt[kKnnQpw] = {};
#pragma unroll
    for (int j = 0; j < kKnnQpw; ++j) mid[j] = lo[j] + ((hi[j] - lo[j]) >> 1);  // floor, as '//'
    sweep([&](int j, int bits) { cnt[j] += bits <= mid[j] ? 1 : 0; });
#pragma unroll
    for (int j = 0; j < kKnnQpw; ++j) {
      const bool ge = __reduce_add_sync(0xffffffffu, cnt[j]) >= k;
      lo[j] = ge ? lo[j] : mid[j] + 1;
      hi[j] = ge ? mid[j] : hi[j];
    }
  }
  float sum[kKnnQpw] = {};
  int less[kKnnQpw] = {};
  sweep([&](int j, int bits) {
    if (bits < hi[j]) {
      sum[j] = __fadd_rn(sum[j], sqrtf(__int_as_float(bits)));
      less[j] += 1;
    }
  });
#pragma unroll
  for (int j = 0; j < kKnnQpw; ++j) {
    float s = sum[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    const int c_lt = __reduce_add_sync(0xffffffffu, less[j]);
    if (lane == 0 && qg[j] < L) {
      const float tie = __fmul_rn((float)(k - c_lt), sqrtf(__int_as_float(hi[j])));
      mean_out[qg[j]] = __fdiv_rn(__fadd_rn(s, tie), (float)k);
      cnt_out[qg[j]] = ok[j];
      if (end_out != nullptr) end_out[qg[j]] = c0 + nc;
    }
  }
}

__global__ void __launch_bounds__(kKnnThreads, 1)
knn_mean_kernel(const float* __restrict__ pts, int L, int k, int r2b, float* __restrict__ mean_out,
                int32_t* __restrict__ cnt_out) {
  knn_mean_tile(pts, L, blockIdx.x * kKnnTile, 0, L, k, r2b, mean_out, cnt_out, nullptr);
}

__global__ void __launch_bounds__(kKnnThreads, 1)
slab_knn_mean_kernel(const float* __restrict__ pts, int L, int k, int r2b, int wblk, int tile, float r,
                     float* __restrict__ mean_out, int32_t* __restrict__ cnt_out, int32_t* __restrict__ end_out) {
  __shared__ int s_c0;
  const int tq0 = blockIdx.x * kKnnTile;
  if (threadIdx.x == 0) {
    // lower_bound over the sorted x of the first query of this block's tile
    const float v = __fsub_rn(pts[3LL * ((tq0 / tile) * tile)], r);
    int lo = 0, hi = L;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (pts[3LL * mid] < v) lo = mid + 1;
      else hi = mid;
    }
    const int nblk = L / wblk;
    s_c0 = min(lo / wblk, max(nblk - 2, 0)) * wblk;
  }
  __syncthreads();
  knn_mean_tile(pts, L, tq0, s_c0, 2 * wblk, k, r2b, mean_out, cnt_out, end_out);
}

cudaError_t allow_smem(const void* fn) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, 3 * kChunk * (int)sizeof(float));
}

}  // namespace

extern "C" {

int slscan_nn1(const float* q, const float* base, int32_t* idx, float* d2, int pairs, int nq, int nb,
               cudaStream_t stream) {
  const dim3 grid((nq + kNnThreads - 1) / kNnThreads, pairs);
  nn1_kernel<<<grid, kNnThreads, 0, stream>>>(q, base, idx, d2, nq, nb);
  return (int)cudaGetLastError();
}

int slscan_radius_count(const float* pts, int n, float r2, int32_t* counts, cudaStream_t stream) {
  radius_count_kernel<<<(n + kRcThreads - 1) / kRcThreads, kRcThreads, 0, stream>>>(pts, n, r2, counts);
  return (int)cudaGetLastError();
}

int slscan_ransac_score(const float* h, const float* pm, const float* sc, float md2, int32_t* counts, int T,
                        int N, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int32_t) * (size_t)T, stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kRsThreads - 1) / kRsThreads, (N + kRsChunk - 1) / kRsChunk);
  ransac_score_kernel<<<grid, kRsThreads, 0, stream>>>(h, pm, sc, md2, counts, T, N);
  return (int)cudaGetLastError();
}

int slscan_knn_mean(const float* pts, int L, int k, int r2b, float* mean, int32_t* cnt, cudaStream_t stream) {
  cudaError_t err = allow_smem((const void*)knn_mean_kernel);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = 3 * sizeof(float) * (size_t)(L < kChunk ? L : kChunk);
  knn_mean_kernel<<<(L + kKnnTile - 1) / kKnnTile, kKnnThreads, smem, stream>>>(pts, L, k, r2b, mean, cnt);
  return (int)cudaGetLastError();
}

int slscan_slab_mean_knn(const float* pts, int L, int k, int r2b, int wblk, int tile, float r, float* mean,
                         int32_t* cnt, int32_t* win_end, cudaStream_t stream) {
  cudaError_t err = allow_smem((const void*)slab_knn_mean_kernel);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = 3 * sizeof(float) * (size_t)(2 * wblk < kChunk ? 2 * wblk : kChunk);
  slab_knn_mean_kernel<<<L / kKnnTile, kKnnThreads, smem, stream>>>(pts, L, k, r2b, wblk, tile, r, mean, cnt,
                                                                    win_end);
  return (int)cudaGetLastError();
}

}  // extern "C"
