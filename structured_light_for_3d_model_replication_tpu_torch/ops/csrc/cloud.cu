// Point-cloud kernels of the merge path and the clean chain, for Hopper
// (sm_90a).
//
// Eight kernels and a prep pass. Seven replace Pallas originals (in
// structured_light_for_3d_model_replication_tpu/ops/pallas_kernels.py);
// knn_binmin_kernel, the last, and its prep pass binmin_prep_kernel replace
// no Pallas kernel:
//
//   radius_count_kernel   replaces _radius_kernel (call _radius_call, entry
//                         radius_count_pallas): per point, the number of other
//                         points with d2 <= r^2. Bound by operations: ~10
//                         issued instructions a (query, base) pair once d2 may
//                         not contract into FMAs, N^2 pairs. The design spends
//                         the issue slots on the pairs alone:
//                         - register blocking: a thread carries kRcQ = 8
//                           queries, so one broadcast float4 read of shared
//                           memory feeds eight pairs;
//                         - the count is an f32 compare-and-add (exact below
//                           2^24, which caps a block's span), two f32
//                           instructions where an int count took three;
//                         - no index compare a pair: every base row is counted,
//                           then the query's own term (d2_diff(q, q) <= r^2,
//                           not a literal 1, so a NaN row stays right) is
//                           subtracted where the block's base span holds it;
//                         - grid.y splits the base into spans sized so the
//                           launch has ~64 blocks an SM (several waves at the
//                           clean chain's 15k-61k rows); partial counts meet
//                           by integer atomicAdd into a zeroed output, exact in
//                           any order, and only non-zero partials are added;
//                         - base tiles are double-buffered in shared memory
//                           with cp.async, the ragged edge masked, no padding.
//                         d2 is taken by coordinate differences, not by the
//                         TPU's |q|^2+|b|^2-2q.b expansion, so a pair's verdict
//                         depends on its two points alone (the function the
//                         JAX package's exact twin radius_count_np computes).
//   nn1_kernel            replaces _nn1_kernel (call _nn1_call): brute 1-NN,
//                         ties to the lowest base index (the Pallas kernel's
//                         rule, :414). Bound by operations (~11 issued a pair
//                         without FMAs: the d2, a compare, two selects) and, at
//                         the ICP group's [4, 2048, 2048], by filling the card:
//                         a warp carries kNnQpw = 8 queries and its lanes
//                         stride over the base (lane l: rows l, l + 32, ...),
//                         so the grid is pairs x nq / 64 blocks of 8 warps (128
//                         at the ICP group, one an SM) and three reads of shared
//                         memory feed eight pairs. The base streams through a
//                         two-slot cp.async ring of 1024-row chunks, the ragged
//                         tail padded with +inf. Each lane keeps a running
//                         (d2, j) by a strict '<' over rising j from (+inf, 0);
//                         a butterfly takes the lexicographic (d2, j) minimum
//                         over the lanes, which equals one sequential scan bit
//                         for bit (a NaN never wins; a row with no finite
//                         distance keeps (+inf, 0)). No atomics, one launch: a
//                         leading pair axis (grid.y) serves every pair of a
//                         register_pairs group. (4 or 16 queries a warp, 4 or
//                         16 warps a block and 512-row chunks were tried on the
//                         card beside this; none was faster at both shapes
//                         without 126 registers a thread.)
//   ransac_score_kernel   replaces _ransac_score_kernel: inlier counts of T
//                         rigid hypotheses, d2 = sc + 2 * (H[t] . P[n]) with
//                         the 16-term dot summed c = 0..15 in order. Bound by
//                         operations: 35 issued instructions a pair (16 mul,
//                         15 add, the scale, the add of sc, the compare and
//                         the count) once the dot may not contract into FMAs.
//                         The design keeps the issue slots full:
//                         - register blocking: a thread carries kRsHpt = 4
//                           hypotheses (lane l of a block's 128: rows l,
//                           l + 32, l + 64, l + 96), so four independent dot
//                           chains interleave and one read of a P row (four
//                           broadcast float4 and sc) feeds four pairs; each
//                           pair's chain keeps its own order, bit for bit;
//                         - every warp of a block carries the same 128
//                           hypotheses and takes every kRsWarps-th row of the
//                           block's correspondences; grid.y splits the
//                           correspondences into spans sized from the SM
//                           count, so the launch has ~kRsBlocksPerSm blocks
//                           an SM (16 warps an SM at T = 4096, N = 2048);
//                         - P and sc stream through a two-slot ring of
//                           kRsTile rows filled by 16-byte cp.async (4-byte
//                           where H or P is not 16-byte aligned) while the
//                           previous tile is scored; a warp stops at the
//                           tile's last row, so no padding row is read;
//                         - the warps' counts meet in shared memory, then
//                           one integer atomicAdd a (block, hypothesis) into
//                           the output the entry zeroes once: exact in any
//                           order.
//   slab_select_kernel    replaces _slab_bisect_kernel for k <= 128: the mean
//                         distance to the k nearest candidates in a 2*wblk
//                         window of an x-sorted cloud, with ONE sweep that
//                         computes each (query, candidate) d2 once (the TPU
//                         kernel and the bisection kernel below sweep the
//                         window 33 times). A warp-level k-selection in the
//                         manner of FAISS's WarpSelect:
//                         - a warp carries kSelQpw = 4 queries; its lanes
//                           stride over the window, one candidate read from
//                           shared memory feeding four pairs; the hot loop is
//                           the four d2 and one vote on "any within r";
//                         - per query a warp-uniform threshold tau = min(the
//                           k-th smallest bit pattern kept so far, r2b + 1):
//                           nothing at or above it can change the output;
//                         - candidates under tau (self excluded by global
//                           index) are compacted by __ballot_sync/__popc into
//                           a 64-slot per-(warp, query) queue in shared
//                           memory; at 32 queued they are bitonic-sorted across
//                           the lanes and merged into a sorted list of E
//                           32-entry segments held in registers, entry
//                           32 s + lane in register s of that lane (E = 1, 2,
//                           4 for k <= 32, 64, 128: a template parameter),
//                           and tau tightens. The sorted 32 cascade through
//                           the segments in order: at each, a bitonic
//                           half-cleaner pair keeps the low 32 in the segment
//                           and carries the high 32 on (list_merge);
//                         - in that rare branch count(bits <= r2b) grows by the
//                           __popc of a ballot; at the end the query's own
//                           term comes off.
//                         Then t = min(k-th, r2b + 1), and the mean is the sum
//                         of sqrt over the list entries < t (a butterfly a
//                         segment, then the segments in order: the same bits
//                         on every run) plus (k - #less) * sqrt(t), over k:
//                         the statistic of the bisection, which any top-k
//                         selection reproduces because tied values are
//                         equal. Bound by operations
//                         (~12 issued instructions a pair); the window streams
//                         through a two-slot ring of 1024-candidate chunks
//                         filled by cp.async while the previous chunk is
//                         swept, 40 KB of shared memory a 512-thread block, so
//                         two blocks share an SM and one's waits hide under
//                         the other's sweep (at E = 4 one block an SM: its 96
//                         registers a thread measured faster than two blocks
//                         spilling at 64). Each 64-query block finds its own
//                         window start (lower_bound of its tile's first x
//                         minus r, aligned down to wblk, at most nblk - 2):
//                         that was the TPU's scalar prefetch.
//   knn_select_kernel     replaces _knn_mean_kernel for k <= 128: the exact
//                         mean distance to the k nearest rows of the whole
//                         cloud [0, L) (any L >= 1) and the count within the
//                         1e17 cutoff, by slab_select_kernel's one-sweep warp
//                         selection, with three differences. The gate of the
//                         rare branch is bits < tau (at a 1e17 cutoff nearly
//                         every row is "within r", so the slab kernel's gate
//                         would fire on every step); the count of bits <= r2b
//                         is one f32 compare-and-add a pair in the hot loop,
//                         reduced over the lanes once at the end, the query's
//                         own term then taken off; each block starts its sweep
//                         at the chunk that holds its first query and wraps
//                         around, so on the clouds of the path (x-sorted, or in
//                         voxel order) tau falls in the first chunk. Slots past
//                         L in the last chunk hold +inf and vote false (votes
//                         need all 32 lanes); query rows past L load clamped
//                         and write nothing.
//   knn_mean_kernel       replaces _knn_mean_kernel for k > 128, and
//   slab_knn_mean_kernel  _slab_bisect_kernel for k > 128 (what four list
//                         segments cannot hold). Both run knn_mean_tile: a block of
//                         32 warps takes 64 queries, two a warp; the k-th
//                         smallest squared distance is found by 31 passes of
//                         bisection on the f32 bit pattern (monotone for
//                         non-negative floats), each pass counting the
//                         candidates <= mid with __reduce_add_sync; then one
//                         masked sum of sqrt(d2) below the k-th plus the tie
//                         correction. 33 sweeps of every d2. The whole-cloud
//                         kernel streams the cloud through a 16384-point
//                         shared buffer, from L2, once per pass.
//   knn_binmin_kernel     no Pallas original: the counterpart of XLA's
//                         lax.approx_min_k (the TPU's PartialReduce), which
//                         the JAX package runs outside any Pallas kernel in
//                         knn_dense_approx (ops/knn.py:188), the brute
//                         engine's "approx:<recall>" selector (:260) and the
//                         slab engine's approx1 selector (ops/pointcloud.py:
//                         418). For each (query row, bin b < M) the least d2
//                         over the columns j = b, b + M, b + 2M, ... (j != the
//                         row), and its index, ties to the lowest index;
//                         (+inf, b) where no column is finite; the wrapper's
//                         top-k over the M winners is the selection
//                         (kernels.knn_binmin). Strided bins, not contiguous
//                         windows: in a pixel-ordered cloud a point's nearest
//                         neighbours sit at nearby indices, which strided bins
//                         spread over distinct bins. The JAX package takes the
//                         distances on the matrix unit (|q|^2 + |b|^2 - 2q.b
//                         by dot_general) and recomputes the winners; this
//                         kernel screens on the tensor cores and confirms on
//                         the CUDA cores, bit for bit against the plain
//                         version. Design:
//                         - binmin_prep_kernel writes every column once a
//                           launch: its raw x, y, z (16-byte rows) and a
//                           32-byte record of c' = c - mu (mu: the centroid of
//                           the cloud's unparked points, read with route_r2
//                           from a 4-float device buffer that kernels.
//                           binmin_screen_terms fills): -2c' and (1 +- alpha)|c'|^2
//                           in f32, each split into bf16 hi + lo (2^-16
//                           relative);
//                         - a block takes 256 query rows (8 warps, two m16
//                           tiles each) and 16 bins (two n8 tiles); each bin
//                           step is one mma.sync.m16n8k16 bf16 a tile, whose 16
//                           K slots hold the four cross products (hh, hl, lh,
//                           ll) of each coordinate and the hi + lo norm, so
//                           u = q'.(-2c') + (1 + alpha)|c'|^2 and (pass 2,
//                           the other norm slots) v = q'.(-2c') +
//                           (1 - alpha)|c'|^2, with |q'|^2 added per row;
//                         - the margin: |d2 - (|q'|^2 + q'.(-2c') + |c'|^2)|
//                           <= alpha (|q'|^2 + |c'|^2) + beta for every pair.
//                           With S = |q'|^2 + |c'|^2: the bf16 pairs hold q'
//                           and -2c' to 2^-16, so the cross products to
//                           2^-14 |q'||c'| <= 2^-15 S; the norm, its f32 sum
//                           and the (1 +- alpha) scale to 1.02 * 2^-16 S; the
//                           tensor cores' f32 accumulation of 16 exact bf16
//                           products, taken as 2^-20 of their absolute sum
//                           (<= 2.02 S), 2^-19 S (kernels.BINMIN_ACC; on the
//                           card bm_probe_kernel, this mma.sync on cancelling,
//                           wide-spread, large-accumulator and screen tiles,
//                           erred by at most 3.67e-7 = 2^-21.4 of the sum's
//                           absolute terms, chip_smoke.py phase 15(a), which
//                           fails above 2^-20); centring (2^-22 S) and the
//                           f32 difference d2 itself (5 * 2^-24 * 2S): 1.61 *
//                           2^-15 S in all. alpha = 2^-12, five times that
//                           (kernels.BINMIN_ALPHA); beta = 2^-60 mm^2 covers
//                           bf16 products that underflow;
//                         - pass 1: T = the least u over the bin's columns,
//                           one FMNMX a pair (the row's own column left out);
//                           pass 2: a column goes to the exact confirm iff
//                           v <= tau = T + 2 alpha |q'|^2 + 2 beta (rounded
//                           up), i.e. d2~ - margin <= the least d2~ + margin:
//                           the exact winner and every column tied with it
//                           pass. Two passes, because one running threshold
//                           would confirm almost every column of a
//                           pixel-ordered cloud, whose strided bins step
//                           toward the query one image row at a time (the
//                           margin holds for this sum too: |tau| <= ~2 S of
//                           the winner);
//                         - pass 2's MMA takes -tau' (the next float above
//                           tau) as its accumulator, so a column passes iff
//                           its sum is negative: a step's four MMAs issue
//                           first, then one OR of the 16 sign bits; only a
//                           step where a thread passes walks its tiles;
//                         - the confirm: the difference d2 (d2_diff) of the
//                           raw rows, kept by the lexicographic least (d2, j)
//                           (an explicit index tie-break), in the registers
//                           of the thread that owns the (row, bin). At the
//                           1080p cluster shape a (row, bin) confirms 1.05
//                           columns of its 519, 0.2 % of the pairs;
//                         - columns stream through a three-slot ring of 16
//                           bin steps (16-byte cp.async of whole records, one
//                           barrier a slot), read as one 8-byte LDS a thread
//                           and n8 tile, conflict-free; past N or M a finite
//                           far record (norms 2^126, no cross terms: no
//                           inf * 0 in an MMA), masked by index at the
//                           confirm;
//                         - rows the screen cannot narrow (|q'|^2 above
//                           route_r2, 16x the unparked cloud's squared radius:
//                           parked rows at FAR, whose margin would swallow
//                           the cloud; NaN rows; every row when a coordinate
//                           exceeds 2^60) take an exact CUDA-core sweep in the
//                           same kernel: every column of the bin in rising
//                           order by a strict '<' from the first (the plain
//                           version's rule; a screened row takes a NaN first
//                           column's distance the same way), ending once
//                           every lane holds d2 = 0, which nothing after can
//                           beat (a parked row meets a parked column within a
//                           few steps).
//                         Bound (chip_smoke.binmin_bound, from a call's
//                         counts) by the screen's CUDA-core instructions, at
//                         least 2.25 a screened pair (pass 1's FMNMX; pass
//                         2's OR of the sign bits, 0.5 by three-input LOP3;
//                         the two passes' MMA issues, 0.5, and B-fragment
//                         loads, 0.25) at one a lane a clock, and nearly as
//                         much by the tensor cores (two m16n8k16 a 128 pairs
//                         at the dense bf16 rate); a confirm or exact-sweep
//                         pair adds the 9 instructions of d2. It runs at
//                         16 warps an SM (two 256-thread blocks, 128
//                         registers a thread) and is held back by latency.
//                         Counts (screened rows, exact-sweep rows, confirms,
//                         exact-sweep pairs) go to a stats buffer.
//
// Self-exclusion is by global index everywhere: a query's own slot is above
// every cutoff (the bisection kernels give it bits 2^31 - 2; the selection
// kernels keep it out of the queue and take its term off the count).
//
// Float order: every distance is ((dx*dx + dy*dy) + dz*dz), each step with
// __fsub_rn/__fmul_rn/__fadd_rn, so no FMA contraction changes a bit against
// the plain PyTorch versions (ops/kernels.py). sqrtf stays IEEE (no
// fast-math). Plain C interface for ctypes; every entry returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kNnWarps = 8;
constexpr int kNnQpw = 8;           // queries an nn1 warp carries
constexpr int kNnQueries = kNnWarps * kNnQpw;
constexpr int kNnThreads = kNnWarps * 32;
constexpr int kNnChunk = 1024;      // base rows a ring slot
constexpr int kRcThreads = 128;     // threads of a radius_count block
constexpr int kRcQ = 8;             // queries a radius_count thread carries
constexpr int kRcQueries = kRcThreads * kRcQ;
constexpr int kRcTile = 256;        // base rows a ring slot
constexpr int kRcBlocksPerSm = 64;  // the grid.y split aims at this many blocks an SM
constexpr int kRcMaxSpan = 1 << 24; // base rows a block: a thread's f32 count stays exact
constexpr int kRsWarps = 4;
constexpr int kRsThreads = kRsWarps * 32;
constexpr int kRsHpt = 4;           // hypotheses a ransac thread carries
constexpr int kRsHyps = 32 * kRsHpt;  // hypotheses a ransac block: every warp carries all
constexpr int kRsTile = 64;         // correspondences a ring slot
constexpr int kRsBlocksPerSm = 4;   // the grid.y split aims at this many blocks an SM
constexpr int kKnnWarps = 32;
constexpr int kKnnQpw = 2;          // queries a warp carries
constexpr int kKnnTile = kKnnWarps * kKnnQpw;
constexpr int kKnnThreads = kKnnWarps * 32;
constexpr int kChunk = 16384;       // candidates resident in shared memory
constexpr int kSelfBits = 0x7FFFFFFE;
constexpr int kBisect = 31;
constexpr int kBmWarps = 8;
constexpr int kBmThreads = kBmWarps * 32;
constexpr int kBmMt = 2;            // m16 tiles a knn_binmin warp: 32 query rows
constexpr int kBmRows = kBmWarps * 16 * kBmMt;
constexpr int kBmNt = 2;            // n8 tiles a block: 16 bins
constexpr int kBmBins = 8 * kBmNt;
constexpr int kBmSteps = 16;        // bin steps a ring slot
constexpr int kBmSlots = 3;
constexpr int kSelWarps = 16;
constexpr int kSelQpw = 4;          // queries a selection warp carries
constexpr int kSelTile = kSelWarps * kSelQpw;
constexpr int kSelThreads = kSelWarps * 32;
constexpr int kSelUnroll = 4;       // warp steps of the sweep unrolled
constexpr int kSelChunk = 1024;     // candidates a ring slot
constexpr int kSelQueue = 64;       // a (warp, query) queue: < 32 kept + 32 new
constexpr int kSelMaxSegments = 4;  // 32-entry list segments of the selection kernels: k <= 128
constexpr int kIntMax = 0x7FFFFFFF;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float d2_diff(float qx, float qy, float qz, float cx, float cy, float cz) {
  const float dx = __fsub_rn(qx, cx);
  const float dy = __fsub_rn(qy, cy);
  const float dz = __fsub_rn(qz, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// 4-byte asynchronous copy global -> shared (sm_80+), and its group fences
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// 16-byte asynchronous copy, cached in L2 only; both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + m) of pts [*, 3] into a ring slot of floats (x, y, z a
// row), 4 bytes a cp.async by the block's Threads threads; the slots past m
// up to the next whole warp step hold +inf, whose distance is above every
// running minimum, threshold and cutoff, so those lanes vote false.
template <int Threads>
__device__ __forceinline__ void stage_rows(float* slot, const float* __restrict__ pts, int r0, int m) {
  const float* src = pts + 3LL * r0;
  for (int e = threadIdx.x; e < 3 * m; e += Threads) cp_async4(slot + e, src + e);
  const int pad = 3 * (((m + 31) & ~31) - m);
  for (int e = threadIdx.x; e < pad; e += Threads) slot[3 * m + e] = __int_as_float(0x7f800000);
  cp_async_commit();
}

// ---------------------------------------------------------------------------
// nn1
// ---------------------------------------------------------------------------

// Queries [blockIdx.x * kNnQueries, +kNnQueries) of pair blockIdx.y,
// kNnQpw a warp. Lane l scans base rows l, l + 32, ... in rising order with
// a strict '<', so it holds the lowest index among its own equal minima; the
// butterfly then takes the (d2, j) lexicographic minimum of the 32 lanes,
// which is what one sequential strict-'<' scan from (+inf, 0) returns.
__global__ void __launch_bounds__(kNnThreads)
nn1_kernel(const float* __restrict__ q, const float* __restrict__ base, int32_t* __restrict__ idx_out,
           float* __restrict__ d2_out, int nq, int nb) {
  __shared__ float ring[2][3 * kNnChunk];
  const long long p = blockIdx.y;
  const float* qp = q + p * nq * 3;
  const float* bp = base + p * nb * 3;
  const int lane = threadIdx.x & 31;
  const int qw0 = (int)blockIdx.x * kNnQueries + (threadIdx.x >> 5) * kNnQpw;
  float qx[kNnQpw], qy[kNnQpw], qz[kNnQpw], best[kNnQpw];
  int best_j[kNnQpw];
#pragma unroll
  for (int j = 0; j < kNnQpw; ++j) {
    const long long i = min(qw0 + j, nq - 1);  // rows past nq load clamped and write nothing
    qx[j] = qp[3 * i];
    qy[j] = qp[3 * i + 1];
    qz[j] = qp[3 * i + 2];
    best[j] = __int_as_float(0x7f800000);  // +inf
    best_j[j] = 0;
  }
  const int nchunks = (nb + kNnChunk - 1) / kNnChunk;
  stage_rows<kNnThreads>(ring[0], bp, 0, min(kNnChunk, nb));
  for (int ch = 0; ch < nchunks; ++ch) {
    const int j0 = ch * kNnChunk;
    if (ch + 1 < nchunks) {
      stage_rows<kNnThreads>(ring[(ch + 1) & 1], bp, j0 + kNnChunk, min(kNnChunk, nb - j0 - kNnChunk));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* buf = ring[ch & 1];
    const int n = (min(kNnChunk, nb - j0) + 31) & ~31;
#pragma unroll 4
    for (int c = lane; c < n; c += 32) {
      const float bx = buf[3 * c], by = buf[3 * c + 1], bz = buf[3 * c + 2];
#pragma unroll
      for (int j = 0; j < kNnQpw; ++j) {
        const float d = d2_diff(qx[j], qy[j], qz[j], bx, by, bz);
        if (d < best[j]) {
          best[j] = d;
          best_j[j] = j0 + c;
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kNnQpw; ++j) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(kFull, best[j], o);
      const int oj = __shfl_xor_sync(kFull, best_j[j], o);
      if (od < best[j] || (od == best[j] && oj < best_j[j])) {
        best[j] = od;
        best_j[j] = oj;
      }
    }
    if (lane == j && qw0 + j < nq) {
      idx_out[p * nq + qw0 + j] = best_j[j];
      d2_out[p * nq + qw0 + j] = best[j];
    }
  }
}

// ---------------------------------------------------------------------------
// radius_count
// ---------------------------------------------------------------------------

// Rows [t0, t0 + m) of pts into a float4 ring slot, 4 bytes a cp.async.
__device__ __forceinline__ void rc_stage(float4* slot, const float* __restrict__ pts, int t0, int m) {
  const float* src = pts + 3LL * t0;
  for (int e = threadIdx.x; e < 3 * m; e += kRcThreads) {
    const int p = e / 3;
    cp_async4(reinterpret_cast<float*>(slot + p) + (e - 3 * p), src + e);
  }
  cp_async_commit();
}

// Queries [blockIdx.x * 1024, +1024) (thread t: t, t + 128, ..., t + 896)
// against base rows [blockIdx.y * span, +span).
__global__ void __launch_bounds__(kRcThreads)
radius_count_kernel(const float* __restrict__ pts, int n, float r2, int span, int32_t* __restrict__ counts) {
  __shared__ float4 ring[2][kRcTile];
  const int b0 = blockIdx.y * span;
  const int b1 = min(n, b0 + span);
  float qx[kRcQ], qy[kRcQ], qz[kRcQ];
  float cnt[kRcQ];  // exact: a span holds < 2^24 rows; a compare feeds an add on the f32 pipe
#pragma unroll
  for (int j = 0; j < kRcQ; ++j) {
    const long long i = min((int)blockIdx.x * kRcQueries + j * kRcThreads + (int)threadIdx.x, n - 1);
    qx[j] = pts[3 * i];
    qy[j] = pts[3 * i + 1];
    qz[j] = pts[3 * i + 2];
    cnt[j] = 0.f;
  }
  const int ntiles = (b1 - b0 + kRcTile - 1) / kRcTile;
  rc_stage(ring[0], pts, b0, min(kRcTile, b1 - b0));
  for (int t = 0; t < ntiles; ++t) {
    const int t0 = b0 + t * kRcTile;
    if (t + 1 < ntiles) {
      rc_stage(ring[(t + 1) & 1], pts, t0 + kRcTile, min(kRcTile, b1 - t0 - kRcTile));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float4* tile = ring[t & 1];
    const int m = min(kRcTile, b1 - t0);
#pragma unroll 8
    for (int c = 0; c < m; ++c) {
      const float4 b = tile[c];
#pragma unroll
      for (int j = 0; j < kRcQ; ++j) cnt[j] += d2_diff(qx[j], qy[j], qz[j], b.x, b.y, b.z) <= r2 ? 1.f : 0.f;
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kRcQ; ++j) {
    const int i = (int)blockIdx.x * kRcQueries + j * kRcThreads + (int)threadIdx.x;
    if (i >= n) continue;
    // the query's own row was counted where this span holds it
    int c = (int)cnt[j];
    if (i >= b0 && i < b1 && d2_diff(qx[j], qy[j], qz[j], qx[j], qy[j], qz[j]) <= r2) c -= 1;
    if (c) atomicAdd(&counts[i], c);
  }
}

// ---------------------------------------------------------------------------
// ransac_score
// ---------------------------------------------------------------------------

// Rows [n, n + m) of P [*, 16] and sc into a ring slot: 16 bytes a
// cp.async where H and P are 16-byte aligned (kVec), else 4.
template <bool kVec>
__device__ __forceinline__ void rs_stage(float (*rows)[16], float* scs, const float* __restrict__ pm,
                                         const float* __restrict__ sc, int n, int m) {
  const float* src = pm + 16LL * n;
  if constexpr (kVec) {
    for (int e = threadIdx.x; e < 4 * m; e += kRsThreads) cp_async16(&rows[e >> 2][4 * (e & 3)], src + 4 * e);
  } else {
    for (int e = threadIdx.x; e < 16 * m; e += kRsThreads) cp_async4(&rows[e >> 4][e & 15], src + e);
  }
  for (int e = threadIdx.x; e < m; e += kRsThreads) cp_async4(scs + e, sc + n + e);
  cp_async_commit();
}

// Hypotheses [blockIdx.x * kRsHyps, +kRsHyps) (lane l: l, l + 32, l + 64,
// l + 96 of them) against correspondences [blockIdx.y * span, +span), warp w
// taking rows w, w + kRsWarps, ... of each tile.
template <bool kVec>
__global__ void __launch_bounds__(kRsThreads, kRsBlocksPerSm)
ransac_score_kernel(const float* __restrict__ h, const float* __restrict__ pm, const float* __restrict__ sc,
                    float md2, int32_t* __restrict__ counts, int T, int N, int span) {
  static_assert(kRsThreads == kRsHyps, "one thread sums one hypothesis' partials");
  __shared__ __align__(16) float rows[2][kRsTile][16];
  __shared__ float scs[2][kRsTile];
  __shared__ int part[kRsWarps][kRsHyps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t0 = (int)blockIdx.x * kRsHyps;
  float hr[kRsHpt][16];
  int cnt[kRsHpt];
#pragma unroll
  for (int j = 0; j < kRsHpt; ++j) {
    const int t = t0 + 32 * j + lane;  // rows past T score zeros and write nothing
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < T) {
        const float* hp = h + 16LL * t + 4 * c;
        v = kVec ? __ldg(reinterpret_cast<const float4*>(hp)) : make_float4(hp[0], hp[1], hp[2], hp[3]);
      }
      hr[j][4 * c] = v.x;
      hr[j][4 * c + 1] = v.y;
      hr[j][4 * c + 2] = v.z;
      hr[j][4 * c + 3] = v.w;
    }
    cnt[j] = 0;
  }
  const int n0 = (int)blockIdx.y * span;
  const int n1 = min(N, n0 + span);
  const int ntiles = (n1 - n0 + kRsTile - 1) / kRsTile;
  rs_stage<kVec>(rows[0], scs[0], pm, sc, n0, min(kRsTile, n1 - n0));
  for (int k = 0; k < ntiles; ++k) {
    const int s0 = n0 + k * kRsTile;
    if (k + 1 < ntiles) {
      rs_stage<kVec>(rows[(k + 1) & 1], scs[(k + 1) & 1], pm, sc, s0 + kRsTile,
                     min(kRsTile, n1 - s0 - kRsTile));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float(*tile)[16] = rows[k & 1];
    const float* tsc = scs[k & 1];
    const int m = min(kRsTile, n1 - s0);
#pragma unroll 2
    for (int r = warp; r < m; r += kRsWarps) {
      float p[16];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 v = reinterpret_cast<const float4*>(tile[r])[c];
        p[4 * c] = v.x;
        p[4 * c + 1] = v.y;
        p[4 * c + 2] = v.z;
        p[4 * c + 3] = v.w;
      }
      const float s = tsc[r];
      float acc[kRsHpt];
#pragma unroll
      for (int j = 0; j < kRsHpt; ++j) acc[j] = __fmul_rn(hr[j][0], p[0]);
#pragma unroll
      for (int c = 1; c < 16; ++c) {
#pragma unroll
        for (int j = 0; j < kRsHpt; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(hr[j][c], p[c]));
      }
#pragma unroll
      for (int j = 0; j < kRsHpt; ++j) cnt[j] += __fadd_rn(s, __fmul_rn(2.f, acc[j])) <= md2 ? 1 : 0;
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kRsHpt; ++j) part[warp][32 * j + lane] = cnt[j];
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kRsWarps; ++w) total += part[w][threadIdx.x];
  const int t = t0 + (int)threadIdx.x;
  if (t < T && total) atomicAdd(&counts[t], total);
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

// The window start of the block whose first query is tq0: lower_bound over
// the sorted x of its tile's first x minus r, aligned down to wblk, at most
// nblk - 2 (ops/kernels._slab_starts).
__device__ int slab_window_start(const float* __restrict__ pts, int L, int tq0, int wblk, int tile, float r) {
  const float v = __fsub_rn(pts[3LL * ((tq0 / tile) * tile)], r);
  int lo = 0, hi = L;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (pts[3LL * mid] < v) lo = mid + 1;
    else hi = mid;
  }
  const int nblk = L / wblk;
  return min(lo / wblk, max(nblk - 2, 0)) * wblk;
}

__global__ void __launch_bounds__(kKnnThreads, 1)
slab_knn_mean_kernel(const float* __restrict__ pts, int L, int k, int r2b, int wblk, int tile, float r,
                     float* __restrict__ mean_out, int32_t* __restrict__ cnt_out, int32_t* __restrict__ end_out) {
  __shared__ int s_c0;
  const int tq0 = blockIdx.x * kKnnTile;
  if (threadIdx.x == 0) s_c0 = slab_window_start(pts, L, tq0, wblk, tile, r);
  __syncthreads();
  knn_mean_tile(pts, L, tq0, s_c0, 2 * wblk, k, r2b, mean_out, cnt_out, end_out);
}

// ---------------------------------------------------------------------------
// slab k-NN mean, k <= 128: one sweep with a warp-level k-selection
// ---------------------------------------------------------------------------

// One value a lane, sorted ascending across the warp (bitonic network).
__device__ __forceinline__ int warp_sort_asc(int v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int o = __shfl_xor_sync(kFull, v, stride);
      const bool up = (lane & size) == 0;
      const bool low = (lane & stride) == 0;
      v = (low == up) ? min(v, o) : max(v, o);
    }
  }
  return v;
}

// The list of E sorted 32-entry segments (entry 32 s + lane in register s
// of that lane, so the list holds 32 E entries ascending) merged with the
// 32 values v (one a lane): v is sorted, then cascades through the
// segments in order. At each, min and max of the segment and v reversed
// are bitonic sequences holding the 32 smallest and the 32 largest of
// both; half-cleaners sort each, the segment keeps the smallest and the
// largest go on to the next. The last segment's largest are dropped, and
// so is every segment from entry k on (they cannot hold a kept entry); at
// E = 1 the largest are never computed.
template <int E>
__device__ __forceinline__ void list_merge(int (&list)[E], int v, int lane, int k) {
  v = warp_sort_asc(v, lane);
#pragma unroll
  for (int s = 0; s < E; ++s) {
    if (s > 0 && 32 * s >= k) break;
    const int r = __shfl_sync(kFull, v, 31 - lane);
    int lo = min(list[s], r);
    int hi = max(list[s], r);
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1) {
      const bool low = (lane & stride) == 0;
      const int ol = __shfl_xor_sync(kFull, lo, stride);
      lo = low ? min(lo, ol) : max(lo, ol);
      if (s + 1 < E) {
        const int oh = __shfl_xor_sync(kFull, hi, stride);
        hi = low ? min(hi, oh) : max(hi, oh);
      }
    }
    list[s] = lo;
    v = hi;
  }
}

// Entry i of a segment list, on every lane: register i / 32 of lane i % 32
// (a shuffle's source lane is taken modulo 32).
template <int E>
__device__ __forceinline__ int list_entry(const int (&list)[E], int i) {
  int x = list[0];
#pragma unroll
  for (int s = 1; s < E; ++s) x = (i >> 5) == s ? list[s] : x;
  return __shfl_sync(kFull, x, i);
}

// Merge the first `take` entries of a (warp, query) queue into its list, keep
// the rest queued, tighten tau. Warp-uniform; inlined, so that the caller's
// per-query registers stay registers.
template <int E>
__device__ __forceinline__ void sel_flush(int* q, int& qn, int (&list)[E], int& tau, int take, int lane,
                                          int k, int r2b) {
  __syncwarp();
  const int v = lane < take ? q[lane] : kIntMax;
  const int rest = qn - take;
  const int w = lane < rest ? q[take + lane] : 0;
  __syncwarp();
  if (lane < rest) q[lane] = w;
  __syncwarp();
  qn = rest;
  list_merge<E>(list, v, lane, k);
  tau = min(r2b + 1, list_entry<E>(list, k - 1));
}

// The bisection's statistic from a list sorted across the lanes (and the
// segments) that holds the k smallest bit patterns: t = min(k-th, r2b + 1),
// the sum of sqrt over the entries < t in a fixed order (a butterfly a
// segment, then the segments in order: the same bits on every run), plus
// (k - #less) * sqrt(t), over k. Warp-uniform.
template <int E>
__device__ __forceinline__ float sel_mean(const int (&list)[E], int lane, int k, int r2b) {
  const int t = min(list_entry<E>(list, k - 1), r2b + 1);
  float total = 0.f;
  int c_lt = 0;
#pragma unroll
  for (int s = 0; s < E; ++s) {
    const bool lt = 32 * s + lane < k && list[s] < t;
    float x = lt ? sqrtf(__int_as_float(list[s])) : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(kFull, x, o));
    total = s == 0 ? x : __fadd_rn(total, x);
    c_lt += __popc(__ballot_sync(kFull, lt));
  }
  const float tie = __fmul_rn((float)(k - c_lt), sqrtf(__int_as_float(t)));
  return __fdiv_rn(__fadd_rn(total, tie), (float)k);
}

// two blocks an SM (64 registers a thread) up to two list segments; one (96
// registers, no spills) at four, which measured faster than spilling
template <int E>
__global__ void __launch_bounds__(kSelThreads, E <= 2 ? 2 : 1)
slab_select_kernel(const float* __restrict__ pts, int L, int k, int r2b, int wblk, int tile, float r,
                   float* __restrict__ mean_out, int32_t* __restrict__ cnt_out, int32_t* __restrict__ end_out) {
  __shared__ float ring[2][3 * kSelChunk];                 // 24 KB: the window, two chunks at a time
  __shared__ int queue[kSelWarps][kSelQpw][kSelQueue];     // 16 KB
  __shared__ int s_c0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int tq0 = (int)blockIdx.x * kSelTile;
  if (threadIdx.x == 0) s_c0 = slab_window_start(pts, L, tq0, wblk, tile, r);
  __syncthreads();
  const int c0 = s_c0;
  const int nc = 2 * wblk;
  const float r2 = __int_as_float(r2b);
  float qx[kSelQpw], qy[kSelQpw], qz[kSelQpw];
  int list[kSelQpw][E], tau[kSelQpw], qn[kSelQpw], cnt[kSelQpw];
#pragma unroll
  for (int j = 0; j < kSelQpw; ++j) {
    const long long qi = tq0 + warp * kSelQpw + j;  // < L: the grid is L / 64 blocks
    qx[j] = pts[3 * qi];
    qy[j] = pts[3 * qi + 1];
    qz[j] = pts[3 * qi + 2];
#pragma unroll
    for (int s = 0; s < E; ++s) list[j][s] = kIntMax;
    tau[j] = r2b + 1;
    qn[j] = 0;
    cnt[j] = 0;
  }
  auto stage = [&](int slot, int s) { stage_rows<kSelThreads>(ring[slot], pts, c0 + s, min(kSelChunk, nc - s)); };
  const int nchunks = (nc + kSelChunk - 1) / kSelChunk;
  stage(0, 0);
  for (int ch = 0; ch < nchunks; ++ch) {
    if (ch + 1 < nchunks) {
      stage((ch + 1) & 1, (ch + 1) * kSelChunk);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* buf = ring[ch & 1];
    const int n = min(kSelChunk, nc - ch * kSelChunk);  // a multiple of 32: 2 * wblk % 128 == 0
    const int cg0 = c0 + ch * kSelChunk;
#pragma unroll kSelUnroll
    for (int c = lane; c < n; c += 32) {
      const float cx = buf[3 * c], cy = buf[3 * c + 1], cz = buf[3 * c + 2];
      float d[kSelQpw];
      bool near = false;
#pragma unroll
      for (int j = 0; j < kSelQpw; ++j) {
        d[j] = d2_diff(qx[j], qy[j], qz[j], cx, cy, cz);
        near |= d[j] <= r2;
      }
      // rare: a candidate within r of one of the warp's queries (tau <= r2b + 1)
      if (__any_sync(kFull, near)) {
#pragma unroll
        for (int j = 0; j < kSelQpw; ++j) {
          const unsigned in_r = __ballot_sync(kFull, d[j] <= r2);
          if (!in_r) continue;
          cnt[j] += __popc(in_r);
          const bool take = __float_as_int(d[j]) < tau[j] && cg0 + c != tq0 + warp * kSelQpw + j;
          const unsigned m = __ballot_sync(kFull, take);
          if (m) {
            if (take) queue[warp][j][qn[j] + __popc(m & below)] = __float_as_int(d[j]);
            qn[j] += __popc(m);
            if (qn[j] >= 32) sel_flush<E>(queue[warp][j], qn[j], list[j], tau[j], 32, lane, k, r2b);
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kSelQpw; ++j) {
    if (qn[j] > 0) sel_flush<E>(queue[warp][j], qn[j], list[j], tau[j], qn[j], lane, k, r2b);
    const int qg = tq0 + warp * kSelQpw + j;
    const float mean = sel_mean<E>(list[j], lane, k, r2b);
    int ok = cnt[j];
    // the query's own slot was counted where the window holds it
    if (qg >= c0 && qg < c0 + nc && d2_diff(qx[j], qy[j], qz[j], qx[j], qy[j], qz[j]) <= r2) ok -= 1;
    if (lane == 0) {
      mean_out[qg] = mean;
      cnt_out[qg] = ok;
      end_out[qg] = c0 + nc;
    }
  }
}

// ---------------------------------------------------------------------------
// whole-cloud k-NN mean, k <= 128: the same selection over every row
// ---------------------------------------------------------------------------

// Queries [blockIdx.x * 64, +64) of pts [L, 3] (any L >= 1) against all L
// rows. The sweep starts at the chunk that holds the block's first query and
// wraps around: on an x-sorted or voxel-ordered cloud the index neighbours
// come first, tau falls to near its final value in that chunk, and the rare
// branch stays rare. The kept set (the k smallest bit patterns), the butterfly
// sum over it and the integer count do not depend on the sweep order.
// two blocks an SM (64 registers a thread) up to two list segments; one (96
// registers, no spills) at four, which measured faster than spilling
template <int E>
__global__ void __launch_bounds__(kSelThreads, E <= 2 ? 2 : 1)
knn_select_kernel(const float* __restrict__ pts, int L, int k, int r2b, float* __restrict__ mean_out,
                  int32_t* __restrict__ cnt_out) {
  __shared__ float ring[2][3 * kSelChunk];              // 24 KB: two chunks of the cloud
  __shared__ int queue[kSelWarps][kSelQpw][kSelQueue];  // 16 KB
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int tq0 = (int)blockIdx.x * kSelTile;
  const int qw0 = tq0 + warp * kSelQpw;  // the warp's first query
  const float r2 = __int_as_float(r2b);
  float qx[kSelQpw], qy[kSelQpw], qz[kSelQpw], cnt[kSelQpw], tauf[kSelQpw];
  int list[kSelQpw][E], qn[kSelQpw];
#pragma unroll
  for (int j = 0; j < kSelQpw; ++j) {
    const long long qi = min(qw0 + j, L - 1);  // rows past L load clamped and write nothing
    qx[j] = pts[3 * qi];
    qy[j] = pts[3 * qi + 1];
    qz[j] = pts[3 * qi + 2];
    cnt[j] = 0.f;  // exact: a lane sees at most L / 32 + 1 rows
    tauf[j] = __int_as_float(r2b + 1);
#pragma unroll
    for (int s = 0; s < E; ++s) list[j][s] = kIntMax;
    qn[j] = 0;
  }
  const int nchunks = (L + kSelChunk - 1) / kSelChunk;
  auto rows = [&](int ch) { return min(kSelChunk, L - ch * kSelChunk); };
  int ch = tq0 / kSelChunk;
  stage_rows<kSelThreads>(ring[0], pts, ch * kSelChunk, rows(ch));
  for (int i = 0; i < nchunks; ++i) {
    const int next = ch + 1 == nchunks ? 0 : ch + 1;
    if (i + 1 < nchunks) {
      stage_rows<kSelThreads>(ring[(i + 1) & 1], pts, next * kSelChunk, rows(next));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* buf = ring[i & 1];
    const int n = (rows(ch) + 31) & ~31;
    const int cg0 = ch * kSelChunk;
#pragma unroll kSelUnroll
    for (int c = lane; c < n; c += 32) {
      const float cx = buf[3 * c], cy = buf[3 * c + 1], cz = buf[3 * c + 2];
      float d[kSelQpw];
      bool under = false;
#pragma unroll
      for (int j = 0; j < kSelQpw; ++j) {
        d[j] = d2_diff(qx[j], qy[j], qz[j], cx, cy, cz);
        cnt[j] += d[j] <= r2 ? 1.f : 0.f;  // at a 1e17 cutoff nearly every row counts
        under |= d[j] < tauf[j];           // bits < tau: d >= 0, so the float order is the bits' order
      }
      // rare once tau has fallen: a candidate under one of the warp's thresholds
      if (__any_sync(kFull, under)) {
#pragma unroll
        for (int j = 0; j < kSelQpw; ++j) {
          const bool take = d[j] < tauf[j] && cg0 + c != qw0 + j;
          const unsigned m = __ballot_sync(kFull, take);
          if (m) {
            if (take) queue[warp][j][qn[j] + __popc(m & below)] = __float_as_int(d[j]);
            qn[j] += __popc(m);
            if (qn[j] >= 32) {
              int tau;
              sel_flush<E>(queue[warp][j], qn[j], list[j], tau, 32, lane, k, r2b);
              tauf[j] = __int_as_float(tau);
            }
          }
        }
      }
    }
    __syncthreads();
    ch = next;
  }
#pragma unroll
  for (int j = 0; j < kSelQpw; ++j) {
    int tau;
    if (qn[j] > 0) sel_flush<E>(queue[warp][j], qn[j], list[j], tau, qn[j], lane, k, r2b);
    const float mean = sel_mean<E>(list[j], lane, k, r2b);
    // the query's own row was counted: take its term off
    int ok = __reduce_add_sync(kFull, (int)cnt[j]);
    if (d2_diff(qx[j], qy[j], qz[j], qx[j], qy[j], qz[j]) <= r2) ok -= 1;
    if (lane == 0 && qw0 + j < L) {
      mean_out[qw0 + j] = mean;
      cnt_out[qw0 + j] = ok;
    }
  }
}

// ---------------------------------------------------------------------------
// knn_binmin
// ---------------------------------------------------------------------------

// A column's screen record, 32 bytes: the B registers of mma.m16n8k16 that
// thread kq of a group of four loads (words 2kq, 2kq + 1), each a bf16 pair
// (hi in the low half, lo in the high half): kq < 3 coordinate kq of -2c'
// in both words, kq = 3 the norms (1 + alpha)|c'|^2 and (1 - alpha)|c'|^2.
struct alignas(16) BmOp {
  uint32_t w[8];
};

// The far record: no cross terms, both norms 2^126 (bf16 0x7E80). Its
// screen value 2^126 is finite (no inf * 0 in an MMA) and above every real
// column's (|u| < 2^124 within the screen's coordinate range), so it never
// lowers a bin's threshold; the confirm masks it by index.
constexpr uint32_t kBmFarNorm = 0x7E80u;
constexpr uint32_t kBmOne2 = 0x3F803F80u;  // bf16 (1, 1)

// v -> bf16 pair (RN(v) in the low half, RN(v - RN(v)) in the high half);
// v - RN(v) is exact in f32, so hi + lo holds v to 2^-16 relative.
__device__ __forceinline__ uint32_t bm_split(float v) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  const __nv_bfloat16 l = __float2bfloat16_rn(__fsub_rn(v, __bfloat162float(h)));
  return (uint32_t)__bfloat16_as_ushort(h) | ((uint32_t)__bfloat16_as_ushort(l) << 16);
}

// v -> the bf16 pair (x, x) of one half of the split: lo = false hi, true lo.
__device__ __forceinline__ uint32_t bm_dup(float v, bool lo) {
  const uint32_t s = bm_split(v);
  const uint32_t h = lo ? s >> 16 : s & 0xFFFFu;
  return h | (h << 16);
}

// d = A B (+ 0): one 16 x 8 tile of screen values, K = 16 bf16 slots.
__device__ __forceinline__ void bm_mma(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y), "f"(0.0f));
}

// d = A B + c: pass 2's tile, c = -tau', so a value passes iff d < 0.
__device__ __forceinline__ void bm_mma_c(float (&d)[4], const uint32_t (&a)[4], uint2 b, const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y), "f"(c[0]), "f"(c[1]), "f"(c[2]),
        "f"(c[3]));
}

// Every column of the cloud once a launch: its raw x, y, z (16-byte rows for
// the confirm and the exact sweep) and its screen record, c' = c - mu. A
// column with a non-finite coordinate or norm gets the far record (its exact
// distance is inf or NaN, which never wins).
__global__ void __launch_bounds__(256)
binmin_prep_kernel(const float* __restrict__ pts, int n, const float* __restrict__ terms, float alpha,
                   BmOp* __restrict__ op, float4* __restrict__ raw) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const float x = pts[3LL * j], y = pts[3LL * j + 1], z = pts[3LL * j + 2];
  raw[j] = make_float4(x, y, z, 0.0f);
  const float cx = __fsub_rn(x, __ldg(terms)), cy = __fsub_rn(y, __ldg(terms + 1)), cz = __fsub_rn(z, __ldg(terms + 2));
  const float cn = __fadd_rn(__fadd_rn(__fmul_rn(cx, cx), __fmul_rn(cy, cy)), __fmul_rn(cz, cz));
  uint4* dst = reinterpret_cast<uint4*>(op + j);
  if (isfinite(cn)) {
    const uint32_t wx = bm_split(__fmul_rn(-2.0f, cx));
    const uint32_t wy = bm_split(__fmul_rn(-2.0f, cy));
    const uint32_t wz = bm_split(__fmul_rn(-2.0f, cz));
    dst[0] = make_uint4(wx, wx, wy, wy);
    dst[1] = make_uint4(wz, wz, bm_split(__fmul_rn(cn, 1.0f + alpha)), bm_split(__fmul_rn(cn, 1.0f - alpha)));
  } else {
    dst[0] = make_uint4(0u, 0u, 0u, 0u);
    dst[1] = make_uint4(0u, 0u, kBmFarNorm, kBmFarNorm);
  }
}

struct BmArgs {
  const int32_t* rows;
  int n_rows, n, m, exclude_self;
  const float* terms;  // mu_x, mu_y, mu_z, route_r2 (kernels.binmin_screen_terms, on the device)
  float alpha, beta;
  const BmOp* op;
  const float4* raw;
  float* d2;
  int32_t* idx;
  unsigned long long* stats;  // [screened rows, exact-sweep rows, confirms, exact-sweep pairs]
};

struct BmShared {
  BmOp op[kBmSlots][kBmSteps][kBmBins];
  float4 raw[kBmSlots][kBmSteps][kBmBins];
  float4 q[kBmRows];   // x, y, z, row index (bits)
  float4 qc[kBmRows];  // q - mu and |q - mu|^2; w NaN: not screened (exact sweep or past n_rows)
};

// What a thread carries through both passes: its A registers of each pass,
// and for each of its (row, bin) values (row g + 8 (i >> 1) of m16 tile mt,
// bin nt * 8 + 2 kq + (i & 1)) the threshold (pass 1: the least u; pass 2:
// -tau', the accumulator that turns the test into a sign) and the best
// (d2, j) confirmed.
struct BmThread {
  uint32_t a[kBmMt][4], a2[kBmMt][4];
  float tt[kBmMt][kBmNt][4];
  float bd[kBmMt][kBmNt][4];
  int bj[kBmMt][kBmNt][4];
  int self_t[kBmMt][2], self_b[kBmMt][2];  // the row's self column: step and local bin (-1: none here)
  unsigned confirms;
};

// Columns b0 + bb + m (t0 + s), bb < kBmBins, s < kBmSteps, into ring slot
// `slot` by 16-byte cp.async: records, and with kRaw the raw rows. Columns at
// or past n, and bins at or past m, get the far record (no raw row: masked).
template <bool kRaw>
__device__ __forceinline__ void bm_stage(BmShared& sh, int slot, const BmArgs& p, int b0, int t0) {
  constexpr int kOps = kBmSteps * kBmBins * 2;
  const int all = kRaw ? kOps + kBmSteps * kBmBins : kOps;
#pragma unroll
  for (int e0 = 0; e0 < all; e0 += kBmThreads) {
    const int e = e0 + threadIdx.x;
    const bool is_op = e < kOps;
    const unsigned r = is_op ? e >> 1 : e - kOps;
    const int s = r / kBmBins, bb = r % kBmBins;
    const int b = b0 + bb;
    const long long j = b + (long long)p.m * (t0 + s);
    const bool ok = b < p.m && j < p.n;
    if (is_op) {
      uint4* dst = reinterpret_cast<uint4*>(&sh.op[slot][s][bb]) + (e & 1);
      if (ok) {
        cp_async16(dst, reinterpret_cast<const uint4*>(p.op + j) + (e & 1));
      } else {
        *dst = (e & 1) ? make_uint4(0u, 0u, kBmFarNorm, kBmFarNorm) : make_uint4(0u, 0u, 0u, 0u);
      }
    } else if (ok) {
      cp_async16(&sh.raw[slot][s][bb], p.raw + j);
    }
  }
  cp_async_commit();
}

// The exact confirm of one (row, column) the screen passed: the difference
// d2 (inf for the row itself under exclude_self), kept if it is the
// lexicographic least (d2, j) so far.
__device__ __forceinline__ void bm_confirm(const BmShared& sh, int slot, int s, int rl, int bb, int j,
                                           const BmArgs& p, float& bd, int& bj, unsigned& confirms) {
  const float4 q = sh.q[rl];
  const float4 c = sh.raw[slot][s][bb];
  float d = d2_diff(q.x, q.y, q.z, c.x, c.y, c.z);
  if (p.exclude_self && j == __float_as_int(q.w)) d = __int_as_float(0x7f800000);
  if (d < bd || (d == bd && j < bj)) {
    bd = d;
    bj = j;
  }
  ++confirms;
}

// One ring slot of one pass for a warp's 2 m16 tiles x the block's 2 n8
// tiles. Pass 1 (!kPass2) keeps the least u of each value (kSelf: the slot
// holds a row's self column, whose u is made +inf). Pass 2 takes a step's
// four products with the accumulator -tau' first, so a value passes iff its
// sum is negative: one OR of the 16 sign bits a step, and only a step with
// a pass walks its tiles and values to the exact confirm.
template <bool kPass2, bool kSelf>
__device__ __forceinline__ void bm_slot(const BmShared& sh, int slot, int t0, int b0, int wrow, int g, int kq,
                                        const BmArgs& p, BmThread& th) {
#pragma unroll 4
  for (int s = 0; s < kBmSteps; ++s) {
    uint2 b[kBmNt];
#pragma unroll
    for (int nt = 0; nt < kBmNt; ++nt) b[nt] = *reinterpret_cast<const uint2*>(&sh.op[slot][s][nt * 8 + g].w[2 * kq]);
    if (!kPass2) {
#pragma unroll
      for (int mt = 0; mt < kBmMt; ++mt) {
#pragma unroll
        for (int nt = 0; nt < kBmNt; ++nt) {
          float c[4];
          bm_mma(c, th.a[mt], b[nt]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (kSelf && t0 + s == th.self_t[mt][i >> 1] && nt * 8 + 2 * kq + (i & 1) == th.self_b[mt][i >> 1]) {
              c[i] = __int_as_float(0x7f800000);
            }
            th.tt[mt][nt][i] = fminf(th.tt[mt][nt][i], c[i]);
          }
        }
      }
    } else {
      float d[kBmMt][kBmNt][4];
      uint32_t any = 0u;
#pragma unroll
      for (int mt = 0; mt < kBmMt; ++mt) {
#pragma unroll
        for (int nt = 0; nt < kBmNt; ++nt) {
          bm_mma_c(d[mt][nt], th.a2[mt], b[nt], th.tt[mt][nt]);
#pragma unroll
          for (int i = 0; i < 4; ++i) any |= __float_as_uint(d[mt][nt][i]);
        }
      }
      if (any >> 31) {
#pragma unroll
        for (int mt = 0; mt < kBmMt; ++mt) {
#pragma unroll
          for (int nt = 0; nt < kBmNt; ++nt) {
            const uint32_t tile = __float_as_uint(d[mt][nt][0]) | __float_as_uint(d[mt][nt][1]) |
                                  __float_as_uint(d[mt][nt][2]) | __float_as_uint(d[mt][nt][3]);
            if (tile >> 31) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int bb = nt * 8 + 2 * kq + (i & 1);
                const int j = b0 + bb + p.m * (t0 + s);
                if ((__float_as_uint(d[mt][nt][i]) >> 31) && b0 + bb < p.m && j < p.n) {
                  bm_confirm(sh, slot, s, wrow + mt * 16 + g + 8 * (i >> 1), bb, j, p, th.bd[mt][nt][i],
                             th.bj[mt][nt][i], th.confirms);
                }
              }
            }
          }
        }
      }
    }
  }
}

// One pass over the bin group's steps: a three-slot cp.async ring, one
// barrier a slot; warps without a screened row stage and wait, nothing else.
template <bool kPass2>
__device__ __forceinline__ void bm_pass(BmShared& sh, const BmArgs& p, int b0, int ntiles, int wrow, int g, int kq,
                                        bool warp_screens, BmThread& th) {
  bm_stage<kPass2>(sh, 0, p, b0, 0);
  if (ntiles > 1) {
    bm_stage<kPass2>(sh, 1, p, b0, kBmSteps);
  } else {
    cp_async_commit();
  }
  int slot = 0;
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<1>();  // tile t is in (this thread's copies)
    __syncthreads();     // everyone's copies of tile t, and everyone done with tile t - 1
    if (t + 2 < ntiles) {
      bm_stage<kPass2>(sh, slot == 0 ? 2 : slot - 1, p, b0, (t + 2) * kBmSteps);
    } else {
      cp_async_commit();
    }
    const int t0 = t * kBmSteps;
    if (warp_screens) {
      if (kPass2) {
        bm_slot<true, false>(sh, slot, t0, b0, wrow, g, kq, p, th);
      } else {
        bool mine = false;
#pragma unroll
        for (int mt = 0; mt < kBmMt; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) mine |= th.self_t[mt][h] >= t0 && th.self_t[mt][h] < t0 + kBmSteps;
        }
        if (__any_sync(kFull, mine)) {
          bm_slot<false, true>(sh, slot, t0, b0, wrow, g, kq, p, th);
        } else {
          bm_slot<false, false>(sh, slot, t0, b0, wrow, g, kq, p, th);
        }
      }
    }
    slot = slot == 2 ? 0 : slot + 1;
  }
  cp_async_wait<0>();
  __syncthreads();  // the next pass restages slots 0 and 1
}

// Block: kBmRows query rows (rows[blockIdx.x * kBmRows + ...]; warp w the
// 32 from w * 32, two m16 tiles) against bin groups of kBmBins bins (b0 =
// (blockIdx.y + k gridDim.y) kBmBins). Rows near the cloud (|q - mu|^2 <=
// route_r2) are screened: pass 1 gives each (row, bin) its T, pass 2 its
// confirms. The others (parked rows, non-finite rows) take the exact sweep:
// a warp's such rows two at a time, lane l on bin l % 16, every column of the
// bin in rising order by a strict '<' from its first column (the plain
// version's rule), ending early once every lane holds d2 = 0 (nothing after
// it can win). Rows past n_rows load clamped and write nothing.
__global__ void __launch_bounds__(kBmThreads, 2)
knn_binmin_kernel(const float* __restrict__ pts, const __grid_constant__ BmArgs p) {
  __shared__ BmShared sh;
  const int lane = threadIdx.x & 31;
  const int wrow = (threadIdx.x >> 5) * 32;
  const int g = lane >> 2, kq = lane & 3;
  const long long r0 = (long long)blockIdx.x * kBmRows;
  bool scr;
  {
    const int rl = threadIdx.x;  // kBmRows == kBmThreads: a thread loads one row
    const bool valid = r0 + rl < p.n_rows;
    const int row = p.rows[valid ? r0 + rl : p.n_rows - 1];
    const float x = pts[3LL * row], y = pts[3LL * row + 1], z = pts[3LL * row + 2];
    const float qx = __fsub_rn(x, __ldg(p.terms)), qy = __fsub_rn(y, __ldg(p.terms + 1)),
                qz = __fsub_rn(z, __ldg(p.terms + 2));
    const float qn = __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)), __fmul_rn(qz, qz));
    scr = valid && qn <= __ldg(p.terms + 3);  // NaN: not screened
    sh.q[rl] = make_float4(x, y, z, __int_as_float(row));
    sh.qc[rl] = make_float4(qx, qy, qz, scr ? qn : __int_as_float(0x7fc00000));
  }
  const bool any_screened = __syncthreads_or(scr);
  const unsigned screened = __ballot_sync(kFull, scr);
  const unsigned exact = __ballot_sync(kFull, r0 + threadIdx.x < p.n_rows && !scr);
  unsigned long long n_exact_pairs = 0;
  BmThread th;
  th.confirms = 0;
  // A registers (K slots 2kq, 2kq + 1 and 2kq + 8, 2kq + 9 of rows g, g + 8):
  // kq < 3 the hi / lo parts of coordinate kq of q'; kq = 3 the norm slots,
  // (1, 1) on the (1 + alpha) norm in pass 1 and on the (1 - alpha) norm in
  // pass 2. Rows that are not screened have A = 0.
#pragma unroll
  for (int mt = 0; mt < kBmMt; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 q = sh.qc[wrow + mt * 16 + g + 8 * h];
      const bool on = q.w == q.w;
      const float v = on ? (kq == 0 ? q.x : kq == 1 ? q.y : q.z) : 0.0f;
      th.a[mt][h] = kq < 3 ? bm_dup(v, false) : (on ? kBmOne2 : 0u);
      th.a[mt][2 + h] = kq < 3 ? bm_dup(v, true) : 0u;
      th.a2[mt][h] = kq < 3 ? th.a[mt][h] : 0u;
      th.a2[mt][2 + h] = kq < 3 ? th.a[mt][2 + h] : th.a[mt][h];
    }
  }
  for (int bg = blockIdx.y; bg * kBmBins < p.m; bg += gridDim.y) {
    const int b0 = bg * kBmBins;
    if (any_screened) {
      const int steps = (p.n - b0 + p.m - 1) / p.m;  // the group's first bin has the most columns
      const int ntiles = (steps + kBmSteps - 1) / kBmSteps;
#pragma unroll
      for (int mt = 0; mt < kBmMt; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rl = wrow + mt * 16 + g + 8 * h;
          const int row = __float_as_int(sh.q[rl].w);
          const int bb = row % p.m - b0;
          const bool here = p.exclude_self && sh.qc[rl].w == sh.qc[rl].w && bb >= 0 && bb < kBmBins;
          th.self_t[mt][h] = here ? row / p.m : -1;
          th.self_b[mt][h] = bb;
        }
#pragma unroll
        for (int nt = 0; nt < kBmNt; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            th.tt[mt][nt][i] = __int_as_float(0x7f800000);
            th.bd[mt][nt][i] = __int_as_float(0x7f800000);  // (+inf, b) where nothing is confirmed
            th.bj[mt][nt][i] = b0 + nt * 8 + 2 * kq + (i & 1);
          }
        }
      }
      const bool warp_screens = screened != 0u;
      bm_pass<false>(sh, p, b0, ntiles, wrow, g, kq, warp_screens, th);
      // tau = T + 2 alpha |q'|^2 + 2 beta, rounded up (a larger tau only
      // confirms more), and tau' the next float above it: v <= tau iff
      // v - tau' < 0. Pass 2's accumulator is -tau', +inf for rows that are
      // not screened (no value passes)
#pragma unroll
      for (int mt = 0; mt < kBmMt; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float qn = sh.qc[wrow + mt * 16 + g + 8 * h].w;
          const float add = __fmaf_ru(2.0f * p.alpha, qn, 2.0f * p.beta);
#pragma unroll
          for (int nt = 0; nt < kBmNt; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& t = th.tt[mt][nt][2 * h + e];
              t = qn == qn ? -nextafterf(__fadd_ru(t, add), __int_as_float(0x7f800000))
                           : __int_as_float(0x7f800000);
            }
          }
        }
      }
      bm_pass<true>(sh, p, b0, ntiles, wrow, g, kq, warp_screens, th);
      if (warp_screens) {
#pragma unroll
        for (int mt = 0; mt < kBmMt; ++mt) {
#pragma unroll
          for (int nt = 0; nt < kBmNt; ++nt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int rl = wrow + mt * 16 + g + 8 * (i >> 1);
              const int b = b0 + nt * 8 + 2 * kq + (i & 1);
              if ((screened >> (rl - wrow)) & 1u && b < p.m) {
                float d = th.bd[mt][nt][i];
                int j = th.bj[mt][nt][i];
                // the plain version starts a bin at its first column, so a
                // NaN distance there (a NaN coordinate of column b) stays
                const float4 c0 = __ldg(p.raw + b);
                if (isnan(c0.x) || isnan(c0.y) || isnan(c0.z)) {
                  const float4 q = sh.q[rl];
                  if (!(p.exclude_self && b == __float_as_int(q.w))) {
                    d = d2_diff(q.x, q.y, q.z, c0.x, c0.y, c0.z);
                    j = b;
                  }
                }
                p.d2[(r0 + rl) * p.m + b] = d;
                p.idx[(r0 + rl) * p.m + b] = j;
              }
            }
          }
        }
      }
    }
    // the exact sweep of the warp's rows the screen does not serve
    const int bl = lane & (kBmBins - 1);
    const int b = b0 + bl;
    unsigned todo = exact;
    while (todo) {
      const int ra = __ffs(todo) - 1;
      todo &= todo - 1;
      int rb = -1;
      if (todo) {
        rb = __ffs(todo) - 1;
        todo &= todo - 1;
      }
      const int rs = lane < kBmBins ? ra : rb;
      const bool act = rs >= 0 && b < p.m;
      const float4 q = sh.q[wrow + (rs >= 0 ? rs : ra)];
      const int row = __float_as_int(q.w);
      float bd = __int_as_float(0x7f800000);
      int bj = b;
      const int steps = act ? (p.n - b + p.m - 1) / p.m : 0;
      for (int t = 0;; t += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (t + u < steps) {
            const int j = b + p.m * (t + u);
            const float4 c = __ldg(p.raw + j);
            float d = d2_diff(q.x, q.y, q.z, c.x, c.y, c.z);
            if (p.exclude_self && j == row) d = __int_as_float(0x7f800000);
            if (d < bd || t + u == 0) {  // the first column starts the bin, as in the plain version
              bd = d;
              bj = j;
            }
          }
        }
        if (__all_sync(kFull, t + 4 >= steps || bd == 0.0f)) {
          n_exact_pairs += (unsigned long long)min(t + 4, steps);
          break;
        }
      }
      if (act) {
        p.d2[(r0 + wrow + rs) * p.m + b] = bd;
        p.idx[(r0 + wrow + rs) * p.m + b] = bj;
      }
    }
  }
  // counts: rows once (the first bin group's blocks), confirms and exact pairs everywhere
  const unsigned confirms = __reduce_add_sync(kFull, th.confirms);
  const unsigned long long pairs = n_exact_pairs;
  unsigned long long pairs_w = pairs;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) pairs_w += __shfl_xor_sync(kFull, pairs_w, o);
  if (lane == 0) {
    if (blockIdx.y == 0) {
      atomicAdd(p.stats, (unsigned long long)__popc(screened));
      atomicAdd(p.stats + 1, (unsigned long long)__popc(exact));
    }
    if (confirms) atomicAdd(p.stats + 2, (unsigned long long)confirms);
    if (pairs_w) atomicAdd(p.stats + 3, pairs_w);
  }
}

// The screen's accumulation, probed: d = a b + c for `tiles` 16 x 8 tiles
// by bm_mma_c, the mma.sync of knn_binmin's pass 2 (pass 1's is the same
// instruction with c = 0). a [tiles][16][16] and bt [tiles][8][16] (column
// n's 16 K values in a row) as bf16 bit patterns, c and d [tiles][16][8]
// f32; one warp a tile, fragments in the layout the kernel loads.
__global__ void __launch_bounds__(256)
bm_probe_kernel(const uint16_t* __restrict__ a, const uint16_t* __restrict__ bt, const float* __restrict__ c,
                float* __restrict__ d, int tiles) {
  const int t = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (t >= tiles) return;
  const int lane = threadIdx.x & 31, g = lane >> 2, kq = lane & 3;
  const uint16_t* at = a + 256LL * t + 2 * kq;
  const uint16_t* bc = bt + 128LL * t + 16 * g + 2 * kq;
  const auto pair = [](const uint16_t* v) { return (uint32_t)v[0] | ((uint32_t)v[1] << 16); };
  const uint32_t fa[4] = {pair(at + 16 * g), pair(at + 16 * (g + 8)), pair(at + 16 * g + 8),
                          pair(at + 16 * (g + 8) + 8)};
  const long long o0 = 128LL * t + 8 * g + 2 * kq, o1 = o0 + 64;  // rows g and g + 8, columns 2kq, 2kq + 1
  const float fc[4] = {c[o0], c[o0 + 1], c[o1], c[o1 + 1]};
  float fd[4];
  bm_mma_c(fd, fa, make_uint2(pair(bc), pair(bc + 8)), fc);
  d[o0] = fd[0];
  d[o0 + 1] = fd[1];
  d[o1] = fd[2];
  d[o1 + 1] = fd[3];
}

cudaError_t allow_smem(const void* fn) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, 3 * kChunk * (int)sizeof(float));
}

}  // namespace

extern "C" {

int slscan_nn1(const float* q, const float* base, int32_t* idx, float* d2, int pairs, int nq, int nb,
               cudaStream_t stream) {
  if (nq < 1 || nb < 1 || pairs < 1 || pairs > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((nq + kNnQueries - 1) / kNnQueries, pairs);
  nn1_kernel<<<grid, kNnThreads, 0, stream>>>(q, base, idx, d2, nq, nb);
  return (int)cudaGetLastError();
}

int slscan_radius_count(const float* pts, int n, float r2, int32_t* counts, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int32_t) * (size_t)n, stream);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  // base spans of whole tiles, as many as it takes for ~kRcBlocksPerSm blocks an SM
  const int gx = (n + kRcQueries - 1) / kRcQueries;
  const int want = max(1, (kRcBlocksPerSm * sms + gx - 1) / gx);
  const int span = min(((n + want - 1) / want + kRcTile - 1) / kRcTile * kRcTile, kRcMaxSpan);
  const dim3 grid(gx, (n + span - 1) / span);
  radius_count_kernel<<<grid, kRcThreads, 0, stream>>>(pts, n, r2, span, counts);
  return (int)cudaGetLastError();
}

int slscan_ransac_score(const float* h, const float* pm, const float* sc, float md2, int32_t* counts, int T,
                        int N, cudaStream_t stream) {
  if (T < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int32_t) * (size_t)T, stream);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  // correspondence spans of whole tiles, as many as it takes for ~kRsBlocksPerSm blocks an SM
  const int gx = (T + kRsHyps - 1) / kRsHyps;
  const int want = max(1, (kRsBlocksPerSm * sms + gx - 1) / gx);
  const int span = ((N + want - 1) / want + kRsTile - 1) / kRsTile * kRsTile;
  const dim3 grid(gx, (N + span - 1) / span);
  if ((reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(pm)) % 16 == 0) {
    ransac_score_kernel<true><<<grid, kRsThreads, 0, stream>>>(h, pm, sc, md2, counts, T, N, span);
  } else {
    ransac_score_kernel<false><<<grid, kRsThreads, 0, stream>>>(h, pm, sc, md2, counts, T, N, span);
  }
  return (int)cudaGetLastError();
}

int slscan_knn_mean(const float* pts, int L, int k, int r2b, float* mean, int32_t* cnt, cudaStream_t stream) {
  // E list entries a lane; any L >= 1 (the ragged tail is masked in the ring)
  if (L < 1 || k < 1 || k > 32 * kSelMaxSegments) return (int)cudaErrorInvalidValue;
  const int grid = (L + kSelTile - 1) / kSelTile;
  if (k <= 32) {
    knn_select_kernel<1><<<grid, kSelThreads, 0, stream>>>(pts, L, k, r2b, mean, cnt);
  } else if (k <= 64) {
    knn_select_kernel<2><<<grid, kSelThreads, 0, stream>>>(pts, L, k, r2b, mean, cnt);
  } else {
    knn_select_kernel<4><<<grid, kSelThreads, 0, stream>>>(pts, L, k, r2b, mean, cnt);
  }
  return (int)cudaGetLastError();
}

int slscan_knn_mean_bisect(const float* pts, int L, int k, int r2b, float* mean, int32_t* cnt,
                           cudaStream_t stream) {
  if (L < 1 || k < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem((const void*)knn_mean_kernel);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = 3 * sizeof(float) * (size_t)(L < kChunk ? L : kChunk);
  knn_mean_kernel<<<(L + kKnnTile - 1) / kKnnTile, kKnnThreads, smem, stream>>>(pts, L, k, r2b, mean, cnt);
  return (int)cudaGetLastError();
}

int slscan_slab_mean_knn(const float* pts, int L, int k, int r2b, int wblk, int tile, float r, float* mean,
                         int32_t* cnt, int32_t* win_end, cudaStream_t stream) {
  // whole 64-query blocks, whole 32-candidate warp steps, E list entries a lane
  if (L % kSelTile || (2 * wblk) % 32 || k < 1 || k > 32 * kSelMaxSegments) return (int)cudaErrorInvalidValue;
  const int grid = L / kSelTile;
  if (k <= 32) {
    slab_select_kernel<1><<<grid, kSelThreads, 0, stream>>>(pts, L, k, r2b, wblk, tile, r, mean, cnt, win_end);
  } else if (k <= 64) {
    slab_select_kernel<2><<<grid, kSelThreads, 0, stream>>>(pts, L, k, r2b, wblk, tile, r, mean, cnt, win_end);
  } else {
    slab_select_kernel<4><<<grid, kSelThreads, 0, stream>>>(pts, L, k, r2b, wblk, tile, r, mean, cnt, win_end);
  }
  return (int)cudaGetLastError();
}

int slscan_slab_mean_knn_bisect(const float* pts, int L, int k, int r2b, int wblk, int tile, float r, float* mean,
                                int32_t* cnt, int32_t* win_end, cudaStream_t stream) {
  cudaError_t err = allow_smem((const void*)slab_knn_mean_kernel);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = 3 * sizeof(float) * (size_t)(2 * wblk < kChunk ? 2 * wblk : kChunk);
  slab_knn_mean_kernel<<<L / kKnnTile, kKnnThreads, smem, stream>>>(pts, L, k, r2b, wblk, tile, r, mean, cnt,
                                                                    win_end);
  return (int)cudaGetLastError();
}

int slscan_knn_binmin(const float* pts, const int32_t* rows, int n_rows, int n, int m, int exclude_self,
                      const float* terms, float alpha, float beta, void* op, void* raw, float* d2, int32_t* idx,
                      unsigned long long* stats, cudaStream_t stream) {
  // a column index b + M t, padding steps included, stays below 17 n < 2^31;
  // op [n] 32-byte records and raw [n] 16-byte rows: the wrapper's scratch
  if (n_rows < 1 || n < 1 || n > (1 << 25) || m < 1 || m > n) return (int)cudaErrorInvalidValue;
  binmin_prep_kernel<<<(n + 255) / 256, 256, 0, stream>>>(pts, n, terms, alpha, static_cast<BmOp*>(op),
                                                          static_cast<float4*>(raw));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const BmArgs a{rows, n_rows, n, m, exclude_self, terms, alpha, beta, static_cast<const BmOp*>(op), static_cast<const float4*>(raw), d2, idx, stats};
  // bin groups on grid.y (a block loops over groups beyond 65535)
  const int groups = (m + kBmBins - 1) / kBmBins;
  const dim3 grid((n_rows + kBmRows - 1) / kBmRows, groups < 65535 ? groups : 65535);
  knn_binmin_kernel<<<grid, kBmThreads, 0, stream>>>(pts, a);
  return (int)cudaGetLastError();
}

int slscan_bm_mma_probe(const uint16_t* a, const uint16_t* bt, const float* c, float* d, int tiles,
                        cudaStream_t stream) {
  if (tiles < 1) return (int)cudaErrorInvalidValue;
  bm_probe_kernel<<<(tiles + 7) / 8, 256, 0, stream>>>(a, bt, c, d, tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
