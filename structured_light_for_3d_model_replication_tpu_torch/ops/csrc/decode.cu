// Gray-code decode kernels of the scan path, for Hopper (sm_90a).
//
// Four kernels (Pallas originals in structured_light_for_3d_model_replication_
// tpu/ops/pallas_kernels.py):
//
//   decode_maps_kernel     replaces the Pallas kernels _decode_kernel and
//                          _decode_kernel_views (tile math in _decode_tile):
//                          shadow/contrast mask, one pattern > inverse compare
//                          per bit, the Gray -> binary XOR cascade, the
//                          rescale shift.
//   decode_packed_kernel   replaces _decode_packed_kernel and its views twin
//                          (_decode_packed_tile): the same decode, with each
//                          bit read from packed planes, pair p at byte p>>3,
//                          bit p&7.
//   scan_fused_bulk_kernel replaces _scan_fused_kernel: the decode, then the
//                          quadratic light-plane evaluation, the ray-plane hit
//                          and the epipolar filter, in _scan_fused_kernel's
//                          float order (sqrt and true divides, no rsqrt),
//                          writing points, valid flags and texture. Bound by
//                          bytes: per (view, pixel) it must read the frames it
//                          decodes (46 at 11 + 11 bits) and write 14 bytes;
//                          the 12-byte ray is read once for all views. The
//                          design:
//                          - a persistent grid, one block an SM; a block takes
//                            tiles of kSfTile pixels (block b: tiles b, b + G,
//                            ...) and, for each, every view in turn;
//                          - one producer thread streams each (tile, view)'s
//                            frame rows (only the frames the decode reads: row
//                            frames not at row_mode 0) into a ring of
//                            shared-memory stages by bulk asynchronous copies
//                            (cp.async.bulk) that complete on an mbarrier, so
//                            the bytes in flight (a few stages, ~140 KB an SM)
//                            do not depend on the registers a thread holds; the
//                            consumers release a stage on a second mbarrier as
//                            soon as its words are in registers;
//                          - the tile's rays come in by one bulk copy, are read
//                            once into registers and serve all V views;
//                          - 8 consumer warps, 4 pixels a thread: one 32-bit
//                            shared-memory word a frame, the pattern > inverse
//                            compares of 4 pixels at once on bytes within the
//                            word, the Gray code gathered MSB first and turned
//                            to binary by a prefix XOR (the cascade's value);
//                          - the light planes of every code are evaluated once
//                            a block into shared-memory tables (kSfPlaneCap of
//                            each axis; a code past it is evaluated in place),
//                            by the same expression the one-pixel kernel uses;
//                          - points leave through a per-warp shared-memory
//                            scratch, so consecutive lanes store consecutive
//                            16-byte vectors; valid and texture as 4-byte words.
//                          It needs 16-byte aligned buffers, H*W % 16 == 0,
//                          at most kSfMaxBits pairs an axis and room for two
//                          stages; otherwise
//   scan_fused_kernel      takes the call: the same function, one pixel a
//                          thread, each frame byte loaded by the thread.
//
// All four are bound by device-memory bandwidth: per pixel they read 46 or
// 5 (packed) bytes and do a few dozen operations, far below the card's
// operations-per-byte balance. decode_maps_kernel and decode_packed_kernel
// move each byte once with neighbouring threads on neighbouring bytes of a
// frame (frames are [V, F, H*W], frame f of a view strided by H*W), 4 pixels
// a thread as one uchar4 load where H*W % 4 == 0, every intermediate in
// registers; the grid is (pixels / (256 * vec), views) and each kernel masks
// the ragged edge.
//
// Plain C interface for ctypes; every entry returns cudaGetLastError().
// Built without fast-math: sqrtf and '/' stay IEEE.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct DecodeParams {
  int n_bits_col, n_bits_row;  // full bit count of each axis
  int n_use_col, n_use_row;    // leading bit-planes used (1..n_bits)
  int avail_col, avail_row;    // planes present in the stack (<= n_use)
  int start_col, start_row;    // first frame (raw) or first pair (packed)
  int downsample;              // multiplies the decoded coordinate
};

struct ScanParams {
  DecodeParams dec;
  int n_cols, n_rows;  // plane counts (projector width, height)
  int row_mode;        // 0: columns only, 1: epipolar filter
  int downsample;      // plane index = clip(code * downsample, 0, n - 1)
};

template <int VEC>
struct Bytes {
  uint8_t v[VEC];
};

template <int VEC>
__device__ __forceinline__ Bytes<VEC> load_bytes(const uint8_t* __restrict__ p) {
  Bytes<VEC> out;
  if constexpr (VEC == 4) {
    const uchar4 t = __ldg(reinterpret_cast<const uchar4*>(p));
    out.v[0] = t.x;
    out.v[1] = t.y;
    out.v[2] = t.z;
    out.v[3] = t.w;
  } else {
    out.v[0] = __ldg(p);
  }
  return out;
}

template <int VEC>
__device__ __forceinline__ void store_bytes(uint8_t* __restrict__ p, const uint8_t (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<uchar4*>(p) = make_uchar4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

template <int VEC>
__device__ __forceinline__ void store_ints(int32_t* __restrict__ p, const int32_t (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// Finish one axis: the binary value of n_use bits, shifted up to n_bits
// and scaled by the pattern downsample.
__device__ __forceinline__ int32_t rescale(int32_t binary, int n_bits, int n_use, int downsample) {
  return (binary << (n_bits - n_use)) * downsample;
}

// One axis from raw frames. Bit b compares frames start+2b and start+2b+1;
// a pair past the end of a truncated stack gives g = 0. The XOR cascade
// binary_b = binary_{b-1} ^ g_b inverts the reflected Gray code MSB first.
template <int VEC>
__device__ __forceinline__ void decode_axis_raw(const uint8_t* __restrict__ fv, long long hw,
                                                int start, int n_bits, int n_use, int avail,
                                                int downsample, int32_t (&out)[VEC]) {
  int32_t bin[VEC], prev[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) bin[k] = prev[k] = 0;
  for (int b = 0; b < n_use; ++b) {
    if (b < avail) {
      const Bytes<VEC> pat = load_bytes<VEC>(fv + (long long)(start + 2 * b) * hw);
      const Bytes<VEC> inv = load_bytes<VEC>(fv + (long long)(start + 2 * b + 1) * hw);
#pragma unroll
      for (int k = 0; k < VEC; ++k) prev[k] ^= pat.v[k] > inv.v[k] ? 1 : 0;
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) bin[k] = (bin[k] << 1) | prev[k];
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) out[k] = rescale(bin[k], n_bits, n_use, downsample);
}

// One axis from packed bits: word holds plane byte j at bits 8j..8j+7, so
// pair p is bit p of the word.
template <int VEC>
__device__ __forceinline__ void decode_axis_bits(const uint64_t (&word)[VEC], int start,
                                                 int n_bits, int n_use, int avail,
                                                 int downsample, int32_t (&out)[VEC]) {
  int32_t bin[VEC], prev[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) bin[k] = prev[k] = 0;
  for (int b = 0; b < n_use; ++b) {
    if (b < avail) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) prev[k] ^= (int32_t)((word[k] >> (start + b)) & 1u);
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) bin[k] = (bin[k] << 1) | prev[k];
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) out[k] = rescale(bin[k], n_bits, n_use, downsample);
}

// Shadow and contrast mask, compared in f32 like the Pallas tile.
template <int VEC>
__device__ __forceinline__ void shadow_mask(const Bytes<VEC>& w, const Bytes<VEC>& b, float shadow,
                                            float contrast, uint8_t (&out)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float wf = (float)w.v[k];
    const float bf = (float)b.v[k];
    out[k] = (wf > shadow) && ((wf - bf) > contrast) ? 1 : 0;
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
decode_maps_kernel(const uint8_t* __restrict__ frames, const float* __restrict__ thr,
                   int32_t* __restrict__ col, int32_t* __restrict__ row,
                   uint8_t* __restrict__ mask, int n_frames, long long hw, DecodeParams prm) {
  const int v = blockIdx.y;
  const long long p = ((long long)blockIdx.x * kThreads + threadIdx.x) * VEC;
  if (p >= hw) return;  // VEC divides hw, so a live thread owns VEC pixels
  const uint8_t* fv = frames + (long long)v * n_frames * hw + p;
  int32_t c[VEC], r[VEC];
  uint8_t m[VEC];
  decode_axis_raw<VEC>(fv, hw, prm.start_col, prm.n_bits_col, prm.n_use_col, prm.avail_col,
                       prm.downsample, c);
  decode_axis_raw<VEC>(fv, hw, prm.start_row, prm.n_bits_row, prm.n_use_row, prm.avail_row,
                       prm.downsample, r);
  shadow_mask<VEC>(load_bytes<VEC>(fv), load_bytes<VEC>(fv + hw), __ldg(thr + 2 * v),
                   __ldg(thr + 2 * v + 1), m);
  const long long o = (long long)v * hw + p;
  store_ints<VEC>(col + o, c);
  store_ints<VEC>(row + o, r);
  store_bytes<VEC>(mask + o, m);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
decode_packed_kernel(const uint8_t* __restrict__ planes, const uint8_t* __restrict__ white,
                     const uint8_t* __restrict__ black, const float* __restrict__ thr,
                     int32_t* __restrict__ col, int32_t* __restrict__ row,
                     uint8_t* __restrict__ mask, int n_plane_bytes, long long hw,
                     DecodeParams prm) {
  const int v = blockIdx.y;
  const long long p = ((long long)blockIdx.x * kThreads + threadIdx.x) * VEC;
  if (p >= hw) return;
  const uint8_t* pv = planes + (long long)v * n_plane_bytes * hw + p;
  uint64_t word[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) word[k] = 0;
  for (int j = 0; j < n_plane_bytes; ++j) {
    const Bytes<VEC> by = load_bytes<VEC>(pv + (long long)j * hw);
#pragma unroll
    for (int k = 0; k < VEC; ++k) word[k] |= (uint64_t)by.v[k] << (8 * j);
  }
  int32_t c[VEC], r[VEC];
  uint8_t m[VEC];
  decode_axis_bits<VEC>(word, prm.start_col, prm.n_bits_col, prm.n_use_col, prm.avail_col,
                        prm.downsample, c);
  decode_axis_bits<VEC>(word, prm.start_row, prm.n_bits_row, prm.n_use_row, prm.avail_row,
                        prm.downsample, r);
  const long long o = (long long)v * hw + p;
  shadow_mask<VEC>(load_bytes<VEC>(white + o), load_bytes<VEC>(black + o), __ldg(thr + 2 * v),
                   __ldg(thr + 2 * v + 1), m);
  store_ints<VEC>(col + o, c);
  store_ints<VEC>(row + o, r);
  store_bytes<VEC>(mask + o, m);
}

// Unit light plane of plane index ii from the quadratic form at
// sc[base..base+11] (rows A, B, C of (nx, ny, nz, d)): n4(i) = A + i * (B + i * C).
__device__ __forceinline__ float4 plane_at(const float* sc, int base, int ii) {
  const float i = (float)ii;
  float comp[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) comp[c] = sc[base + c] + i * (sc[base + 4 + c] + i * sc[base + 8 + c]);
  const float nrm = sqrtf(fmaxf(comp[0] * comp[0] + comp[1] * comp[1] + comp[2] * comp[2], 1e-30f));
  return make_float4(comp[0] / nrm, comp[1] / nrm, comp[2] / nrm, comp[3] / nrm);
}

__device__ __forceinline__ int plane_index(int idx, int downsample, int n_planes) {
  return min(max(idx * downsample, 0), n_planes - 1);
}

// The ray-plane hit of one pixel and the epipolar test: the point and
// whether it is kept (row plane e used only at row_mode 1).
__device__ __forceinline__ bool hit(float4 n, float4 e, float rx, float ry, float rz, float ox, float oy,
                                   float oz, float eps, bool lit, int row_mode, float (&p)[3]) {
  const float denom = n.x * rx + n.y * ry + n.z * rz;
  const float numer = n.x * ox + n.y * oy + n.z * oz + n.w;
  const bool ok = fabsf(denom) > 1e-6f;
  const float t = ok ? -numer / denom : 0.0f;
  p[0] = ox + rx * t;
  p[1] = oy + ry * t;
  p[2] = oz + rz * t;
  bool keep = lit && ok;
  if (row_mode == 1) {
    const float dist = fabsf(e.x * p[0] + e.y * p[1] + e.z * p[2] + e.w);
    keep = keep && (dist < eps);
  }
  return keep;
}

// scalars (f32[32]): oc xyz @0..2, epipolar tolerance @3, column-plane
// quadratic @4..15, row-plane quadratic @16..27 — _scan_fused_kernel's
// layout. rays: [H*W, 3] unit rays; pts: [V, H*W, 3]. One pixel a thread.
__global__ void __launch_bounds__(kThreads)
scan_fused_kernel(const uint8_t* __restrict__ frames, const float* __restrict__ thr,
                  const float* __restrict__ scalars, const float* __restrict__ rays,
                  float* __restrict__ pts, uint8_t* __restrict__ valid,
                  uint8_t* __restrict__ tex, int n_frames, long long hw, ScanParams prm) {
  __shared__ float sc[32];
  if (threadIdx.x < 32) sc[threadIdx.x] = scalars[threadIdx.x];
  __syncthreads();
  const int v = blockIdx.y;
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= hw) return;
  const uint8_t* fv = frames + (long long)v * n_frames * hw + p;
  const DecodeParams& d = prm.dec;
  int32_t c[1], r[1] = {};
  decode_axis_raw<1>(fv, hw, d.start_col, d.n_bits_col, d.n_use_col, d.avail_col, 1, c);
  if (prm.row_mode == 1) {  // row_mode 0 never reads the row frames
    decode_axis_raw<1>(fv, hw, d.start_row, d.n_bits_row, d.n_use_row, d.avail_row, 1, r);
  }
  const Bytes<1> w = load_bytes<1>(fv);
  uint8_t m[1];
  shadow_mask<1>(w, load_bytes<1>(fv + hw), __ldg(thr + 2 * v), __ldg(thr + 2 * v + 1), m);
  const float4 n = plane_at(sc, 4, plane_index(c[0], prm.downsample, prm.n_cols));
  const float4 e = prm.row_mode == 1 ? plane_at(sc, 16, plane_index(r[0], prm.downsample, prm.n_rows))
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
  float out[3];
  const bool keep = hit(n, e, __ldg(rays + 3 * p), __ldg(rays + 3 * p + 1), __ldg(rays + 3 * p + 2),
                        sc[0], sc[1], sc[2], sc[3], m[0], prm.row_mode, out);
  const long long o = (long long)v * hw + p;
  pts[3 * o] = out[0];
  pts[3 * o + 1] = out[1];
  pts[3 * o + 2] = out[2];
  valid[o] = keep ? 1 : 0;
  tex[o] = w.v[0];
}

// ---------------------------------------------------------------------------
// scan_fused_bulk_kernel: bulk copies into a shared-memory ring
// ---------------------------------------------------------------------------

constexpr int kSfTile = 1024;                       // pixels a stage
constexpr int kSfPpt = 4;                           // pixels a consumer thread
constexpr int kSfConsumers = kSfTile / kSfPpt;      // consumer threads
constexpr int kSfWarps = kSfConsumers / 32;         // consumer warps
constexpr int kSfThreads = kSfConsumers + 32;       // and one producer warp
constexpr int kSfMaxStages = 6;
constexpr int kSfPlaneCap = 2048;                   // planes of an axis in a shared table
constexpr int kSfMaxBits = 16;                      // bit pairs of an axis the word decode holds
constexpr int kSfWarpOut = 32 * kSfPpt * 3;         // floats of a warp's point scratch

// Byte offsets of the dynamic shared memory: the stage ring, the tile's
// rays, the warps' point scratch, the two plane tables, the scalars, then
// the mbarriers (full[stages], empty[stages], rays full, rays empty).
struct SfLayout {
  size_t rays, out, ctab, rtab, scal, bars, total;
};

__host__ __device__ inline SfLayout sf_layout(int nf, int ccap, int rcap, int stages) {
  SfLayout l;
  l.rays = (size_t)stages * nf * kSfTile;
  l.out = l.rays + 12 * kSfTile;
  l.ctab = l.out + sizeof(float) * kSfWarps * kSfWarpOut;
  l.rtab = l.ctab + 16 * (size_t)ccap;
  l.scal = l.rtab + 16 * (size_t)rcap;
  l.bars = l.scal + 32 * sizeof(float);
  l.total = l.bars + 8 * (size_t)(2 * stages + 2);
  return l;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive and add bytes to the phase's expected transaction count.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// bytes (a multiple of 16, both addresses 16-byte aligned) global -> shared,
// completing on bar's transaction count.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Per byte of the words: a > b as bit 7 (the other bits are not defined).
// The low 7 bits compare by a subtraction that cannot borrow across bytes
// (bit 7 of d is clear exactly where a's low 7 bits exceed b's); the top
// bits decide where they differ.
__device__ __forceinline__ uint32_t bytes_gt(uint32_t a, uint32_t b) {
  const uint32_t d = (b | 0x80808080u) - (a & 0x7F7F7F7Fu);
  return (a & ~b) | (~(a ^ b) & ~d);
}

// One axis of 4 pixels from stage words: pair q at slots j0 + 2q (pattern)
// and j0 + 2q + 1 (inverse), n <= kSfMaxBits pairs. The Gray bits enter at
// bit 7 of each pixel's byte and move down one a pair, the first 8 pairs in
// hi, the rest in lo; a bit reversal then gives each pixel's Gray code MSB
// first in byte 3 - k, and the prefix XOR the binary value the cascade
// binary_b = binary_{b-1} ^ g_b builds.
__device__ __forceinline__ void decode_words(const uint8_t* st, int j0, int n, int n_bits, int32_t (&out)[4]) {
  uint32_t hi = 0, lo = 0;
#pragma unroll
  for (int q = 0; q < kSfMaxBits; ++q) {
    if (q < n) {
      const uint32_t g = bytes_gt(*reinterpret_cast<const uint32_t*>(st + (j0 + 2 * q) * kSfTile),
                                  *reinterpret_cast<const uint32_t*>(st + (j0 + 2 * q + 1) * kSfTile));
      if (q < 8) hi = ((hi >> 1) & 0x7F7F7F7Fu) | (g & 0x80808080u);
      else lo = ((lo >> 1) & 0x7F7F7F7Fu) | (g & 0x80808080u);
    }
  }
  const int n2 = max(n - 8, 0);
  const uint32_t hr = __brev(hi), lr = __brev(lo);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t b = (((hr >> (8 * (3 - k))) & 0xFFu) << n2) | ((lr >> (8 * (3 - k))) & 0xFFu);
    b ^= b >> 1;
    b ^= b >> 2;
    b ^= b >> 4;
    b ^= b >> 8;
    out[k] = (int32_t)(b << (n_bits - n));
  }
}

// Frame of stage slot j: white, black, the column pairs, then (row_mode 1)
// the row pairs.
__device__ __forceinline__ int slot_frame(int j, int uc, int start_row) {
  return j < 2 + 2 * uc ? j : start_row + (j - 2 - 2 * uc);
}

__global__ void __launch_bounds__(kSfThreads, 1)
scan_fused_bulk_kernel(const uint8_t* __restrict__ frames, const float* __restrict__ thr,
                       const float* __restrict__ scalars, const float* __restrict__ rays,
                       float* __restrict__ pts, uint8_t* __restrict__ valid, uint8_t* __restrict__ tex,
                       int n_views, int n_frames, long long hw, ScanParams prm, int stages, int ccap,
                       int rcap) {
  extern __shared__ __align__(128) uint8_t smem[];
  const DecodeParams& d = prm.dec;
  const int uc = d.n_use_col;
  const int ur = prm.row_mode == 1 ? d.n_use_row : 0;
  const int nf = 2 + 2 * uc + 2 * ur;
  const SfLayout lay = sf_layout(nf, ccap, rcap, stages);
  float* sray = reinterpret_cast<float*>(smem + lay.rays);
  float* sout = reinterpret_cast<float*>(smem + lay.out);
  float4* ctab = reinterpret_cast<float4*>(smem + lay.ctab);
  float4* rtab = reinterpret_cast<float4*>(smem + lay.rtab);
  float* sc = reinterpret_cast<float*>(smem + lay.scal);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + stages;
  uint64_t* rfull = empty + stages;
  uint64_t* rempty = rfull + 1;
  const long long ntiles = (hw + kSfTile - 1) / kSfTile;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kSfConsumers);
    }
    mbar_init(rfull, 1);
    mbar_init(rempty, kSfConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x < 32) sc[threadIdx.x] = scalars[threadIdx.x];
  __syncthreads();

  if (threadIdx.x >= kSfConsumers) {
    // the producer: one thread issues every copy
    if (threadIdx.x != kSfConsumers) return;
    int it = 0, tl = 0;
    for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++tl) {
      const long long p0 = tile * kSfTile;
      const unsigned cnt = (unsigned)min((long long)kSfTile, hw - p0);
      if (tl > 0) mbar_wait(rempty, (tl - 1) & 1);
      mbar_expect_tx(rfull, 12 * cnt);
      bulk_g2s(sray, rays + 3 * p0, 12 * cnt, rfull);
      for (int v = 0; v < n_views; ++v, ++it) {
        const int s = it % stages;
        const int round = it / stages;
        if (round > 0) mbar_wait(empty + s, (round - 1) & 1);
        mbar_expect_tx(full + s, nf * cnt);
        const uint8_t* fv = frames + (long long)v * n_frames * hw + p0;
        uint8_t* dst = smem + (size_t)s * nf * kSfTile;
        for (int j = 0; j < nf; ++j)
          bulk_g2s(dst + j * kSfTile, fv + (long long)slot_frame(j, uc, d.start_row) * hw, cnt, full + s);
      }
    }
    return;
  }

  // the consumers: 4 pixels a thread, [4 t, 4 t + 4) of the tile
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  for (int i = t; i < ccap; i += kSfConsumers) ctab[i] = plane_at(sc, 4, i);
  for (int i = t; i < rcap; i += kSfConsumers) rtab[i] = plane_at(sc, 16, i);
  asm volatile("bar.sync 1, %0;\n" ::"n"(kSfConsumers) : "memory");
  const float ox = sc[0], oy = sc[1], oz = sc[2], eps = sc[3];
  float* wout = sout + warp * kSfWarpOut;
  int it = 0, tl = 0;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++tl) {
    const long long p0 = tile * kSfTile;
    const int cnt = (int)min((long long)kSfTile, hw - p0);
    mbar_wait(rfull, tl & 1);
    float ray[12];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float4 r4 = reinterpret_cast<const float4*>(sray + 12 * t)[c];
      ray[4 * c] = r4.x;
      ray[4 * c + 1] = r4.y;
      ray[4 * c + 2] = r4.z;
      ray[4 * c + 3] = r4.w;
    }
    mbar_arrive(rempty);
    for (int v = 0; v < n_views; ++v, ++it) {
      const int s = it % stages;
      mbar_wait(full + s, (it / stages) & 1);
      const uint8_t* st = smem + (size_t)s * nf * kSfTile + kSfPpt * t;
      const uint32_t w = *reinterpret_cast<const uint32_t*>(st);
      const uint32_t b = *reinterpret_cast<const uint32_t*>(st + kSfTile);
      int32_t col[4], row[4] = {};
      decode_words(st, 2, uc, d.n_bits_col, col);
      if (ur) decode_words(st, 2 + 2 * uc, ur, d.n_bits_row, row);
      mbar_arrive(empty + s);  // the stage's words are in registers
      const float shadow = __ldg(thr + 2 * v), contrast = __ldg(thr + 2 * v + 1);
      uint32_t keep4 = 0;
      float out[12];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float wf = (float)((w >> (8 * k)) & 0xFFu);
        const float bf = (float)((b >> (8 * k)) & 0xFFu);
        const bool lit = (wf > shadow) && ((wf - bf) > contrast);
        const int ci = plane_index(col[k], prm.downsample, prm.n_cols);
        const float4 n = ci < ccap ? ctab[ci] : plane_at(sc, 4, ci);
        float4 e = make_float4(0.f, 0.f, 0.f, 0.f);
        if (prm.row_mode == 1) {
          const int ri = plane_index(row[k], prm.downsample, prm.n_rows);
          e = ri < rcap ? rtab[ri] : plane_at(sc, 16, ri);
        }
        float p[3];
        const bool keep = hit(n, e, ray[3 * k], ray[3 * k + 1], ray[3 * k + 2], ox, oy, oz, eps, lit,
                              prm.row_mode, p);
        out[3 * k] = p[0];
        out[3 * k + 1] = p[1];
        out[3 * k + 2] = p[2];
        keep4 |= (keep ? 1u : 0u) << (8 * k);
      }
      // points: lane l's 12 floats into the warp's scratch, then lane l stores
      // the warp's 16-byte vectors l, l + 32, l + 64
#pragma unroll
      for (int c = 0; c < 3; ++c)
        reinterpret_cast<float4*>(wout + 12 * lane)[c] =
            make_float4(out[4 * c], out[4 * c + 1], out[4 * c + 2], out[4 * c + 3]);
      __syncwarp();
      const long long o = (long long)v * hw + p0;
      const int pw = min(max(cnt - 32 * kSfPpt * warp, 0), 32 * kSfPpt);  // live pixels of the warp
      float4* dst = reinterpret_cast<float4*>(pts + 3 * (o + 32 * kSfPpt * warp));
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int m = lane + 32 * c;
        if (4 * m < 3 * pw) dst[m] = reinterpret_cast<const float4*>(wout)[m];
      }
      __syncwarp();
      if (kSfPpt * t < cnt) {
        *reinterpret_cast<uint32_t*>(valid + o + kSfPpt * t) = keep4;
        *reinterpret_cast<uint32_t*>(tex + o + kSfPpt * t) = w;
      }
    }
  }
}

dim3 grid_for(long long hw, int n_views, int vec) {
  const long long per_block = (long long)kThreads * vec;
  return dim3((unsigned)((hw + per_block - 1) / per_block), (unsigned)n_views);
}

}  // namespace

extern "C" {

const char* slscan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// frames u8 [V, F, H*W], thr f32 [V, 2] -> col, row i32 [V, H*W], mask u8 [V, H*W].
int slscan_decode_maps(const void* frames, const void* thr, void* col, void* row, void* mask,
                       int n_views, int n_frames, long long hw, int vec, int n_bits_col,
                       int n_bits_row, int n_use_col, int n_use_row, int avail_col,
                       int avail_row, int downsample, void* stream) {
  if (n_views == 0 || hw == 0) return 0;
  // the column pairs start at frame 2, the row pairs after the column pairs
  const DecodeParams prm{n_bits_col, n_bits_row, n_use_col,
                         n_use_row,  avail_col,  avail_row,
                         2,          2 + 2 * n_bits_col, downsample};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const uint8_t*>(frames);
  const auto* t = static_cast<const float*>(thr);
  auto* c = static_cast<int32_t*>(col);
  auto* r = static_cast<int32_t*>(row);
  auto* m = static_cast<uint8_t*>(mask);
  if (vec == 4) {
    decode_maps_kernel<4><<<grid_for(hw, n_views, 4), kThreads, 0, s>>>(f, t, c, r, m, n_frames,
                                                                         hw, prm);
  } else {
    decode_maps_kernel<1><<<grid_for(hw, n_views, 1), kThreads, 0, s>>>(f, t, c, r, m, n_frames,
                                                                         hw, prm);
  }
  return static_cast<int>(cudaGetLastError());
}

// planes u8 [V, Pb, H*W], white/black u8 [V, H*W], thr f32 [V, 2] -> as above.
int slscan_decode_packed_maps(const void* planes, const void* white, const void* black,
                              const void* thr, void* col, void* row, void* mask, int n_views,
                              int n_plane_bytes, long long hw, int vec, int n_bits_col,
                              int n_bits_row, int n_use_col, int n_use_row, int avail_col,
                              int avail_row, int downsample, void* stream) {
  if (n_views == 0 || hw == 0) return 0;
  // the column bits start at pair 0, the row bits at pair n_bits_col
  const DecodeParams prm{n_bits_col, n_bits_row, n_use_col,
                         n_use_row,  avail_col,  avail_row,
                         0,          n_bits_col, downsample};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pl = static_cast<const uint8_t*>(planes);
  const auto* wh = static_cast<const uint8_t*>(white);
  const auto* bl = static_cast<const uint8_t*>(black);
  const auto* t = static_cast<const float*>(thr);
  auto* c = static_cast<int32_t*>(col);
  auto* r = static_cast<int32_t*>(row);
  auto* m = static_cast<uint8_t*>(mask);
  if (vec == 4) {
    decode_packed_kernel<4><<<grid_for(hw, n_views, 4), kThreads, 0, s>>>(
        pl, wh, bl, t, c, r, m, n_plane_bytes, hw, prm);
  } else {
    decode_packed_kernel<1><<<grid_for(hw, n_views, 1), kThreads, 0, s>>>(
        pl, wh, bl, t, c, r, m, n_plane_bytes, hw, prm);
  }
  return static_cast<int>(cudaGetLastError());
}

// frames u8 [V, F, H*W], thr f32 [V, 2], scalars f32 [32], rays f32 [H*W, 3]
// -> pts f32 [V, H*W, 3], valid u8 [V, H*W], tex u8 [V, H*W]. vec == 4 (every
// buffer 16-byte aligned, H*W % 4 == 0) takes the bulk kernel where it fits.
int slscan_scan_fused(const void* frames, const void* thr, const void* scalars, const void* rays,
                      void* pts, void* valid, void* tex, int n_views, int n_frames, long long hw,
                      int vec, int n_bits_col, int n_bits_row, int n_use_col, int n_use_row,
                      int n_cols, int n_rows, int row_mode, int downsample, void* stream) {
  if (n_views == 0 || hw == 0) return 0;
  const ScanParams prm{{n_bits_col, n_bits_row, n_use_col, n_use_row, n_use_col, n_use_row, 2,
                        2 + 2 * n_bits_col, 1},
                       n_cols,
                       n_rows,
                       row_mode,
                       downsample};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const uint8_t*>(frames);
  const auto* t = static_cast<const float*>(thr);
  const auto* sc = static_cast<const float*>(scalars);
  const auto* ry = static_cast<const float*>(rays);
  auto* pt = static_cast<float*>(pts);
  auto* va = static_cast<uint8_t*>(valid);
  auto* tx = static_cast<uint8_t*>(tex);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(f) | reinterpret_cast<uintptr_t>(ry) |
                         reinterpret_cast<uintptr_t>(pt) | reinterpret_cast<uintptr_t>(va) |
                         reinterpret_cast<uintptr_t>(tx);
  if (vec == 4 && addr % 16 == 0 && hw % 16 == 0 && n_use_col <= kSfMaxBits && n_use_row <= kSfMaxBits) {
    const int nf = 2 + 2 * n_use_col + (row_mode == 1 ? 2 * n_use_row : 0);
    const int ccap = min(n_cols, kSfPlaneCap);
    const int rcap = row_mode == 1 ? min(n_rows, kSfPlaneCap) : 0;
    int dev = 0, sms = 0, optin = 0;
    cudaError_t err;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) != cudaSuccess)
      return (int)err;
    // as many stages as fit beside the rest, up to kSfMaxStages (8 bytes of barriers a stage pair)
    const size_t rest = sf_layout(nf, ccap, rcap, 0).total;
    const size_t per_stage = (size_t)nf * kSfTile + 16;
    const size_t fit = (size_t)optin > rest ? ((size_t)optin - rest) / per_stage : 0;
    const int stages = fit < (size_t)kSfMaxStages ? (int)fit : kSfMaxStages;
    if (stages >= 2) {
      const size_t bytes = sf_layout(nf, ccap, rcap, stages).total;
      if ((err = cudaFuncSetAttribute((const void*)scan_fused_bulk_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes)) != cudaSuccess)
        return (int)err;
      const long long ntiles = (hw + kSfTile - 1) / kSfTile;
      const int grid = (int)min(ntiles, (long long)sms);
      scan_fused_bulk_kernel<<<grid, kSfThreads, bytes, s>>>(f, t, sc, ry, pt, va, tx, n_views, n_frames, hw,
                                                             prm, stages, ccap, rcap);
      return static_cast<int>(cudaGetLastError());
    }
  }
  scan_fused_kernel<<<grid_for(hw, n_views, 1), kThreads, 0, s>>>(f, t, sc, ry, pt, va, tx, n_frames, hw,
                                                                  prm);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
