// Gray-code decode kernels of the scan path, for Hopper (sm_90a).
//
// Three kernels, each a single elementwise pass with one thread per pixel
// (or per 4 pixels where the frame size allows 4-byte loads):
//
//   decode_maps_kernel     replaces the Pallas kernels _decode_kernel and
//                          _decode_kernel_views (structured_light_for_3d_
//                          model_replication_tpu/ops/pallas_kernels.py,
//                          tile math in _decode_tile): shadow/contrast mask,
//                          one pattern > inverse compare per bit, the
//                          Gray -> binary XOR cascade, the rescale shift.
//   decode_packed_kernel   replaces _decode_packed_kernel and its views twin
//                          (_decode_packed_tile): the same decode, with each
//                          bit read from packed planes, pair p at byte p>>3,
//                          bit p&7.
//   scan_fused_kernel      replaces _scan_fused_kernel: the decode, then the
//                          quadratic light-plane evaluation, the ray-plane
//                          hit and the epipolar filter, in _scan_fused_
//                          kernel's float order (sqrt and true divides, no
//                          rsqrt), writing points, valid flags and texture.
//
// What bounds them: device-memory bandwidth. Per pixel they read 46 (K1, K3)
// or 5 (K2) bytes of frames and do a few dozen integer or float operations,
// far below the card's operations-per-byte balance. So the design moves
// each byte once: neighbouring threads read neighbouring bytes of a frame
// (frames are [V, F, H*W], frame f of a view strided by H*W), 4 pixels a
// thread as one uchar4 load where H*W % 4 == 0, and every intermediate
// (the bits, the Gray value, the planes) stays in registers. The TPU
// kernels' (8, 128) tiling does not carry over: the grid is
// (pixels / (256 * vec), views) and each kernel masks the ragged edge.
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

// Unit light plane of code idx from the quadratic form at sc[base..base+11]
// (rows A, B, C of (nx, ny, nz, d)): n4(i) = A + i * (B + i * C).
__device__ __forceinline__ void poly_plane(const float* sc, int base, int idx, int downsample,
                                           int n_planes, float (&out)[4]) {
  const int ii = min(max(idx * downsample, 0), n_planes - 1);
  const float i = (float)ii;
  float comp[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) comp[c] = sc[base + c] + i * (sc[base + 4 + c] + i * sc[base + 8 + c]);
  const float nrm = sqrtf(fmaxf(comp[0] * comp[0] + comp[1] * comp[1] + comp[2] * comp[2], 1e-30f));
#pragma unroll
  for (int c = 0; c < 4; ++c) out[c] = comp[c] / nrm;
}

// scalars (f32[32]): oc xyz @0..2, epipolar tolerance @3, column-plane
// quadratic @4..15, row-plane quadratic @16..27 — _scan_fused_kernel's
// layout. rays: [H*W, 3] unit rays; pts: [V, H*W, 3].
template <int VEC>
__global__ void __launch_bounds__(kThreads)
scan_fused_kernel(const uint8_t* __restrict__ frames, const float* __restrict__ thr,
                  const float* __restrict__ scalars, const float* __restrict__ rays,
                  float* __restrict__ pts, uint8_t* __restrict__ valid,
                  uint8_t* __restrict__ tex, int n_frames, long long hw, ScanParams prm) {
  __shared__ float sc[32];
  if (threadIdx.x < 32) sc[threadIdx.x] = scalars[threadIdx.x];
  __syncthreads();
  const int v = blockIdx.y;
  const long long p = ((long long)blockIdx.x * kThreads + threadIdx.x) * VEC;
  if (p >= hw) return;
  const uint8_t* fv = frames + (long long)v * n_frames * hw + p;
  const DecodeParams& d = prm.dec;
  int32_t c[VEC], r[VEC] = {};
  decode_axis_raw<VEC>(fv, hw, d.start_col, d.n_bits_col, d.n_use_col, d.avail_col, 1, c);
  if (prm.row_mode == 1) {  // row_mode 0 never reads the row frames
    decode_axis_raw<VEC>(fv, hw, d.start_row, d.n_bits_row, d.n_use_row, d.avail_row, 1, r);
  }
  const Bytes<VEC> w = load_bytes<VEC>(fv);
  uint8_t m[VEC];
  shadow_mask<VEC>(w, load_bytes<VEC>(fv + hw), __ldg(thr + 2 * v), __ldg(thr + 2 * v + 1), m);

  const float ox = sc[0], oy = sc[1], oz = sc[2], eps = sc[3];
  float ray[3 * VEC];
#pragma unroll
  for (int j = 0; j < 3 * VEC; ++j) ray[j] = __ldg(rays + 3 * p + j);
  float out[3 * VEC];
  uint8_t ok_all[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float rx = ray[3 * k], ry = ray[3 * k + 1], rz = ray[3 * k + 2];
    float n[4];
    poly_plane(sc, 4, c[k], prm.downsample, prm.n_cols, n);
    const float denom = n[0] * rx + n[1] * ry + n[2] * rz;
    const float numer = n[0] * ox + n[1] * oy + n[2] * oz + n[3];
    const bool ok = fabsf(denom) > 1e-6f;
    const float t = ok ? -numer / denom : 0.0f;
    const float px = ox + rx * t;
    const float py = oy + ry * t;
    const float pz = oz + rz * t;
    bool keep = m[k] && ok;
    if (prm.row_mode == 1) {
      float e[4];
      poly_plane(sc, 16, r[k], prm.downsample, prm.n_rows, e);
      const float dist = fabsf(e[0] * px + e[1] * py + e[2] * pz + e[3]);
      keep = keep && (dist < eps);
    }
    out[3 * k] = px;
    out[3 * k + 1] = py;
    out[3 * k + 2] = pz;
    ok_all[k] = keep ? 1 : 0;
  }
  const long long o = (long long)v * hw + p;
  float* po = pts + 3 * o;
  if constexpr (VEC == 4) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      reinterpret_cast<float4*>(po)[j] =
          make_float4(out[4 * j], out[4 * j + 1], out[4 * j + 2], out[4 * j + 3]);
  } else {
    po[0] = out[0];
    po[1] = out[1];
    po[2] = out[2];
  }
  store_bytes<VEC>(valid + o, ok_all);
  store_bytes<VEC>(tex + o, w.v);
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
// -> pts f32 [V, H*W, 3], valid u8 [V, H*W], tex u8 [V, H*W].
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
  if (vec == 4) {
    scan_fused_kernel<4><<<grid_for(hw, n_views, 4), kThreads, 0, s>>>(f, t, sc, ry, pt, va, tx,
                                                                        n_frames, hw, prm);
  } else {
    scan_fused_kernel<1><<<grid_for(hw, n_views, 1), kThreads, 0, s>>>(f, t, sc, ry, pt, va, tx,
                                                                        n_frames, hw, prm);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
