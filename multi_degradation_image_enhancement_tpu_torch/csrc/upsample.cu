// Fused bilinear x2 upsample + add for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package's decoder leaves
// `jax.image.resize(..., "bilinear") + skip` (models/cdan_fast.py, the three
// `_upsample_x2_cm` calls) to XLA, which fuses the resize with the add.  On
// the card the port ran aten's NCHW `upsample_bilinear2d` (one thread per
// output pixel looping over every N*C plane: bound by latency, at ~1.7% of
// the bytes bound at B=128*256^2) and then an eager add that read the
// upsampled tensor back.  This kernel is the fusion XLA made: one pass.
//
// Computes, for x [planes, H, W] and r, y [planes, 2H, 2W] (NCHW with
// planes = N*C):
//     y = bilinear_x2(x) + r
// half-pixel x2 bilinear (align_corners=False, as F.interpolate and
// jax.image.resize): output row 2i = 0.25*row(i-1) + 0.75*row(i), row 2i+1 =
// 0.75*row(i) + 0.25*row(i+1), indices clamped at the edges; columns alike.
// In f32, rounded once into y's type (bf16 or f32, the same type as x and r).
// Each blend is fmaf(0.75, near, 0.25*far): 0.25*far is exact, so a blend
// rounds once, and an edge row or column, whose two sources are one value, is
// copied exactly.  Rows are blended first, then columns, then r is added: both
// paths below do the same operations in the same order, so they agree bit for
// bit.
//
// Bound: device-memory bandwidth, no tensor-core work.  A pass reads x once
// and r once and writes y once: (1 + 4 + 4) * |x| elements.  The design:
// - vector path (W % 4 == 0 and x, r, y 16-byte aligned): a thread owns 8
//   consecutive output columns (4 input columns, one 16-byte bf16 store) of
//   one plane and walks down kRows input rows, keeping the rows above and
//   below in registers, so it reads kRows + 2 input rows for 2 * kRows output
//   rows; the halo columns are two scalar loads that hit L1 (the neighbour
//   thread's columns), and the rows shared with the next and previous
//   threads hit L2;
// - scalar path (any other H, W or alignment, which the per-block forward
//   meets at sizes the CM forward refuses): a thread owns one output column
//   of one plane and walks down kRows input rows the same way.
// The wrapper (ops/cuda/upsample.py) picks the path from the shape and the
// pointers; nothing else selects it.
//
// Tuning (NVIDIA H100 80GB HBM3, 700 W; the three calls of a B=128*256^2
// batch, bound 0.304 ms): kRows 1 / 2 / 4 / 8 took 0.355 / 0.347 / 0.353 /
// 0.372 ms with plain loads and stores, and 0.358 / 0.367 / 0.378 / 0.383 ms
// with evict-first hints on r and y (`__ldcs`, `__stcs`); a copy of r into y
// alone (906 of the 1,019 MB) took 0.308 ms, so kRows 2 moves bytes at the
// copy's rate.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 2;  // input rows a thread walks down: 2 * kRows output rows

// 0.25*far + 0.75*near with one rounding.
__device__ __forceinline__ float blend(float near, float far) {
  return fmaf(0.75f, near, 0.25f * far);
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Input columns j0 .. j0+3 (16-byte / 8-byte aligned) into v[1..4], with the
// clamped halo columns j0-1 and j0+4 into v[0] and v[5].
__device__ __forceinline__ void load_cols6(const float* row, int j0, int w, float v[6]) {
  const float4 m = __ldg(reinterpret_cast<const float4*>(row + j0));
  v[1] = m.x;
  v[2] = m.y;
  v[3] = m.z;
  v[4] = m.w;
  v[0] = load1(row + max(j0 - 1, 0));
  v[5] = load1(row + min(j0 + 4, w - 1));
}
__device__ __forceinline__ void load_cols6(const __nv_bfloat16* row, int j0, int w, float v[6]) {
  const uint2 m = __ldg(reinterpret_cast<const uint2*>(row + j0));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&m.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&m.y));
  v[1] = a.x;
  v[2] = a.y;
  v[3] = b.x;
  v[4] = b.y;
  v[0] = load1(row + max(j0 - 1, 0));
  v[5] = load1(row + min(j0 + 4, w - 1));
}

// 8 consecutive elements: p 16-byte aligned.
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  uint4 raw;
  auto* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// One output row's 8 columns from its row blend v[0..5] (input columns
// j0-1 .. j0+4): y = r + column blend.
template <typename T>
__device__ __forceinline__ void emit8(const float v[6], const T* r, T* y) {
  float o[8];
  load8(r, o);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    o[2 * m] += blend(v[m + 1], v[m]);
    o[2 * m + 1] += blend(v[m + 1], v[m + 2]);
  }
  store8(y, o);
}

// units = planes * chunks * (w / 4); chunks = ceil(h / kRows).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    upsample_add_vec_kernel(const T* __restrict__ x, const T* __restrict__ r, T* __restrict__ y,
                            int h, int w, unsigned chunks, unsigned units) {
  const unsigned u = blockIdx.x * kThreads + threadIdx.x;
  if (u >= units) return;
  const unsigned groups = static_cast<unsigned>(w) / 4u;
  const int g = static_cast<int>(u % groups);
  const unsigned t = u / groups;
  const int i0 = static_cast<int>(t % chunks) * kRows;
  const long long plane = t / chunks;
  const long long w2 = 2LL * w;
  const T* xp = x + plane * h * w;
  const long long out_off = plane * (2LL * h) * w2 + 8LL * g;
  const T* rp = r + out_off;
  T* yp = y + out_off;
  const int j0 = 4 * g;

  float above[6], cur[6], below[6];
  load_cols6(xp + static_cast<long long>(max(i0 - 1, 0)) * w, j0, w, above);
  load_cols6(xp + static_cast<long long>(i0) * w, j0, w, cur);
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = i0 + k;
    if (i >= h) break;
    load_cols6(xp + static_cast<long long>(min(i + 1, h - 1)) * w, j0, w, below);
    float top[6], bot[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      top[c] = blend(cur[c], above[c]);
      bot[c] = blend(cur[c], below[c]);
    }
    const long long row = 2LL * i * w2;
    emit8(top, rp + row, yp + row);
    emit8(bot, rp + row + w2, yp + row + w2);
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      above[c] = cur[c];
      cur[c] = below[c];
    }
  }
}

// units = planes * chunks * 2w; chunks = ceil(h / kRows).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    upsample_add_scalar_kernel(const T* __restrict__ x, const T* __restrict__ r,
                               T* __restrict__ y, int h, int w, unsigned chunks,
                               unsigned units) {
  const unsigned u = blockIdx.x * kThreads + threadIdx.x;
  if (u >= units) return;
  const unsigned w2 = 2u * static_cast<unsigned>(w);
  const int ox = static_cast<int>(u % w2);
  const unsigned t = u / w2;
  const int i0 = static_cast<int>(t % chunks) * kRows;
  const long long plane = t / chunks;
  const T* xp = x + plane * h * w;
  const long long out_off = plane * (2LL * h) * w2 + ox;
  const T* rp = r + out_off;
  T* yp = y + out_off;
  // The output column's two sources: near j = ox / 2, far j - 1 (even ox)
  // or j + 1 (odd ox), clamped.
  const int jn = ox >> 1;
  const int jf = (ox & 1) ? min(jn + 1, w - 1) : max(jn - 1, 0);

  const T* ra = xp + static_cast<long long>(max(i0 - 1, 0)) * w;
  const T* rc = xp + static_cast<long long>(i0) * w;
  float an = load1(ra + jn), af = load1(ra + jf);
  float cn = load1(rc + jn), cf = load1(rc + jf);
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = i0 + k;
    if (i >= h) break;
    const T* rb = xp + static_cast<long long>(min(i + 1, h - 1)) * w;
    const float bn = load1(rb + jn), bf = load1(rb + jf);
    const long long row = 2LL * i * w2;
    store1(yp + row, load1(rp + row) + blend(blend(cn, an), blend(cf, af)));
    store1(yp + row + w2, load1(rp + row + w2) + blend(blend(cn, bn), blend(cf, bf)));
    an = cn;
    af = cf;
    cn = bn;
    cf = bf;
  }
}

template <typename T>
int launch(const void* x, const void* r, void* y, int vec, long long planes, int h, int w,
           cudaStream_t s) {
  const unsigned long long chunks = (static_cast<unsigned long long>(h) + kRows - 1) / kRows;
  const unsigned long long per_row = vec ? static_cast<unsigned long long>(w) / 4
                                         : 2ULL * static_cast<unsigned long long>(w);
  const unsigned long long units = static_cast<unsigned long long>(planes) * chunks * per_row;
  if (units == 0) return 0;
  if (units > 0xFFFFFFFFULL - kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((units + kThreads - 1) / kThreads);
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(r);
  T* yt = static_cast<T*>(y);
  if (vec) {
    upsample_add_vec_kernel<T><<<blocks, kThreads, 0, s>>>(
        xt, rt, yt, h, w, static_cast<unsigned>(chunks), static_cast<unsigned>(units));
  } else {
    upsample_add_scalar_kernel<T><<<blocks, kThreads, 0, s>>>(
        xt, rt, yt, h, w, static_cast<unsigned>(chunks), static_cast<unsigned>(units));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: [planes, h, w]; r, y: [planes, 2h, 2w]; all bf16 (is_bf16) or all f32,
// contiguous.  vec: the vector path, which needs w % 4 == 0 and x, r, y
// 16-byte aligned (the wrapper checks both).
int mdie_bilinear_x2_add(const void* x, const void* r, void* y, int is_bf16, int vec,
                         long long planes, int h, int w, void* stream) {
  if (h <= 0 || w <= 0 || planes < 0 || (vec && w % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, r, y, vec, planes, h, w, s)
                 : launch<float>(x, r, y, vec, planes, h, w, s);
}

}  // extern "C"
