// Depthwise 3x3 convolution, plain or with GDFN's gate, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no Restormer.  The port's
// served Restormer forward (models/restormer.py, ServingForward) runs 88
// depthwise 3x3 convs a forward, 44 in MDTA (over the 3C channels of q, k, v)
// and 44 in GDFN (over the 2h channels that are then split into a and g and
// gated, gelu(a) * g).  On the card they ran on aten's NCHW depthwise kernel
// at ~14% of HBM's rate, and GDFN's GELU and product as two more eager passes
// over its output.  This kernel does each conv in one pass, and GDFN's with
// its gate in the epilogue.
//
// Computes, for NCHW x, weights wt [cin, 9] (one 3x3 a channel) and an
// optional bias [cin], with zero padding 1:
//     plain:  y[n, c] = dw(x[n, c])                  x, y [B, C, H, W]
//     gated:  y[n, c] = gelu(dw(x[n, c])) * dw(x[n, c + C])
//                                                     x [B, 2C, H, W], y [B, C, H, W]
// where dw(plane)[i, j] = bias + sum_{dy, dx} wt[3 dy + dx] * plane[i + dy - 1,
// j + dx - 1], summed in f32 in one fixed order (the bias, then the row
// above, the row, the row below, each left to right, one fmaf a tap) and
// gelu is the exact form 0.5 a (1 + erf(a / sqrt 2)) in f32; rounded once
// into y's type (bf16 or f32, the type of x, wt and bias).  Both paths below
// sum in that order, so they agree bit for bit.
//
// Bound: device-memory bandwidth, at ~9 multiply-adds an element read.  A
// call reads x once and writes y once: 3C -> 3C channels in MDTA, 2h -> h in
// GDFN, 49.42 GB a B=4*480x640 bf16 forward, 14.75 ms at 3.35 TB/s.  The
// design moves each byte once, 16 bytes at a time:
// - vector path (W % 8 == 0, x and y 16-byte aligned): a thread owns 8
//   consecutive columns of one output plane and walks down a band of `rows`
//   rows, neighbouring threads on neighbouring columns, so a warp's 16-byte
//   loads and stores are contiguous.  Each input row it loads is used at
//   once for all three output rows it touches (three partial sums of 8 in
//   registers, one completed and stored a row); its 9 weights (18 gated)
//   stay in registers.  The columns left and right of its 8 come from the
//   neighbouring lanes by warp shuffle; only lanes 0 and 31 load one of them
//   themselves.  Loads run 3 rows ahead of the sums (1 gated).  A band
//   reads its `rows` rows and the two beside it, so rows shared by two bands
//   are read twice; the plan (ops/cuda/dwconv.py, `dwconv_plan`) keeps that
//   at most 6% of the plane's rows, and neighbouring bands are neighbouring
//   blocks, so the second read can come from L2;
// - scalar path (any other width or alignment): a thread owns one column
//   and walks a band the same way, with scalar loads.
// A block takes 256 consecutive (column group, band, plane) units, so where
// planes are small (60x80: 10 column groups, 2 bands) one block covers many
// planes and the card still gets enough threads.  Nothing is allocated and
// nothing synchronises; the wrapper picks the path and the band height.
//
// Tuning (NVIDIA H100 80GB HBM3, 700 W; the 88 calls of a B=4*480x640
// forward, bound 14.75 ms): loads 2 rows ahead in both kernels took 26.7
// ms (at 480x640 the plain calls at 72-75% of their bound, the gated at
// 47-48%); 1 row ahead in both 22.0 ms, 3 ahead 26.5 ms: the gated
// kernel's 150 registers at 2 rows ahead left one block an SM, 124 at 1
// row two, while the plain kernel gained from 3 rows in flight (8.2 of the
// 88 calls' ms, against 8.5 at 1 row).  Capping the gated kernel at 128
// registers with 2 rows ahead spilled (22.7 ms); 128-thread blocks (22.9
// ms) and a gated variant with lanes in (a, g) pairs, one plane each and
// the product by shuffle (27.4 ms), lost.  The plan's band heights came
// within 3% of the best of 8 to 80 rows at each shape.  Launch bounds
// without a block count let ptxas give the gated kernel 98 registers, and
// the 88 calls took 24.1 ms; asking for one block an SM gives it 124 (two
// blocks fit all the same) and 21.4 ms; three for the plain kernel keeps
// its 80.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// input rows a thread's loads run ahead of its sums: more bytes in flight
// against fewer resident threads (registers: 80 a thread plain, 124 gated;
// the vector kernel's launch bounds ask for 3 and 1 blocks an SM)
constexpr int kAheadPlain = 3, kAheadGated = 1;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* x;
  const void* wt;
  const void* bias;  // null: no bias
  void* y;
  int c_out;  // channels of y; x has c_out (plain) or 2 * c_out (gated)
  int h, w;
  int rows;   // rows of a band
  int bands;  // ceil(h / rows)
  unsigned units;
};

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ float gelu(float a) {
  return 0.5f * a * (1.0f + erff(a * 0.70710678118654752440f));
}

// One row's 8 columns as loaded, with the halo column each side where this
// lane loads it itself (else 0), unconverted until the sums need them.
template <typename T>
struct Row;
template <>
struct Row<__nv_bfloat16> {
  uint4 v;
  unsigned short l, r;
};
template <>
struct Row<float> {
  float4 a, b;
  float l, r;
};

// p: the row's column j0 (16-byte aligned); ok: the row lies in the plane
// (else zeros: the padding); own_l / own_r: load column j0 - 1 / j0 + 8.
__device__ __forceinline__ void load_row(Row<__nv_bfloat16>& row, const __nv_bfloat16* p,
                                         bool ok, bool own_l, bool own_r) {
  const auto* s = reinterpret_cast<const unsigned short*>(p);
  row.v = ok ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
  row.l = ok && own_l ? __ldg(s - 1) : static_cast<unsigned short>(0);
  row.r = ok && own_r ? __ldg(s + 8) : static_cast<unsigned short>(0);
}
__device__ __forceinline__ void load_row(Row<float>& row, const float* p, bool ok, bool own_l,
                                         bool own_r) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  row.a = ok ? __ldg(reinterpret_cast<const float4*>(p)) : z;
  row.b = ok ? __ldg(reinterpret_cast<const float4*>(p) + 1) : z;
  row.l = ok && own_l ? __ldg(p - 1) : 0.f;
  row.r = ok && own_r ? __ldg(p + 8) : 0.f;
}

// v[1..8] = the row's columns j0 .. j0+7, v[0] and v[9] the lane's own halo
// loads (0 where it loaded none).
__device__ __forceinline__ void unpack(const Row<__nv_bfloat16>& row, float v[10]) {
  const auto* h2 = reinterpret_cast<const __nv_bfloat162*>(&row.v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    v[1 + 2 * i] = f.x;
    v[2 + 2 * i] = f.y;
  }
  v[0] = __bfloat162float(__ushort_as_bfloat16(row.l));
  v[9] = __bfloat162float(__ushort_as_bfloat16(row.r));
}
__device__ __forceinline__ void unpack(const Row<float>& row, float v[10]) {
  v[1] = row.a.x; v[2] = row.a.y; v[3] = row.a.z; v[4] = row.a.w;
  v[5] = row.b.x; v[6] = row.b.y; v[7] = row.b.z; v[8] = row.b.w;
  v[0] = row.l;
  v[9] = row.r;
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
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// acc[m] += one weight row's three taps over columns m-1, m, m+1 (v[m..m+2]).
__device__ __forceinline__ void taps8(const float v[10], const float* w3, float acc[8]) {
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    acc[m] = fmaf(w3[0], v[m], acc[m]);
    acc[m] = fmaf(w3[1], v[m + 1], acc[m]);
    acc[m] = fmaf(w3[2], v[m + 2], acc[m]);
  }
}

// One input plane's running sums for a thread's 8 columns: `done` holds
// output row r-1 and `mid` row r while input row r is awaited.
struct Sums {
  float wt[9], bias;
  float done[8], mid[8];
};

template <typename T>
__device__ __forceinline__ void init_sums(Sums& s, const T* wt, const T* bias, int ch) {
#pragma unroll
  for (int t = 0; t < 9; ++t) s.wt[t] = load1(wt + 9 * ch + t);
  s.bias = bias == nullptr ? 0.f : load1(bias + ch);
#pragma unroll
  for (int m = 0; m < 8; ++m) s.done[m] = s.mid[m] = 0.f;
}

// Input row r (v) into the sums: output row r-1 takes its last weight row
// and comes out complete in `out`; row r takes its middle one; row r+1
// starts at the bias with its first.
__device__ __forceinline__ void take_row(Sums& s, const float v[10], float out[8]) {
#pragma unroll
  for (int m = 0; m < 8; ++m) out[m] = s.done[m];
  taps8(v, s.wt + 6, out);
  taps8(v, s.wt + 3, s.mid);
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    s.done[m] = s.mid[m];
    s.mid[m] = s.bias;
  }
  taps8(v, s.wt, s.mid);
}

// The row's halo columns from the neighbouring lanes, where this lane did not
// load them itself (lanes 0 and 31) and they are not the padding (g at the
// row's ends, where v[0] / v[9] stay 0).
__device__ __forceinline__ void halo(float v[10], bool first, bool last) {
  const float from_l = __shfl_up_sync(kFull, v[8], 1);
  const float from_r = __shfl_down_sync(kFull, v[1], 1);
  if (!first) v[0] = from_l;
  if (!last) v[9] = from_r;
}

// units = planes * bands * (w / 8), planes = batch * c_out.  Every thread of
// a block runs the same rows + 2 steps (the shuffles need the whole warp);
// a thread past `units` shadows the last unit and stores nothing.
template <typename T, bool kGated>
__global__ void __launch_bounds__(kThreads, kGated ? 1 : 3) dw3x3_vec_kernel(Params p) {
  constexpr int kAhead = kGated ? kAheadGated : kAheadPlain;
  const unsigned u0 = blockIdx.x * kThreads + threadIdx.x;
  const bool live = u0 < p.units;
  const unsigned u = live ? u0 : p.units - 1;
  const int lane = threadIdx.x & 31;
  const int groups = p.w / 8;
  const int g = static_cast<int>(u % static_cast<unsigned>(groups));
  const unsigned t = u / static_cast<unsigned>(groups);
  const int i0 = static_cast<int>(t % static_cast<unsigned>(p.bands)) * p.rows;
  const long long plane = t / static_cast<unsigned>(p.bands);
  const int c = static_cast<int>(plane % p.c_out);
  const long long img = plane / p.c_out;
  const long long hw = static_cast<long long>(p.h) * p.w;
  const int j0 = 8 * g;
  const T* xa = static_cast<const T*>(p.x) + (img * (kGated ? 2 : 1) * p.c_out + c) * hw + j0;
  const T* xg = xa + static_cast<long long>(p.c_out) * hw;  // gated: channel c + c_out
  T* yp = static_cast<T*>(p.y) + plane * hw + j0;
  // lane 0 loads its left halo column itself, lane 31 its right, unless it
  // is the padding; the other lanes take theirs from their neighbours
  const bool first = lane == 0 || g == 0, last = lane == 31 || g == groups - 1;
  const bool own_l = lane == 0 && g > 0, own_r = lane == 31 && g < groups - 1;
  const int steps = p.rows + 2;  // input rows i0-1 .. i0+rows
  const int o_end = min(i0 + p.rows, p.h);

  Sums sa, sg;
  init_sums(sa, static_cast<const T*>(p.wt), static_cast<const T*>(p.bias), c);
  if (kGated) init_sums(sg, static_cast<const T*>(p.wt), static_cast<const T*>(p.bias), c + p.c_out);

  Row<T> ra[kAhead], rg[kAhead];
#pragma unroll
  for (int d = 0; d < kAhead; ++d) {
    const int r = i0 - 1 + d;
    const bool ok = r >= 0 && r < p.h && d < steps;
    const long long off = static_cast<long long>(max(r, 0)) * p.w;
    load_row(ra[d], xa + off, ok, own_l, own_r);
    if (kGated) load_row(rg[d], xg + off, ok, own_l, own_r);
  }
  for (int k0 = 0; k0 < steps; k0 += kAhead) {
#pragma unroll
    for (int d = 0; d < kAhead; ++d) {
      const int k = k0 + d;
      if (k >= steps) break;  // the same for the whole warp
      const int r = i0 - 1 + k, rn = r + kAhead;
      const bool ok = rn >= 0 && rn < p.h && k + kAhead < steps;
      const long long off = static_cast<long long>(max(rn, 0)) * p.w;
      float v[10], out[8];
      unpack(ra[d], v);
      load_row(ra[d], xa + off, ok, own_l, own_r);
      halo(v, first, last);
      take_row(sa, v, out);
      if (kGated) {
        float og[8];
        unpack(rg[d], v);
        load_row(rg[d], xg + off, ok, own_l, own_r);
        halo(v, first, last);
        take_row(sg, v, og);
#pragma unroll
        for (int m = 0; m < 8; ++m) out[m] = gelu(out[m]) * og[m];
      }
      const int o = r - 1;
      if (live && o >= i0 && o < o_end) store8(yp + static_cast<long long>(o) * p.w, out);
    }
  }
}

// One column of a band, scalar loads; the same sums in the same order as
// the vector path.
__device__ __forceinline__ void take_col(const float* wt, float bias, const float v[3],
                                         float& done, float& mid, float& out) {
  out = fmaf(wt[6], v[0], done);
  out = fmaf(wt[7], v[1], out);
  out = fmaf(wt[8], v[2], out);
  done = fmaf(wt[3], v[0], mid);
  done = fmaf(wt[4], v[1], done);
  done = fmaf(wt[5], v[2], done);
  mid = fmaf(wt[0], v[0], bias);
  mid = fmaf(wt[1], v[1], mid);
  mid = fmaf(wt[2], v[2], mid);
}

template <typename T>
__device__ __forceinline__ void load_col(const T* row, int j, int w, bool ok, float v[3]) {
  v[0] = ok && j > 0 ? load1(row + j - 1) : 0.f;
  v[1] = ok ? load1(row + j) : 0.f;
  v[2] = ok && j + 1 < w ? load1(row + j + 1) : 0.f;
}

// units = planes * bands * w.
template <typename T, bool kGated>
__global__ void __launch_bounds__(kThreads) dw3x3_scalar_kernel(Params p) {
  const unsigned u = blockIdx.x * kThreads + threadIdx.x;
  if (u >= p.units) return;
  const int j = static_cast<int>(u % static_cast<unsigned>(p.w));
  const unsigned t = u / static_cast<unsigned>(p.w);
  const int i0 = static_cast<int>(t % static_cast<unsigned>(p.bands)) * p.rows;
  const long long plane = t / static_cast<unsigned>(p.bands);
  const int c = static_cast<int>(plane % p.c_out);
  const long long img = plane / p.c_out;
  const long long hw = static_cast<long long>(p.h) * p.w;
  const T* xa = static_cast<const T*>(p.x) + (img * (kGated ? 2 : 1) * p.c_out + c) * hw;
  const T* xg = xa + static_cast<long long>(p.c_out) * hw;
  T* yp = static_cast<T*>(p.y) + plane * hw + j;
  const T* wt = static_cast<const T*>(p.wt);
  const T* bias = static_cast<const T*>(p.bias);
  float wa[9], wg[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    wa[q] = load1(wt + 9 * c + q);
    wg[q] = kGated ? load1(wt + 9 * (c + p.c_out) + q) : 0.f;
  }
  const float ba = bias == nullptr ? 0.f : load1(bias + c);
  const float bg = bias == nullptr || !kGated ? 0.f : load1(bias + c + p.c_out);
  float da = 0.f, ma = 0.f, dg = 0.f, mg = 0.f;
  const int o_end = min(i0 + p.rows, p.h);
  for (int k = 0; k < p.rows + 2; ++k) {
    const int r = i0 - 1 + k;
    const bool ok = r >= 0 && r < p.h;
    const long long off = static_cast<long long>(max(r, 0)) * p.w;
    float v[3], out;
    load_col(xa + off, j, p.w, ok, v);
    take_col(wa, ba, v, da, ma, out);
    if (kGated) {
      float og;
      load_col(xg + off, j, p.w, ok, v);
      take_col(wg, bg, v, dg, mg, og);
      out = gelu(out) * og;
    }
    const int o = r - 1;
    if (o >= i0 && o < o_end) store1(yp + static_cast<long long>(o) * p.w, out);
  }
}

template <typename T, bool kGated>
int launch(const Params& p, int vec, cudaStream_t s) {
  const unsigned blocks = (p.units + kThreads - 1) / kThreads;
  if (vec) {
    dw3x3_vec_kernel<T, kGated><<<blocks, kThreads, 0, s>>>(p);
  } else {
    dw3x3_scalar_kernel<T, kGated><<<blocks, kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: [batch, c_out * (gated ? 2 : 1), h, w]; y: [batch, c_out, h, w]; wt:
// [c_out * (gated ? 2 : 1), 9]; bias: the same channels, or null; all bf16
// (is_bf16) or all f32, contiguous.  vec: the vector path, which needs
// w % 8 == 0 and x, y 16-byte aligned (the wrapper checks both).  rows: the
// rows of a band (the plan's).
int mdie_dwconv3x3(const void* x, const void* wt, const void* bias, void* y, int is_bf16,
                   int gated, int vec, long long batch, int c_out, int h, int w, int rows,
                   void* stream) {
  if (batch <= 0 || c_out <= 0 || h <= 0 || w <= 0 || rows <= 0 || (vec && w % 8 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long bands = (h + rows - 1) / rows;
  const unsigned long long units = static_cast<unsigned long long>(batch) * c_out * bands *
                                   static_cast<unsigned long long>(vec ? w / 8 : w);
  if (units > 0xFFFFFFFFULL - kThreads) return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, wt, bias, y, c_out, h, w, rows, static_cast<int>(bands), static_cast<unsigned>(units)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return gated ? launch<__nv_bfloat16, true>(p, vec, s) : launch<__nv_bfloat16, false>(p, vec, s);
  }
  return gated ? launch<float, true>(p, vec, s) : launch<float, false>(p, vec, s);
}

}  // extern "C"
