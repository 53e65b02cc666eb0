// Fused CBAM (inference), with the decoder's product after it, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel.  The JAX package's channel-major forward leaves
// CBAM (models/cdan_fast.py:127-159: the channel gate's pools and MLP, the
// [max, mean] compress map, the spatial gate's 7x7 conv with its BatchNorm
// folded) and the decoder's products by d3 / d2 / d1 after it (:353-367) to
// XLA, which fuses them.  On the card the port ran them as ~18 eager aten ops
// per CBAM, each over the whole tensor or its pooled vectors, rounding to
// bf16 after each: 7 reads and 2 writes of the tensor.  This kernel is the
// fusion XLA made, in four launches.
//
// Computes, for x and d [b, c, h, w] (NCHW, bf16 or f32, the same type):
//     g = sigmoid(mlp(mean_hw x) + mlp(max_hw x))            [b, c]
//     m = [max_c (x * g), mean_c (x * g)]                    [b, 2, h, w]
//     s = sigmoid(conv7x7(m, k7, zero padding 3) + bsp)      [b, 1, h, w]
//     y = ((x * g) * s) * d          (or (x * g) * s without d)
// with mlp(v) = w2 relu(w1 v + b1) + b2 (c -> cr -> c), all in f32 with f32
// weights, rounded once into y's type.
//
// Bound: device-memory bandwidth.  Three passes read x (the pools, the
// compress map, the product) and the last reads d and writes y: 5 * |x|
// elements, 4 without d; everything else (partials, gate, map) is f32 at
// 1/c of that or less.  The launches:
// 1. pool: one warp a (plane, split) unit sums and maxes a contiguous chunk
//    of one plane's h*w, 16-byte loads, neighbouring lanes on neighbouring
//    addresses; h*w is cut into `splits` chunks where b*c planes alone would
//    leave the card short of warps (3-4 rows of 64 channels);
// 2. gate: one block an image combines the splits' partials in a fixed order
//    (no float atomics: the output is deterministic), then the shared MLP
//    and the sigmoid, 1,024 threads with their loads in flight together (a
//    chain of small steps: latency, not bytes, sets its time);
// 3. compress: one block a tile of pg*8 consecutive pixels of one image;
//    thread (channel group, pixel group) walks every (256/pg)-th channel of
//    its 8 pixels, the groups' partials combined in shared memory in a
//    fixed order;
// 4. apply: one block a tw x (256/tw) pixel tile of one image and one of `cs`
//    channel ranges; it stages the map with a 3-pixel halo in shared memory,
//    computes each pixel's spatial gate once, then each thread keeps its 8
//    pixels' gates in registers and walks channels: y = x*g*s(*d), written
//    once with 16-byte stores.
// The wrapper (ops/cuda/cbam.py) picks splits, pg, tw and cs from the shape
// (`cbam_plan`) and the vector path from the width and the pointers
// (16-byte loads need w % 8 == 0 and aligned tensors; else a scalar path).
//
// Tuning (NVIDIA H100 80GB HBM3, 700 W).  The four calls of a B=128*256^2
// served forward take 1.10 ms against 0.86 ms for their bytes with x read
// three times (pool 0.22, gate 0.02, compress 0.23, apply 0.58 ms; apply moves
// its bytes at 87% of the peak).  At 3-4 rows of 256x384 each launch is a few
// microseconds and fixed per-block work decides: every further H*W split
// slows the gate's combine, every channel split of an apply tile recomputes
// its spatial gate, and small compress tiles beat idle SMs; the plan's
// thresholds come from sweeps of splits, pg and cs at both batch sizes.  A
// gate of 256 threads staging the MLP's weights in shared memory took 11.4 us
// at c = 512; 1,024 threads loading them directly take 6.8-7.9 us.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;      // consecutive pixels a thread loads at once (16 bytes of bf16)
constexpr int kTilePx = 256;   // pixels of an apply tile: one group a thread for 32 threads
constexpr int kHalo = 3;       // the 7x7 conv's reach
constexpr int kTaps = 2 * 49;  // the spatial gate's kernel: [max, mean] x 7 x 7
// the largest halo map of an apply tile, over tw in {8, 16, 32, 64}: tw = 64, 4 rows
constexpr int kHaloMax = 2 * (kTilePx / 64 + 2 * kHalo) * (64 + 2 * kHalo);
static_assert(2 * (kTilePx / 8 + 2 * kHalo) * (8 + 2 * kHalo) <= kHaloMax, "halo");
static_assert(2 * (kTilePx / 16 + 2 * kHalo) * (16 + 2 * kHalo) <= kHaloMax, "halo");
static_assert(2 * (kTilePx / 32 + 2 * kHalo) * (32 + 2 * kHalo) <= kHaloMax, "halo");

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// 8 consecutive elements, p 16-byte aligned.
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

// A group of up to 8 consecutive elements, n of them valid: the vector path
// (kVec) always has n == 8; the scalar path loads n and leaves 0 beyond.
template <bool kVec, typename T>
__device__ __forceinline__ void load_group(const T* p, int n, float v[8]) {
  if (kVec) {
    load8(p, v);
  } else {
#pragma unroll
    for (int i = 0; i < kGroup; ++i) v[i] = i < n ? load1(p + i) : 0.f;
  }
}
template <bool kVec, typename T>
__device__ __forceinline__ void store_group(T* p, int n, const float v[8]) {
  if (kVec) {
    store8(p, v);
  } else {
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      if (i < n) store1(p + i, v[i]);
    }
  }
}

__device__ __forceinline__ float sigmoid(float z) { return 1.f / (1.f + expf(-z)); }

// 1. units = planes * splits, one warp a unit: the sum and the max of x over
// [split * chunk, min(hw, (split + 1) * chunk)) of one plane; chunk % 8 == 0.
template <bool kVec, typename T>
__global__ void __launch_bounds__(kThreads)
    cbam_pool_kernel(const T* __restrict__ x, float* __restrict__ psum, float* __restrict__ pmax,
                     long long hw, long long chunk, int splits, long long units) {
  const long long u = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (u >= units) return;  // a whole warp; no block-wide barrier follows
  const int lane = threadIdx.x & 31;
  const long long begin = (u % splits) * chunk;
  const long long end = min(hw, begin + chunk);
  const T* xp = x + (u / splits) * hw;
  float sum = 0.f, mx = -INFINITY;
#pragma unroll 4
  for (long long p = begin + lane * kGroup; p < end; p += 32 * kGroup) {
    float v[8];
    const int n = static_cast<int>(min(static_cast<long long>(kGroup), end - p));
    load_group<kVec>(xp + p, n, v);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      if (kVec || i < n) {
        sum += v[i];
        mx = fmaxf(mx, v[i]);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  if (lane == 0) {
    psum[u] = sum;
    pmax[u] = mx;
  }
}

// 2. One block of 1,024 threads an image: g = sigmoid(mlp(mean) + mlp(max)).
// Each step is small, so latency sets the time, and every step keeps its
// loads independent so that they fly together: each warp combines the
// splits' partials of its channels (L lanes a channel, L = min(splits, 32)
// rounded down to a power of two; each lane sums its splits in order, then a
// fixed xor tree: deterministic); then a warp a hidden unit, lanes across
// w1's row; then a thread a channel, across its row of w2 (16-byte loads
// where cr % 4 == 0).  Dynamic shared memory: (2 * c + 2 * cr) floats.
constexpr int kGateThreads = 1024;
constexpr int kGateWarps = kGateThreads / 32;

__global__ void __launch_bounds__(kGateThreads)
    cbam_gate_kernel(const float* __restrict__ psum, const float* __restrict__ pmax, int splits,
                     float hw, const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ w2, const float* __restrict__ b2,
                     float* __restrict__ gate, int c, int cr) {
  extern __shared__ float shm[];
  float* avg = shm;
  float* mxv = shm + c;
  float* hid = shm + 2 * c;  // [relu(w1 avg + b1), relu(w1 max + b1)]
  const long long b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  int lanes = 1;
  while (lanes * 2 <= min(splits, 32)) lanes *= 2;
  const int per_step = 32 / lanes;  // channels a warp combines at once
#pragma unroll 4
  for (int base = warp * per_step; base < c; base += kGateWarps * per_step) {
    const int ch = base + lane / lanes;
    float s = 0.f, m = -INFINITY;
    if (ch < c) {
      const long long row = (b * c + ch) * splits;
      for (int k = lane % lanes; k < splits; k += lanes) {
        s += psum[row + k];
        m = fmaxf(m, pmax[row + k]);
      }
    }
    for (int o = lanes / 2; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    }
    if (ch < c && lane % lanes == 0) {
      avg[ch] = s / hw;
      mxv[ch] = m;
    }
  }
  __syncthreads();
  for (int j = warp; j < cr; j += kGateWarps) {
    const float* row = w1 + static_cast<long long>(j) * c;
    float ha = 0.f, hm = 0.f;
#pragma unroll 8
    for (int ch = lane; ch < c; ch += 32) {
      const float w = __ldg(row + ch);
      ha = fmaf(w, avg[ch], ha);
      hm = fmaf(w, mxv[ch], hm);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ha += __shfl_xor_sync(0xffffffffu, ha, o);
      hm += __shfl_xor_sync(0xffffffffu, hm, o);
    }
    if (lane == 0) {
      hid[j] = fmaxf(ha + b1[j], 0.f);
      hid[cr + j] = fmaxf(hm + b1[j], 0.f);
    }
  }
  __syncthreads();
  const bool v4 = cr % 4 == 0 && (reinterpret_cast<uintptr_t>(w2) & 15) == 0;
  for (int ch = threadIdx.x; ch < c; ch += kGateThreads) {
    const float* row = w2 + static_cast<long long>(ch) * cr;
    float oa = b2[ch], om = b2[ch];
    if (v4) {
#pragma unroll 8
      for (int j = 0; j < cr; j += 4) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(row + j));
        oa = fmaf(w.x, hid[j], oa);
        oa = fmaf(w.y, hid[j + 1], oa);
        oa = fmaf(w.z, hid[j + 2], oa);
        oa = fmaf(w.w, hid[j + 3], oa);
        om = fmaf(w.x, hid[cr + j], om);
        om = fmaf(w.y, hid[cr + j + 1], om);
        om = fmaf(w.z, hid[cr + j + 2], om);
        om = fmaf(w.w, hid[cr + j + 3], om);
      }
    } else {
#pragma unroll 8
      for (int j = 0; j < cr; ++j) {
        const float w = __ldg(row + j);
        oa = fmaf(w, hid[j], oa);
        om = fmaf(w, hid[cr + j], om);
      }
    }
    gate[b * c + ch] = sigmoid(oa + om);
  }
}

// 3. grid (tiles, b): a tile of pg * 8 consecutive pixels of one image (pg in
// {8, 16, 32}).  Thread (cg, pgi) holds pixels tile + pgi * 8 .. + 8 and walks
// channels cg, cg + 256 / pg, ...; the groups' max and sum meet in shared
// memory and are combined in the order of cg.  map: [b, 2, hw] = [max, mean].
template <bool kVec, typename T>
__global__ void __launch_bounds__(kThreads)
    cbam_compress_kernel(const T* __restrict__ x, const float* __restrict__ gate,
                         float* __restrict__ map, int c, long long hw, int pg) {
  __shared__ __align__(16) float red[2][kThreads * kGroup];
  const long long b = blockIdx.y;
  const int groups = kThreads / pg, tile_px = pg * kGroup;
  const int pgi = threadIdx.x % pg, cgi = threadIdx.x / pg;
  const long long p = static_cast<long long>(blockIdx.x) * tile_px + pgi * kGroup;
  const int n = static_cast<int>(max(0LL, min(static_cast<long long>(kGroup), hw - p)));
  float mx[kGroup], sm[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    mx[i] = -INFINITY;
    sm[i] = 0.f;
  }
  if (n > 0) {
    const T* xp = x + b * c * hw + p;
    const float* g = gate + b * c;
#pragma unroll 4
    for (int ch = cgi; ch < c; ch += groups) {
      float v[8];
      load_group<kVec>(xp + ch * hw, n, v);
      const float gc = __ldg(g + ch);
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const float t = v[i] * gc;
        mx[i] = fmaxf(mx[i], t);
        sm[i] += t;
      }
    }
  }
  float* rm = &red[0][cgi * tile_px + pgi * kGroup];
  float* rs = &red[1][cgi * tile_px + pgi * kGroup];
  reinterpret_cast<float4*>(rm)[0] = make_float4(mx[0], mx[1], mx[2], mx[3]);
  reinterpret_cast<float4*>(rm)[1] = make_float4(mx[4], mx[5], mx[6], mx[7]);
  reinterpret_cast<float4*>(rs)[0] = make_float4(sm[0], sm[1], sm[2], sm[3]);
  reinterpret_cast<float4*>(rs)[1] = make_float4(sm[4], sm[5], sm[6], sm[7]);
  __syncthreads();
  for (int q = threadIdx.x; q < tile_px; q += kThreads) {
    const long long pix = static_cast<long long>(blockIdx.x) * tile_px + q;
    if (pix >= hw) break;
    float m = -INFINITY, s = 0.f;
    for (int k = 0; k < groups; ++k) {
      m = fmaxf(m, red[0][k * tile_px + q]);
      s += red[1][k * tile_px + q];
    }
    map[b * 2 * hw + pix] = m;
    map[(b * 2 + 1) * hw + pix] = s / static_cast<float>(c);
  }
}

// 4. grid (tiles, cs, b): a tile of tr = 256 / tw rows by tw columns (tw in
// {8, 16, 32, 64}) of one image, channels [cy * cper, (cy + 1) * cper).  The
// map's tile plus a 3-pixel halo (zero outside the image, as the conv's
// padding) and the gate go to shared memory; thread q computes the spatial
// gate of tile pixel q; then thread (cg, pgi), pgi < 32, takes the 8 gates of
// its pixel group into registers and walks channels cg, cg + 8, ...
template <bool kVec, bool kHasD, typename T>
__global__ void __launch_bounds__(kThreads)
    cbam_apply_kernel(const T* __restrict__ x, const T* __restrict__ d, T* __restrict__ y,
                      const float* __restrict__ gate, const float* __restrict__ map,
                      const float* __restrict__ k7, const float* __restrict__ bsp, int c, int h,
                      int w, int tw, int tiles_w, int cper) {
  __shared__ float hmap[kHaloMax];
  __shared__ float s_tile[kTilePx];
  __shared__ float taps[kTaps + 1];
  const int tr = kTilePx / tw;
  const int hr = tr + 2 * kHalo, hc = tw + 2 * kHalo;
  const long long b = blockIdx.z;
  const int r0 = (blockIdx.x / tiles_w) * tr, c0 = (blockIdx.x % tiles_w) * tw;
  const long long hw = static_cast<long long>(h) * w;
  const float* mb = map + b * 2 * hw;
  for (int i = threadIdx.x; i < 2 * hr * hc; i += kThreads) {
    const int plane = i / (hr * hc), rem = i % (hr * hc);
    const int gy = r0 + rem / hc - kHalo, gx = c0 + rem % hc - kHalo;
    hmap[i] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                  ? mb[plane * hw + static_cast<long long>(gy) * w + gx]
                  : 0.f;
  }
  if (threadIdx.x < kTaps) taps[threadIdx.x] = k7[threadIdx.x];
  if (threadIdx.x == kTaps) taps[kTaps] = bsp[0];
  __syncthreads();
  {
    const int i = threadIdx.x / tw, j = threadIdx.x % tw;  // kThreads == kTilePx
    float acc = taps[kTaps];
#pragma unroll
    for (int plane = 0; plane < 2; ++plane) {
#pragma unroll
      for (int ky = 0; ky < 7; ++ky) {
        const float* row = hmap + (plane * hr + i + ky) * hc + j;
#pragma unroll
        for (int kx = 0; kx < 7; ++kx) acc = fmaf(taps[plane * 49 + ky * 7 + kx], row[kx], acc);
      }
    }
    s_tile[threadIdx.x] = sigmoid(acc);
  }
  __syncthreads();
  constexpr int kPixelGroups = kTilePx / kGroup;  // 32
  constexpr int kChannelGroups = kThreads / kPixelGroups;  // 8
  const int pgi = threadIdx.x % kPixelGroups, cgi = threadIdx.x / kPixelGroups;
  const int gw = tw / kGroup;
  const int ti = pgi / gw, tj = (pgi % gw) * kGroup;
  const int gy = r0 + ti, gx = c0 + tj;
  if (gy >= h || gx >= w) return;
  const int n = min(kGroup, w - gx);
  float s[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) s[i] = s_tile[ti * tw + tj + i];
  const int cbeg = blockIdx.y * cper, cend = min(c, cbeg + cper);
  const long long off0 = b * c * hw + static_cast<long long>(gy) * w + gx;
  const float* g = gate + b * c;
#pragma unroll 2
  for (int ch = cbeg + cgi; ch < cend; ch += kChannelGroups) {
    const long long off = off0 + ch * hw;
    float v[8], dv[8];
    load_group<kVec>(x + off, n, v);
    if (kHasD) load_group<kVec>(d + off, n, dv);
    const float gc = __ldg(g + ch);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      float t = v[i] * gc * s[i];
      if (kHasD) t *= dv[i];
      v[i] = t;
    }
    store_group<kVec>(y + off, n, v);
  }
}

template <bool kVec, typename T>
int launch(const T* x, const T* d, T* y, const float* w1, const float* b1, const float* w2,
           const float* b2, const float* k7, const float* bsp, float* scratch, int b, int c,
           int cr, int h, int w, int splits, int pg, int tw, int cs, cudaStream_t st) {
  const long long hw = static_cast<long long>(h) * w;
  const long long planes = static_cast<long long>(b) * c;
  float* psum = scratch;
  float* pmax = psum + planes * splits;
  float* gate = pmax + planes * splits;
  float* map = gate + planes;

  const long long per = (hw + splits - 1) / splits;
  const long long chunk = (per + kGroup - 1) / kGroup * kGroup;
  const long long units = planes * splits;
  cbam_pool_kernel<kVec, T><<<static_cast<unsigned>((units + kWarps - 1) / kWarps), kThreads, 0,
                              st>>>(x, psum, pmax, hw, chunk, splits, units);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t gate_smem = sizeof(float) * (2 * static_cast<size_t>(c) + 2 * cr);
  cbam_gate_kernel<<<b, kGateThreads, gate_smem, st>>>(psum, pmax, splits, static_cast<float>(hw),
                                                   w1, b1, w2, b2, gate, c, cr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long tile_px = static_cast<long long>(pg) * kGroup;
  const dim3 cgrid(static_cast<unsigned>((hw + tile_px - 1) / tile_px), b);
  cbam_compress_kernel<kVec, T><<<cgrid, kThreads, 0, st>>>(x, gate, map, c, hw, pg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int tr = kTilePx / tw;
  const int tiles_w = (w + tw - 1) / tw, tiles_h = (h + tr - 1) / tr;
  const int cper = (c + cs - 1) / cs;
  const dim3 agrid(static_cast<unsigned>(tiles_w) * tiles_h, cs, b);
  if (d != nullptr) {
    cbam_apply_kernel<kVec, true, T><<<agrid, kThreads, 0, st>>>(x, d, y, gate, map, k7, bsp, c,
                                                                  h, w, tw, tiles_w, cper);
  } else {
    cbam_apply_kernel<kVec, false, T><<<agrid, kThreads, 0, st>>>(x, d, y, gate, map, k7, bsp,
                                                                   c, h, w, tw, tiles_w, cper);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* x, const void* d, void* y, const float* w1, const float* b1,
                 const float* w2, const float* b2, const float* k7, const float* bsp,
                 float* scratch, int vec, int b, int c, int cr, int h, int w, int splits, int pg,
                 int tw, int cs, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(d);
  T* yt = static_cast<T*>(y);
  return vec ? launch<true, T>(xt, dt, yt, w1, b1, w2, b2, k7, bsp, scratch, b, c, cr, h, w,
                               splits, pg, tw, cs, st)
             : launch<false, T>(xt, dt, yt, w1, b1, w2, b2, k7, bsp, scratch, b, c, cr, h, w,
                                splits, pg, tw, cs, st);
}

}  // namespace

extern "C" {

// x, y (and d unless null): [b, c, h, w], all bf16 (is_bf16) or all f32,
// contiguous; w1 [cr, c], b1 [cr], w2 [c, cr], b2 [c], k7 [2, 7, 7], bsp [1]
// f32; scratch 2*b*c*splits + b*c + 2*b*h*w floats (the partial sums and
// maxima, the gate, the map).  vec: the 16-byte path, which needs w % 8 == 0
// and x, d, y 16-byte aligned (the wrapper checks both).  splits >= 1, pg in {8, 16, 32}, tw in {8, 16, 32,
// 64}, 1 <= cs <= c: the plan (ops/cuda/cbam.py `cbam_plan`).
int mdie_cbam_cm(const void* x, const void* d, void* y, const void* w1, const void* b1,
                 const void* w2, const void* b2, const void* k7, const void* bsp, void* scratch,
                 int is_bf16, int vec, int b, int c, int cr, int h, int w, int splits, int pg,
                 int tw, int cs, void* stream) {
  if (b <= 0 || b > 65535 || c <= 0 || cr < 0 || h <= 0 || w <= 0 || splits <= 0 ||
      (pg != 8 && pg != 16 && pg != 32) || (tw != 8 && tw != 16 && tw != 32 && tw != 64) ||
      cs <= 0 || cs > c || cs > 65535 || (vec && w % kGroup != 0) ||
      2 * static_cast<long long>(c) + 2 * cr > 12 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long hw = static_cast<long long>(h) * w;
  const long long units = static_cast<long long>(b) * c * splits;
  if ((units + kWarps - 1) / kWarps > 0x7FFFFFFFLL || (hw + 63) / 64 > 0x7FFFFFFFLL ||
      static_cast<long long>((w + tw - 1) / tw) * ((h + kTilePx / tw - 1) / (kTilePx / tw)) >
          0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* fw1 = static_cast<const float*>(w1);
  const auto* fb1 = static_cast<const float*>(b1);
  const auto* fw2 = static_cast<const float*>(w2);
  const auto* fb2 = static_cast<const float*>(b2);
  const auto* fk7 = static_cast<const float*>(k7);
  const auto* fbsp = static_cast<const float*>(bsp);
  auto* fs = static_cast<float*>(scratch);
  return is_bf16 ? launch_typed<__nv_bfloat16>(x, d, y, fw1, fb1, fw2, fb2, fk7, fbsp, fs, vec, b,
                                               c, cr, h, w, splits, pg, tw, cs, st)
                 : launch_typed<float>(x, d, y, fw1, fb1, fw2, fb2, fk7, fbsp, fs, vec, b, c, cr,
                                       h, w, splits, pg, tw, cs, st);
}

}  // extern "C"
