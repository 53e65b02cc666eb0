// Trainable DenseBlock growth layer for Hopper (sm_90a): forward and backward,
// every product on the tensor cores (wgmma).
//
// Replaces: multi_degradation_image_enhancement_tpu/ops/pallas/growth_train.py
//   forward   _fwd_kernel (:86, pallas_call :588) and _fwd_kernel_tiled
//             (:288, pallas_call :638);
//   backward  _bwd_kernel (:178, pallas_call :798) and _bwd_kernel_tiled
//             (:345, pallas_call :697).
// The TPU row tiling, channel padding, lane rolls and VMEM planners were
// answers to the TPU's memory; here one forward and one backward cover both
// variants of each pass.
//
// Forward (f32 NCHW features in and out):
//   v = bf16(relu(x*a + b)), zero outside the image;  g = conv3x3(v, bf16(w)) + bias.
// The product and the sum of the affine are rounded apart (no FMA
// contraction), as the plain version computes them, so the backward's mask
// v > 0 agrees with it element for element.
//
// Backward, given dg [B, 16, H, W] (rounded to bf16, as the TPU kernel's dgs):
//   dv[c,p]  = sum_{o,tap} w[o,c,tap] * dg[o, p - tap]    (transposed 3x3 conv)
//   m        = (v > 0)  (zero outside the image and where z <= 0)
//   dx       = dv * m * a                                  (written in f32)
//   da[c]    = sum_p dv*m*x,   db[c] = sum_p dv*m
//   dw[o,c,tap] = sum_p dg[o,p] * v[c, p + tap]            (over all B*H*W pixels)
// All products are of bf16-rounded operands, accumulated in f32.  dbias =
// sum dg stays a plain f32 reduction outside (as the JAX package computes it,
// growth_train.py:873).
//
// Bound.  The forward does 2*9*16*c FLOPs a pixel and the backward twice
// that, against f32 x and g (and dg, dx) moved once: bytes bind, 0.632 ms
// (forward) and 1.105 ms (backward) for the 16 layers of a B=16 256x384
// train step at an H100's 3.35 TB/s.  At the 67 TFLOP/s FP32 peak the
// forward's FLOPs alone take 1.7 ms; on the tensor cores the products are
// a small part.  What
// binds instead is what each tile costs the SM in instructions and waits:
// the scalar f32 loads of the halo'd box and their addresses, the prologue,
// the shared stores and the barriers between them (PERF.md §6: taking
// the products out moved neither kernel much; taking the loads or the
// epilogue out did).
//
// Layout.  Both passes stage a tile's halo'd box as K-major core matrices
// without swizzle, [channel group of 8][halo pixel][8] bf16, so a core
// matrix (8 pixels of a row x 8 channels) is 128 contiguous bytes wherever
// it starts: each tap (ky, kx) is the same box read through a descriptor
// whose start moves by ky halo rows and kx pixels (dense_block.cu's growth
// layer does the same).  Tiles are 32 pixels wide, so the f32 NCHW reads are
// coalesced: the lanes of a warp take consecutive halo pixels, each lane the
// 8 channels of one group (8 loads of 128 bytes a warp, one 16-byte shared
// store a lane).  A lane's halo pixels are fixed; offsets are 32-bit within
// an image.  No wgmma sits under a branch: ptxas serialises wgmma in a
// divergent path (C7520), so padded channels and a repeated tap run as
// zeros or are not written, instead of being skipped.
//
// 1. Forward: an implicit GEMM, M = pixels, N = 16, K = 9 taps x c.  One
//    block an SM (two warpgroups) walks tiles of 32 x 16 pixels (eight M
//    tiles of 8 rows x 8 columns) and each tile's chunks of 32 channels:
//    9 wgmma m64n16k16 a 16-channel step and M tile.  The next chunk's x
//    and weights are loaded into registers while this chunk's products run.
//    Weights are packed once per call into [chunk][tap][channel group][16]
//    [8] (ops/cuda/growth_train.py pack_fwd_weights).  The epilogue adds the
//    f32 bias and writes g through shared memory, rows of 32 pixels at a time.
// 2. Backward: one kernel for both products.  A block owns 64 channels and
//    walks a fixed set of 32 x 8 pixel tiles (persistent, one block an SM);
//    per tile it loads x's 64 channels and dg's 16 channels once, with all
//    loads in flight, and stages v (activated x), bf16 dg and the tile's own
//    f32 x:
//    - dv: M = pixels, N = 32 channels a warpgroup, K = 16 o per tap: A is
//      the dg box (K-major, one shifted descriptor a tap), B the flipped,
//      transposed weights [chunk][tap][o group][64][8] (pack_dv_weights),
//      staged once per block.  The epilogue masks by the staged v > 0,
//      writes dx = dv*m*a and adds da, db into registers from the staged x.
//    - dW: M = 64 channels, N = 16, K = the tile's pixels: A is the same v
//      box and B the same dg box, both read MN-major (the transpose bit): a
//      group's 8 pixels x 8 channels are one 128-byte core matrix.  Each
//      warpgroup keeps 5 taps' m64n16 accumulators in registers across its
//      walk (warpgroup 1 repeats tap 8 and does not write the repeat).
//    The block writes its dW, da and db partials once at its end, and one
//    fixed-order pass sums them: no float atomics, so two runs agree bit
//    for bit.  Two launches a layer.
//
// Measured and not kept (PERF.md §6): two blocks an SM (spills at
// 128 registers), loading the backward's next tile during the products,
// double-buffering the forward's box so the next chunk is staged during the
// products, 16-channel forward chunks, and descriptor bases made opaque to
// the compiler: none faster.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

namespace {

namespace gt {
constexpr int G = 16;                       // growth rate the kernels are written for
constexpr int kThreads = 2 * kWarpgroup;    // two warpgroups
constexpr int kTW = 32;                     // tile width: 4 M tiles of 8 columns
constexpr int kHW = kTW + 2;                // halo row, pixels
// forward
constexpr int kFC = 32;                     // channels of a K chunk
constexpr int kFG = kFC / 8;                // channel groups of a chunk
constexpr int kFH = 16;                     // tile rows: 8 a warpgroup
constexpr int kFHalo = kHW * (kFH + 2);
constexpr int kFPix = kThreads / kFG;       // threads of a channel group
constexpr int kFPer = (kFHalo + kFPix - 1) / kFPix;
constexpr int kFWVec = 9 * kFG * G;         // 16-byte vectors of a chunk's weights
constexpr int kFWPer = (kFWVec + kThreads - 1) / kThreads;
constexpr int kFwdBlocks = 1;               // blocks an SM (registers: x in flight, see load)
constexpr int kFOPitch = kFH * kTW + 4;     // staged output: floats between channels
static_assert(kFPer <= 32, "validity mask");
static_assert(kFH == 2 * (kThreads / kTW), "the epilogue writes two rows a thread");
static_assert(G * kFOPitch <= 4 * kFG * kFHalo, "the staged output fits the box");
// backward
constexpr int kBC = 64;                     // channels of a block (dW's M)
constexpr int kBG = kBC / 8;                // channel groups: one warp each when staging
constexpr int kBH = 8;                      // tile rows
constexpr int kBHalo = kHW * (kBH + 2);
constexpr int kBPer = (kBHalo + 31) / 32;   // v box pixels of a lane
constexpr int kDPer = (kBHalo + kWarpgroup - 1) / kWarpgroup;  // dg box pixels of a thread
constexpr int kBWVec = 9 * 2 * kBC;         // 16-byte vectors of a chunk's dv weights
constexpr int kBwdBlocks = 1;               // blocks an SM (registers: a tile's loads in flight)
constexpr int kTaps0 = 5;                   // dW taps a warpgroup (0: taps 0-4; 1: 5-8 and 8 again)
constexpr int kXP = kBC + 8;                // floats between pixels of the staged x interior
constexpr int kBSmem =
    (kBG + 2) * kBHalo * 16 + kBWVec * 16 + kThreads / 32 * 2 * 32 * 4 + kTW * kBH * kXP * 4;
static_assert(kBG * 32 == kThreads, "one warp per channel group");
}  // namespace gt

// relu(f*a + b) in f32, the product and the sum rounded apart.
__device__ __forceinline__ float activate(float f, float a, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(f, a), b), 0.0f);
}

// Eight f32 rounded to bf16, as one 16-byte vector.
__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 out;
  auto* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return out;
}

// --------------------------------------------------------------------- forward
// grid = min(tiles, blocks an SM x SMs); block = 256.  Block i walks tiles i,
// i + gridDim.x, ... of the batch's (image, tile row, tile column) order and
// each tile's 32-channel chunks, one item at a time: the next item's x and
// weights are loaded into registers while this one's products run and its
// tile's epilogue writes.  x: f32 [B, c, H, W]; wk: the packed weights,
// [ceil(c / 32)][9][4][16][8] bf16 (zeros past c); g: f32 [B, 16, H, W].
__global__ void __launch_bounds__(gt::kThreads, gt::kFwdBlocks)
growth_fwd_kernel(const float* __restrict__ x, int c, int H, int W, int tiles_w,
                  int tiles_per_img, int n_tiles, const float* __restrict__ a,
                  const float* __restrict__ b, const uint4* __restrict__ wk,
                  const float* __restrict__ bias, float* __restrict__ g) {
  using namespace gt;
  __shared__ __align__(128) uint4 sa[kFG * kFHalo];  // [group][halo pixel]
  __shared__ __align__(128) uint4 sb[kFWVec];        // [tap][group][o]
  const int tid = threadIdx.x, wg = tid / kWarpgroup;
  const int warp = tid % kWarpgroup / 32, lane = tid % 32;
  const long long plane = (long long)H * W;
  const int plane32 = H * W;
  const int n_chunks = (c + kFC - 1) / kFC;

  // What this thread stages: channel group sg of each chunk, halo pixels
  // tid % 64 + 64 i (the lanes of a warp on consecutive pixels), and weight
  // vectors tid + 256 i.
  const int sg = tid / kFPix;
  uint32_t exists = 0;
#pragma unroll
  for (int i = 0; i < kFPer; ++i)
    if (tid % kFPix + i * kFPix < kFHalo) exists |= 1u << i;
  uint4* sa_mine = sa + sg * kFHalo + tid % kFPix;

  float raw[kFPer][8];  // the next item's x, zero where not read
  uint4 rw[kFWPer];     // ... and weights
  uint32_t inside = 0;  // ... which of raw's pixels lie in the image
  auto load = [&](int tile, int kc) {
    const int img = tile / tiles_per_img, rem = tile - img * tiles_per_img;
    const int x0 = rem % tiles_w * kTW, y0 = rem / tiles_w * kFH;
    const int cg = kc * kFC + 8 * sg, n = min(8, c - cg);
    const float* ximg = x + (long long)img * c * plane;  // 32-bit offsets within an image
    inside = 0;
#pragma unroll
    for (int i = 0; i < kFPer; ++i) {
      const int hp = tid % kFPix + i * kFPix;
      const int gy = y0 - 1 + hp / kHW, gx = x0 - 1 + hp % kHW;
      const bool in = (exists >> i & 1u) && gy >= 0 && gy < H && gx >= 0 && gx < W;
      if (in) inside |= 1u << i;
      const int nn = in ? n : 0, e0 = cg * plane32 + gy * W + gx;
#pragma unroll
      for (int j = 0; j < 8; ++j) raw[i][j] = j < nn ? __ldg(ximg + (e0 + j * plane32)) : 0.0f;
    }
    const uint4* wchunk = wk + (long long)kc * kFWVec;
#pragma unroll
    for (int i = 0; i < kFWPer; ++i)
      if (tid + i * kThreads < kFWVec) rw[i] = __ldg(wchunk + tid + i * kThreads);
  };
  auto stage = [&](int kc) {  // the prologue, once per element, into shared memory
    const int cg = kc * kFC + 8 * sg, n = min(8, c - cg);
    float fa[8], fb[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      fa[j] = j < n ? __ldg(a + cg + j) : 0.0f;
      fb[j] = j < n ? __ldg(b + cg + j) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kFPer; ++i) {
      if (exists >> i & 1u) {
        // raw, fa and fb are 0 past c, so activate gives 0 there; outside
        // the image the box holds 0, not relu(b).
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = activate(raw[i][j], fa[j], fb[j]);
        sa_mine[i * kFPix] = (inside >> i & 1u) ? pack8(v) : make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int i = 0; i < kFWPer; ++i)
      if (tid + i * kThreads < kFWVec) sb[tid + i * kThreads] = rw[i];
  };

  // Descriptors of this warpgroup's first window (its 8 rows) and of the
  // weights; a tap, M tile or K step moves the start (16-byte units).
  const uint64_t desc_a0 = smem_desc_interleave(&sa[wg * 8 * kHW], kFHalo * 16, kHW * 16);
  const uint64_t desc_b0 = smem_desc_interleave(sb, G * 16, 128);
  float acc[4][8];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[mt][i] = 0.0f;

  int tile = blockIdx.x, kc = 0;
  if (tile < n_tiles) load(tile, 0);
  while (tile < n_tiles) {
    __syncthreads();  // the previous item's products and epilogue have read sa and sb
    stage(kc);
    fence_proxy_async();  // the generic-proxy writes are seen by wgmma
    __syncthreads();
    const int next_tile = kc + 1 < n_chunks ? tile : tile + gridDim.x;
    const int next_kc = kc + 1 < n_chunks ? kc + 1 : 0;
    if (next_tile < n_tiles) load(next_tile, next_kc);  // in flight during the products

    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kFC / 16; ++ks) {  // channels past c are zeros in sa and sb
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap % 3;
        const uint64_t desc_b = desc_b0 + (tap * kFG + 2 * ks) * G;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          wgmma_bf16<G, 0, 0>(acc[mt], desc_a0 + 2 * ks * kFHalo + ky * kHW + 8 * mt + kx, desc_b);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) fence_regs<8>(acc[mt]);

    if (kc + 1 == n_chunks) {
      // Epilogue: row m = 16*warp + lane/4 + 8h of M tile mt is tile pixel
      // (8*wg + 2*warp + h, 8*mt + lane/4); columns o = 8j + 2(lane%4) + e.
      // Staged as [o][row][column], then written a row of 32 pixels at a time.
      __syncthreads();  // both warpgroups' products have read sa
      float* staged = reinterpret_cast<float*>(sa);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              staged[(8 * j + 2 * (lane % 4) + e) * kFOPitch + (8 * wg + 2 * warp + h) * kTW +
                     8 * mt + lane / 4] = acc[mt][4 * j + 2 * h + e];
              acc[mt][4 * j + 2 * h + e] = 0.0f;
            }
      __syncthreads();
      // Thread (row r0, column col) writes rows r0 and r0 + 8 of all 16 outputs.
      const int img = tile / tiles_per_img, rem = tile - img * tiles_per_img;
      const int col = tid % kTW, r0 = tid / kTW;
      const int xx = rem % tiles_w * kTW + col, y = rem / tiles_w * kFH + r0;
      float* gp = g + (long long)img * G * plane + (long long)y * W + xx;
      float bo[G];
#pragma unroll
      for (int o = 0; o < G; ++o) bo[o] = __ldg(bias + o);
#pragma unroll
      for (int rr = 0; rr < kFH / (kThreads / kTW); ++rr) {
        const int row = r0 + rr * (kThreads / kTW);
        if (y + row - r0 < H && xx < W) {
#pragma unroll
          for (int o = 0; o < G; ++o)
            gp[o * plane + (long long)(row - r0) * W] = staged[o * kFOPitch + row * kTW + col] + bo[o];
        }
      }
    }
    tile = next_tile;
    kc = next_kc;
  }
}

// -------------------------------------------------------------------- backward
// grid = (n_groups, c_pad / 64); block = 256; dynamic shared memory kBSmem.
// Block (gi, ch) owns channels [64 ch, 64 ch + 64) and pixel tiles gi,
// gi + n_groups, ... of the batch's tiles_w x tiles_h x B.  wdv: the packed
// dv weights [c_pad / 64][9][2][64][8] bf16, wdv[.][ky*3+kx][og][cl][oi] =
// w[8 og + oi, 64 ch + cl, 2 - ky, 2 - kx] (zeros past c).  part: f32
// [n_groups, part_cols], a block's dW at ((c * 9 + tap) * 16 + o), da at
// c_pad * 144 + c, db at c_pad * 145 + c.
__global__ void __launch_bounds__(gt::kThreads, gt::kBwdBlocks)
growth_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dg, int c, int c_pad,
                  int H, int W, int tiles_w, int tiles_per_img, int n_tiles,
                  const float* __restrict__ a, const float* __restrict__ b,
                  const uint4* __restrict__ wdv, float* __restrict__ dx,
                  float* __restrict__ part, int part_cols) {
  using namespace gt;
  extern __shared__ __align__(128) uint4 smem[];
  uint4* sv = smem;                    // [channel group][halo pixel]: v
  uint4* sd = sv + kBG * kBHalo;       // [o group][halo pixel]: bf16 dg
  uint4* sw = sd + 2 * kBHalo;         // [tap][o group][64 channels]: dv weights
  float* red = reinterpret_cast<float*>(sw + kBWVec);  // [warp][da, db][32]
  float* xs = red + kThreads / 32 * 2 * 32;             // [tile pixel][kXP]: x, f32
  const int tid = threadIdx.x, wg = tid / kWarpgroup;
  const int warp = tid % kWarpgroup / 32, lane = tid % 32;
  const int c0 = blockIdx.y * kBC;
  const long long plane = (long long)H * W;
  const int plane32 = H * W;

  for (int v = tid; v < kBWVec; v += kThreads) sw[v] = __ldg(wdv + (long long)blockIdx.y * kBWVec + v);

  // Staging roles: warp vg stages channel group vg of v, lanes on pixels
  // lane + 32 i; thread tid stages o group tid / 128 of dg, pixels tid % 128
  // + 128 i.
  const int vg = tid / 32, cgv = c0 + 8 * vg, nv = min(8, c - cgv);
  const int og = tid / kWarpgroup;
  // Epilogue roles: warpgroup wg takes channels 32 wg + 8j + 2(lane%4) + e
  // of the chunk (their a in fa8, index 2j + e).  dW roles: warpgroup 0 taps
  // [0, 5), warpgroup 1 [5, 9) and tap 8 once more, so that both run the same
  // products with no branch around them (a branch serialises wgmma); the
  // repeat is not written.
  float fa8[8];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ch = c0 + 32 * wg + 8 * j + 2 * (lane % 4) + e;
      fa8[2 * j + e] = ch < c ? __ldg(a + ch) : 0.0f;
    }
  const int tap0 = wg * kTaps0, ntaps = wg ? 9 - kTaps0 : kTaps0;
  int tap_off[kTaps0];  // a tap's shift of the v box, in pixels
#pragma unroll
  for (int t = 0; t < kTaps0; ++t) {
    const int tap = min(tap0 + t, 8);
    tap_off[t] = tap / 3 * kHW + tap % 3;
  }

  // Descriptors.  dv: A = the dg box K-major (o groups kBHalo apart, 8-row
  // groups one halo row apart), B = this warpgroup's 32 channels of the
  // weights.  dW: A = the v box and B = the dg box, MN-major, where LBO is
  // the stride of 8-pixel K groups (128 bytes) and SBO that of channel or o
  // groups (kBHalo pixels; hopper_wgmma.cuh).
  const uint64_t dv_a0 = smem_desc_interleave(sd, kBHalo * 16, kHW * 16);
  const uint64_t dv_b0 = smem_desc_interleave(sw + 32 * wg, kBC * 16, 128);
  const uint64_t dw_a0 = smem_desc_interleave(sv, 128, kBHalo * 16);
  const uint64_t dw_b0 = smem_desc_interleave(sd, 128, kBHalo * 16);

  float accw[kTaps0][8];
#pragma unroll
  for (int t = 0; t < kTaps0; ++t)
#pragma unroll
    for (int i = 0; i < 8; ++i) accw[t][i] = 0.0f;
  float pa[8], pb[8];  // da, db of this thread's channels, index 2j + e
#pragma unroll
  for (int k = 0; k < 8; ++k) pa[k] = pb[k] = 0.0f;

  // The tile's x (this thread's channel group, zero where not read) and dg,
  // all loads in flight at once.
  float rawv[kBPer][8], rawd[kDPer][8];
  uint32_t inside_v = 0;  // which of rawv's pixels lie in the image
  auto load = [&](int tile) {
    const int img = tile / tiles_per_img, rem = tile - img * tiles_per_img;
    const int x0 = rem % tiles_w * kTW, y0 = rem / tiles_w * kBH;
    const float* ximg = x + (long long)img * c * plane;  // 32-bit offsets within an image
    inside_v = 0;
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int hp = lane + 32 * i;
      const int gy = y0 - 1 + hp / kHW, gx = x0 - 1 + hp % kHW;
      const bool in = hp < kBHalo && gy >= 0 && gy < H && gx >= 0 && gx < W;
      if (in) inside_v |= 1u << i;
      const int nn = in ? nv : 0, e0 = cgv * plane32 + gy * W + gx;
#pragma unroll
      for (int j = 0; j < 8; ++j) rawv[i][j] = j < nn ? __ldg(ximg + (e0 + j * plane32)) : 0.0f;
    }
    const float* dgimg = dg + (long long)img * G * plane;
#pragma unroll
    for (int i = 0; i < kDPer; ++i) {
      const int hp = tid % kWarpgroup + kWarpgroup * i;
      const int gy = y0 - 1 + hp / kHW, gx = x0 - 1 + hp % kHW;
      const bool in = hp < kBHalo && gy >= 0 && gy < H && gx >= 0 && gx < W;
      const int nn = in ? 8 : 0, e0 = 8 * og * plane32 + gy * W + gx;
#pragma unroll
      for (int j = 0; j < 8; ++j) rawd[i][j] = j < nn ? __ldg(dgimg + (e0 + j * plane32)) : 0.0f;
    }
  };
  auto stage = [&]() {  // the prologue, once per element, into shared memory
    float fa[8], fb[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      fa[j] = j < nv ? __ldg(a + cgv + j) : 0.0f;
      fb[j] = j < nv ? __ldg(b + cgv + j) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      if (lane + 32 * i < kBHalo) {
        float v[8];  // 0 past c (raw, fa, fb are 0 there); 0 outside the image
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = activate(rawv[i][j], fa[j], fb[j]);
        sv[vg * kBHalo + lane + 32 * i] = (inside_v >> i & 1u) ? pack8(v) : make_uint4(0, 0, 0, 0);
        const int hy = (lane + 32 * i) / kHW, hx = (lane + 32 * i) % kHW;
        if (hy >= 1 && hy <= kBH && hx >= 1 && hx <= kTW) {  // the tile's own pixels
          float4* dst = reinterpret_cast<float4*>(xs + ((hy - 1) * kTW + hx - 1) * kXP + 8 * vg);
          dst[0] = make_float4(rawv[i][0], rawv[i][1], rawv[i][2], rawv[i][3]);
          dst[1] = make_float4(rawv[i][4], rawv[i][5], rawv[i][6], rawv[i][7]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kDPer; ++i)
      if (tid % kWarpgroup + kWarpgroup * i < kBHalo)
        sd[og * kBHalo + tid % kWarpgroup + kWarpgroup * i] = pack8(rawd[i]);
  };

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int img = tile / tiles_per_img, rem = tile - img * tiles_per_img;
    const int x0 = rem % tiles_w * kTW, y0 = rem / tiles_w * kBH;
    load(tile);
    __syncthreads();  // the previous tile's products and epilogue have read the boxes
    stage();
    fence_proxy_async();
    __syncthreads();

    // Two rounds of two M tiles each; dW's 16 K steps (the tile's rows, 16
    // pixels a step) are split between the rounds.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float accv[2][16];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int i = 0; i < 16; ++i) accv[q][i] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // channels past c have zero weights
        const int mt = 2 * r + q;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int ky = tap / 3, kx = tap % 3;
          wgmma_bf16<32, 0, 0>(accv[q], dv_a0 + ky * kHW + 8 * mt + kx, dv_b0 + tap * 2 * kBC);
        }
      }
#pragma unroll
      for (int t = 0; t < kTaps0; ++t) {
#pragma unroll
        for (int ks = 8 * r; ks < 8 * r + 8; ++ks) {
          const int row = ks / 2, col = 16 * (ks % 2);
          wgmma_bf16<G, 1, 1>(accw[t], dw_a0 + row * kHW + col + tap_off[t],
                              dw_b0 + (row + 1) * kHW + col + 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int q = 0; q < 2; ++q) fence_regs<16>(accv[q]);
#pragma unroll
      for (int t = 0; t < kTaps0; ++t) fence_regs<8>(accw[t]);

      // Epilogue of M tiles 2r, 2r + 1: row m = 16*warp + lane/4 + 8h is
      // tile pixel (2*warp + h, 8*mt + lane/4); column 8j + 2(lane%4) + e is
      // channel c0 + 32*wg + 8j + 2(lane%4) + e.  The mask and x come from
      // shared memory (v is zero outside the image and past c, so da and db
      // need no other test); dx is written where it exists.
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int mt = 2 * r + q, xx = x0 + 8 * mt + lane / 4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int y = y0 + 2 * warp + h, p = (2 * warp + h) * kTW + 8 * mt + lane / 4;
          const bool in = y < H && xx < W;
          const int hp = (2 * warp + h + 1) * kHW + 8 * mt + lane / 4 + 1;
          float* dxp = dx + (long long)img * c * plane + (long long)y * W + xx;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int cl = 32 * wg + 8 * j + 2 * (lane % 4);
            const __nv_bfloat162 m2 =
                reinterpret_cast<const __nv_bfloat162*>(sv + (cl / 8) * kBHalo + hp)[lane % 4];
            const float2 xv = *reinterpret_cast<const float2*>(xs + p * kXP + cl);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float mv = __bfloat162float(e ? m2.y : m2.x);
              const float dvm = mv > 0.0f ? accv[q][4 * j + 2 * h + e] : 0.0f;
              pa[2 * j + e] += dvm * (e ? xv.y : xv.x);
              pb[2 * j + e] += dvm;
              if (in && c0 + cl + e < c) dxp[(long long)(c0 + cl + e) * plane] = dvm * fa8[2 * j + e];
            }
          }
        }
      }
    }
  }

  // da, db: sum over the lanes that share lane % 4, then over the warpgroup's
  // four warps, in a fixed order.
#pragma unroll
  for (int k = 0; k < 8; ++k) {
#pragma unroll
    for (int s = 4; s < 32; s <<= 1) {
      pa[k] += __shfl_xor_sync(0xffffffffu, pa[k], s);
      pb[k] += __shfl_xor_sync(0xffffffffu, pb[k], s);
    }
  }
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[(tid / 32 * 2 + 0) * 32 + 8 * j + 2 * lane + e] = pa[2 * j + e];
        red[(tid / 32 * 2 + 1) * 32 + 8 * j + 2 * lane + e] = pb[2 * j + e];
      }
  }
  __syncthreads();
  float* mine = part + (long long)blockIdx.x * part_cols;
  if (tid < 128) {  // (warpgroup, da or db, channel) = (tid / 64, tid / 32 % 2, tid % 32)
    const int hw = tid / 64, which = tid / 32 % 2, cl = tid % 32;
    float s = 0.0f;
    for (int w = 0; w < 4; ++w) s += red[((4 * hw + w) * 2 + which) * 32 + cl];
    mine[c_pad * (144 + which) + c0 + 32 * hw + cl] = s;
  }
  // dW: row m = 16*warp + lane/4 + 8h is channel c0 + m; column o = 8j + 2(lane%4) + e.
#pragma unroll
  for (int t = 0; t < kTaps0; ++t) {
    if (t >= ntaps) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ch = c0 + 16 * warp + lane / 4 + 8 * h, o = 8 * j + 2 * (lane % 4) + e;
          mine[((long long)ch * 9 + tap0 + t) * G + o] = accw[t][4 * j + 2 * h + e];
        }
  }
}

// Sum the blocks' partials, in a fixed order, into dw (OIHW), da and db:
// thread (tx, ty) sums rows ty, ty + 32, ... of column j, then row 0 of the
// block adds the 32 partial sums.  grid = ceil(cols / 32); block = (32, 32).
constexpr int kSumRows = 32;

__global__ void __launch_bounds__(32 * kSumRows)
growth_bwd_sum_kernel(const float* __restrict__ part, int rows, int cols, int c, int c_pad,
                      float* __restrict__ dw, float* __restrict__ da, float* __restrict__ db) {
  __shared__ float sums[kSumRows][33];
  const int j = blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (j < cols) {
    for (int i = threadIdx.y; i < rows; i += kSumRows) s += part[(long long)i * cols + j];
  }
  sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || j >= cols) return;
  float t = 0.0f;
  for (int k = 0; k < kSumRows; ++k) t += sums[k][threadIdx.x];
  if (j < c_pad * 144) {
    const int ch = j / 144, tap = j / 16 % 9, o = j % 16;
    if (ch < c) dw[((long long)o * c + ch) * 9 + tap] = t;
  } else if (j < c_pad * 145) {
    if (j - c_pad * 144 < c) da[j - c_pad * 144] = t;
  } else if (j - c_pad * 145 < c) {
    db[j - c_pad * 145] = t;
  }
}

struct BwdGrid {
  int tiles_w, tiles_per_img, n_tiles, chunks, c_pad, n_groups, cols;
};

// The backward's tiles and blocks: kBwdBlocks an SM in all (one wave,
// persistent), at most one group per tile.
BwdGrid bwd_grid(int batch, int c, int h, int w) {
  BwdGrid g;
  g.tiles_w = (w + gt::kTW - 1) / gt::kTW;
  g.tiles_per_img = g.tiles_w * ((h + gt::kBH - 1) / gt::kBH);
  g.n_tiles = batch * g.tiles_per_img;
  g.chunks = (c + gt::kBC - 1) / gt::kBC;
  g.c_pad = g.chunks * gt::kBC;
  const int want = (gt::kBwdBlocks * sm_count() + g.chunks - 1) / g.chunks;
  g.n_groups = want < g.n_tiles ? want : g.n_tiles;
  g.cols = g.c_pad * (9 * gt::G + 2);
  return g;
}

// The kernels index within an image in 32 bits: (c + 64) * h * w stays below
// 2^31 (a chunk's channels may run 63 past c).
bool shape_ok(int batch, int c, int h, int w) {
  return batch > 0 && batch <= 65535 && c > 0 && h > 0 && w > 0 &&
         (long long)(c + gt::kBC) * h * w < (1ll << 31);
}

}  // namespace

extern "C" {

// x: f32 [batch, c, h, w]; a, b: f32 [c]; wk: bf16 [ceil(c / 32)][9][4][16][8]
// (ops/cuda/growth_train.py pack_fwd_weights); bias: f32 [16];
// g: f32 [batch, 16, h, w].
int mdie_growth_fwd(const void* x, int batch, int c, int h, int w, const void* a, const void* b,
                    const void* wk, const void* bias, void* g, void* stream) {
  if (!shape_ok(batch, c, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_w = (w + gt::kTW - 1) / gt::kTW;
  const int tiles_per_img = tiles_w * ((h + gt::kFH - 1) / gt::kFH);
  const long long n_tiles = (long long)batch * tiles_per_img;
  if (n_tiles > (1ll << 31) - 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long slots = (long long)gt::kFwdBlocks * sm_count();
  const int grid = static_cast<int>(n_tiles < slots ? n_tiles : slots);
  growth_fwd_kernel<<<grid, gt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), c, h, w, tiles_w, tiles_per_img, static_cast<int>(n_tiles),
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<const uint4*>(wk),
      static_cast<const float*>(bias), static_cast<float*>(g));
  return static_cast<int>(cudaGetLastError());
}

// Floats of scratch mdie_growth_bwd needs at this shape.
long long mdie_growth_bwd_scratch(int batch, int c, int h, int w) {
  if (!shape_ok(batch, c, h, w)) return 0;
  const BwdGrid g = bwd_grid(batch, c, h, w);
  return (long long)g.n_groups * g.cols;
}

// x, dg as in the forward (dg: f32 [batch, 16, h, w]); wdv: bf16
// [ceil(c / 64)][9][2][64][8] (pack_dv_weights); outputs dx f32 [batch, c,
// h, w], dw f32 [16, c, 3, 3], da, db f32 [c]; scratch: f32 of
// mdie_growth_bwd_scratch floats.  Two launches; returns the first error.
int mdie_growth_bwd(const void* x, const void* dg, int batch, int c, int h, int w, const void* a,
                    const void* b, const void* wdv, void* dx, void* dw, void* da, void* db,
                    void* scratch, void* stream) {
  if (!shape_ok(batch, c, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdGrid g = bwd_grid(batch, c, h, w);
  // Set on every call: the attribute belongs to the current device, and a
  // process may launch on several (one set per process would leave cuda:1 and
  // up at the 48 KB default).
  const cudaError_t set = cudaFuncSetAttribute(
      growth_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, gt::kBSmem);
  if (set != cudaSuccess) return static_cast<int>(set);
  auto* part = static_cast<float*>(scratch);
  growth_bwd_kernel<<<dim3(g.n_groups, g.chunks), gt::kThreads, gt::kBSmem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dg), c, g.c_pad, h, w, g.tiles_w,
      g.tiles_per_img, g.n_tiles, static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const uint4*>(wdv), static_cast<float*>(dx), part, g.cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  growth_bwd_sum_kernel<<<(g.cols + 31) / 32, dim3(32, kSumRows), 0, s>>>(
      part, g.n_groups, g.cols, c, g.c_pad, static_cast<float*>(dw), static_cast<float*>(da),
      static_cast<float*>(db));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
