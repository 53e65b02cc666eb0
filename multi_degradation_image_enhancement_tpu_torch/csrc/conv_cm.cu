// CDAN's single 3x3 convolutions for Hopper (sm_90a): the conv + folded-BN
// bias (+ ReLU), and conv1's conv + bias + ReLU + 2x2 max-pool in one pass.
//
// Replaces:
//   multi_degradation_image_enhancement_tpu/ops/pallas/conv_cm.py
//     _kernel (pallas_call at :187, entry conv3x3_cm :141)          -> conv3x3
//   multi_degradation_image_enhancement_tpu/ops/pallas/conv_pool_cm.py
//     _kernel (pallas_call at :248, entry conv3x3_pool_cm :208)     -> conv3x3_pool
//
// The math of the TPU kernels, not their layout.  The channel-major [C, H*W]
// lanes, the column-polyphase operand (deinterleave_cols), the 3->8 input
// channel pad, the c_out padding to 16 and the c_out split all answer the
// TPU's lane width and VMEM bound; here both kernels read and write plain
// NCHW, c_out unpadded.
//
// Rounding points (conv_cm.py:44,91-95,108-111; conv_pool_cm.py:91,161,
// 171,181-182): the input and the BN-folded weights are bf16 operands, the
// products accumulate in f32, the f32 bias is added in f32, then the ReLU
// (optional for conv3x3), then (conv3x3_pool) the 2x2 max in f32, and one
// rounding to the output type (the input's) at the end.  SAME padding: taps
// outside the image read 0.
//
// Bound: 2*9*c_in*c_out FLOPs per output pixel against ~2*(c_in + c_out)
// bytes, so both are compute-bound.
//
// conv3x3 design: an implicit GEMM on the tensor cores (wgmma, fed by TMA),
// M = pixels, N = c_out, K = 9 taps x c_in, on the mainloop of the probe
// GEMM (probe_matmul.cu): a persistent, warp-specialised block per SM, one
// producer thread keeping a ring of stages in flight through mbarriers, two
// consumer warpgroups each running wgmma m64nBNk16 on 64 pixels of a
// 128-pixel tile (BH rows of BW pixels, BW = 8..128, the width that pads W
// least).  TMA cannot start a box at an innermost coordinate that is not 16
// bytes aligned (the launch faults with an illegal instruction), so a tap's
// one-pixel shift cannot lie along NCHW's pixel rows.  A first pass
// therefore rounds x to bf16 into an NHWC scratch (channels padded to 8;
// the pass of nhwc_pass.cuh, shared with dense_block.cu), and a K step (64
// input channels of one tap (ky, kx)) loads BH boxes of BW pixels x 64
// channels at (c0, w0 + kx - 1, h0 + r + ky - 1, b): 128-byte
// pixel rows, K-major, 128-byte swizzle; the shift lies in the pixel
// dimensions and TMA's out-of-bounds zeros are SAME's padding and the
// ragged edges, so any H and W are taken.  The weights come K-major from
// the pack ([c_out_pad, 9, c_in_pad], ops/cuda/conv_cm.py: pack_conv)
// through a 2-D map, N = 8 (de4's 3 outputs), 64, 128 or 256 (c_out 512 in
// two N tiles).  The epilogue adds the f32 bias, applies the ReLU and
// rounds once.  For bf16 out with rows of whole 16 bytes (W a multiple of
// 8), each warpgroup stages chunks of 64 channels x its 64 pixels
// channel-major in shared memory, two buffers in turn, and a TMA store
// writes each chunk into NCHW, clipping the edges; the consumers go on to
// the next tile's products while the stores drain (PERF.md §6).  f32
// out, or other widths, store NCHW straight from the accumulators (a warp
// store covers 8 pixels of 4 channels), skipping pixels and channels past
// the edge.  The NHWC pass costs a read and a write of x that the GEMM
// alone would not need; folding it into the producer is later work.
//
// conv3x3_pool design (unchanged): one thread block per pixel tile, image
// and group of 16 output channels on the FP32 pipes; the tile's input halo
// patch of a chunk of input channels is staged in shared memory, rounded to
// bf16 at load, beside the chunk's weights; every thread keeps its 2x2 pool
// window x 16 outputs in f32 registers and reads each weight as a broadcast
// float4.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"
#include "nhwc_pass.cuh"

namespace {

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// ------------------------------------------------------------------ conv3x3
// An implicit GEMM on the tensor cores: M = pixels, N = c_out, K = 9 x c_in.
namespace conv {
constexpr int kBM = 128;            // pixels of an output tile: BH rows of BW
constexpr int kBK = 64;             // input channels of a K step (one tap): 128 bytes
constexpr int kConsumers = 2;       // warpgroups, 64 pixels each
constexpr int kThreads = (kConsumers + 1) * kWarpgroup;
constexpr int kABytes = kBM * kBK * 2;  // 16 KB: 128 pixel rows of 64 channels
constexpr int kSmemBudget = 224 * 1024;
constexpr int kPixRow = kBK * 2;    // bytes of one pixel's K step in shared memory
constexpr int kOutChunkBytes = 64 * 64 * 2;  // staged output: <= 64 channels x 64 pixels
constexpr int kOutBytes = kConsumers * 2 * kOutChunkBytes;  // two chunks a warpgroup
template <int BN>
struct Cfg {
  static constexpr int kBBytes = BN * kBK * 2;  // [BN][64] K-major weight rows
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kFit = (kSmemBudget - kOutBytes) / kStageBytes;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kOutOffset = kStages * kStageBytes;
  static constexpr int kBarOffset = kOutOffset + kOutBytes;
  static constexpr int kSmemBytes = kBarOffset + 2 * kStages * 8 + 1024;
  static constexpr int kAcc = BN / 2;
  static constexpr int kCh = BN < 64 ? BN : 64;  // output channels of a staged chunk
};
}  // namespace conv

// Persistent: a thread block per SM walks tiles (image, pixel-row band,
// pixel-column band, N tile), N fastest.  K steps: input-channel chunk
// outer, tap inner.  A K step loads, for each of the tile's BH pixel rows,
// one TMA box of BW pixels x 64 channels of the NHWC operand at (c0,
// w0 + kx - 1, h0 + r + ky - 1, b): rows of 128 bytes, K-major, 128-byte
// swizzle, pixel-contiguous across the BH boxes, so a warpgroup's 64 pixels
// are one K-major wgmma operand whatever BW is.  The shift by the tap lies
// in the pixel dimensions, never in the innermost one, so every box starts
// on a 128-byte boundary (TMA rejects a box whose innermost start is not
// 16-byte aligned); the map's bounds give SAME's zeros and the ragged edges.
template <int BN>
__global__ void __launch_bounds__(conv::kThreads, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w,
                     const __grid_constant__ CUtensorMap map_o, int tma_out,
                     const float* __restrict__ bias, void* __restrict__ out, int out_f32,
                     int batch, int c_in_pad, int H, int W, int c_out, int relu, int bw_log2) {
  using namespace conv;
  using C = Cfg<BN>;
  const int bw = 1 << bw_log2, bh = kBM >> bw_log2;
  const int box_bytes = bw * kPixRow;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* empty = full + C::kStages;

  const int wg = threadIdx.x / kWarpgroup, tid = threadIdx.x % kWarpgroup;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int h_tiles = (H + bh - 1) / bh, w_tiles = (W + bw - 1) / bw;
  const int n_tiles = (c_out + BN - 1) / BN;
  const int per_img = h_tiles * w_tiles * n_tiles;
  const int tiles = batch * per_img;
  const int k_steps = 9 * (c_in_pad / kBK);

  if (wg == kConsumers) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int b = t / per_img, rem = t % per_img;
        const int n0 = rem % n_tiles * BN, wt = rem / n_tiles % w_tiles;
        const int h0 = rem / n_tiles / w_tiles * bh, w0 = wt * bw;
        for (int ks = 0; ks < k_steps; ++ks) {
          const int c0 = ks / 9 * kBK, tap = ks % 9, ky = tap / 3, kx = tap % 3;
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* st = smem + stage * C::kStageBytes;
          mbar_expect_tx(&full[stage], C::kStageBytes);
          for (int r = 0; r < bh; ++r)
            tma_load_4d(st + r * box_bytes, &map_x, &full[stage], c0, w0 + kx - 1,
                        h0 + r + ky - 1, b);
          tma_load_2d(st + kABytes, &map_w, &full[stage], tap * c_in_pad + c0, n0);
          if (++stage == C::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = tid / 32, lane = tid % 32;
    // This warpgroup's 64 pixels as the output map's box: rows of up to 64.
    const int cols = bw < 64 ? bw : 64, rows = 64 / cols;
    uint8_t* staging = smem + C::kOutOffset + wg * 2 * kOutChunkBytes;
    int chunks = 0;  // staged chunks so far: they alternate between two buffers
    float acc[C::kAcc];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int b = t / per_img, rem = t % per_img;
      const int n0 = rem % n_tiles * BN, wt = rem / n_tiles % w_tiles;
      const int h0 = rem / n_tiles / w_tiles * bh, w0 = wt * bw;
#pragma unroll
      for (int i = 0; i < C::kAcc; ++i) acc[i] = 0.0f;
      int prev = -1;
      for (int ks = 0; ks < k_steps; ++ks) {
        mbar_wait(&full[stage], phase);
        const uint8_t* st = smem + stage * C::kStageBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          // A: this warpgroup's 64 pixel rows; B: BN weight rows; both
          // K-major, 16 channels = 32 bytes a step.
          const uint64_t da = smem_desc(st + wg * 64 * kPixRow + kk * 32, 16, 1024);
          const uint64_t db = smem_desc(st + kABytes + kk * 32, 16, 1024);
          wgmma_bf16<BN, 0, 0>(acc, da, db);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products are done: free its stage
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs<C::kAcc>(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);

      // Epilogue: + bias, ReLU, one rounding.  Row m of the tile is pixel
      // (h0 + m / bw, w0 + m % bw).  bf16 out with 16-byte rows: chunks of
      // kCh channels x 64 pixels staged channel-major in shared memory and
      // stored by TMA (it clips the edges), two buffers in turn, so the
      // stores run on while the next tile's products start.
      if (tma_out) {
        const int wc = w0 + (bw > 64 ? 64 * wg : 0), hc = h0 + (bw > 64 ? 0 : wg * rows);
#pragma unroll
        for (int q = 0; q < BN / C::kCh; ++q, ++chunks) {
          auto* buf = reinterpret_cast<__nv_bfloat16*>(staging + (chunks & 1) * kOutChunkBytes);
          if (tid == 0) tma_store_wait_read<1>();  // the store that last read buf is done
          named_barrier(1 + wg, kWarpgroup);
#pragma unroll
          for (int j = 0; j < C::kCh / 8; ++j) {
            const int jj = q * (C::kCh / 8) + j;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int cl = 8 * j + 2 * (lane % 4) + e, ch = n0 + 8 * jj + 2 * (lane % 4) + e;
              const float bch = ch < c_out ? __ldg(bias + ch) : 0.0f;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float v = acc[4 * jj + 2 * h + e] + bch;
                if (relu) v = fmaxf(v, 0.0f);
                buf[cl * 64 + 16 * warp + lane / 4 + 8 * h] = __float2bfloat16(v);
              }
            }
          }
          fence_proxy_async();
          named_barrier(1 + wg, kWarpgroup);
          if (tid == 0) {  // one group per chunk, empty past c_out, so the wait above holds
            if (n0 + q * C::kCh < c_out) tma_store_4d(&map_o, buf, wc, hc, n0 + q * C::kCh, b);
            tma_store_commit();
          }
        }
        continue;
      }
      // f32 out, or rows that are no TMA stride: NCHW stores straight from
      // the accumulators.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 64 * wg + 16 * warp + lane / 4 + 8 * h;
        const int hh = h0 + (m >> bw_log2), ww = w0 + (m & (bw - 1));
        if (hh >= H || ww >= W) continue;
        const long long pix = (long long)b * c_out * H * W + (long long)hh * W + ww;
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ch = n0 + 8 * jj + 2 * (lane % 4) + e;
            if (ch >= c_out) continue;
            float v = acc[4 * jj + 2 * h + e] + __ldg(bias + ch);
            if (relu) v = fmaxf(v, 0.0f);
            const long long idx = pix + (long long)ch * H * W;
            if (out_f32)
              static_cast<float*>(out)[idx] = v;
            else
              static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16(v);
          }
        }
      }
    }
    if (tid == 0) tma_store_wait_all();
  }
}

template <int BN>
cudaError_t launch_conv3x3(const __nv_bfloat16* xt, int batch, int c_t, int h, int w, int bw_log2,
                           const void* wp, int c_in_pad, int c_out_pad, const float* bias,
                           int c_out, int relu, void* out, int out_f32, cudaStream_t s) {
  const int bw = 1 << bw_log2;
  using C = conv::Cfg<BN>;
  const uint64_t Bn = batch, Ct = c_t, H = h, W = w;
  CUtensorMap map_x, map_w;
  const uint64_t dims_x[4] = {Ct, W, H, Bn}, strides_x[3] = {Ct * 2, W * Ct * 2, H * W * Ct * 2};
  const uint32_t box_x[4] = {conv::kBK, static_cast<uint32_t>(bw), 1, 1};
  const uint64_t dims_w[2] = {9ull * c_in_pad, (uint64_t)c_out_pad};
  const uint64_t strides_w[1] = {9ull * c_in_pad * 2};
  const uint32_t box_w[2] = {conv::kBK, BN};
  cudaError_t err;
  if ((err = make_map_bf16(&map_x, xt, 4, dims_x, strides_x, box_x, CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (err = make_map_bf16(&map_w, wp, 2, dims_w, strides_w, box_w, CU_TENSOR_MAP_SWIZZLE_128B)))
    return err;
  // bf16 out with rows of whole 16 bytes: the epilogue's TMA stores, a box
  // of a warpgroup's 64 pixels x kCh channels.
  CUtensorMap map_o = {};
  const int tma_out = !out_f32 && w % 8 == 0;
  if (tma_out) {
    const uint64_t Co = c_out;
    const uint32_t cols = bw < 64 ? bw : 64;
    const uint64_t dims_o[4] = {W, H, Co, Bn}, strides_o[3] = {W * 2, H * W * 2, Co * H * W * 2};
    const uint32_t box_o[4] = {cols, 64 / cols, C::kCh, 1};
    if ((err = make_map_bf16(&map_o, out, 4, dims_o, strides_o, box_o, CU_TENSOR_MAP_SWIZZLE_NONE)))
      return err;
  }
  if ((err = cudaFuncSetAttribute(conv3x3_wgmma_kernel<BN>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes)))
    return err;
  const long long tiles = (long long)batch * ((h + conv::kBM / bw - 1) / (conv::kBM / bw)) *
                          ((w + bw - 1) / bw) * ((c_out + BN - 1) / BN);
  if (tiles > (1ll << 31) - 1) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(tiles < sm_count() ? tiles : sm_count());
  conv3x3_wgmma_kernel<BN><<<grid, conv::kThreads, C::kSmemBytes, s>>>(
      map_x, map_w, map_o, tma_out, bias, out, out_f32, batch, c_in_pad, h, w, c_out, relu,
      bw_log2);
  return cudaGetLastError();
}

cudaError_t dispatch_conv3x3(const __nv_bfloat16* xt, int batch, int c_t, int h, int w,
                             int bw_log2, const void* wp, int c_in_pad, int c_out_pad,
                             const float* bias, int c_out, int relu, void* out, int out_f32,
                             cudaStream_t s) {
#define MDIE_CONV(BN)                                                                         \
  return launch_conv3x3<BN>(xt, batch, c_t, h, w, bw_log2, wp, c_in_pad, c_out_pad, bias, c_out, \
                            relu, out, out_f32, s)
  if (c_out_pad <= 8) MDIE_CONV(8);
  if (c_out_pad <= 64) MDIE_CONV(64);
  if (c_out_pad <= 128) MDIE_CONV(128);
  MDIE_CONV(256);
#undef MDIE_CONV
}

// log2 of the tile width (pixels of a row) that pads W the least, the
// widest on a tie: 8, 16, 32, 64 or 128 pixels, 128 / BW rows a tile.
int tile_width_log2(int w) {
  int best = 7, best_cols = (w + 127) / 128 * 128;
  for (int l = 6; l >= 3; --l) {
    const int cols = (w + (1 << l) - 1) >> l << l;
    if (cols < best_cols) best = l, best_cols = cols;
  }
  return best;
}

// ------------------------------------------------------------- conv3x3_pool
constexpr int kPoolW = 32;   // pooled columns per tile (one warp)
constexpr int kPoolH = 8;    // pooled rows per tile (one per thread row)
constexpr int kPoolChunk = 4;
constexpr int kPoolOG = 16;
constexpr int kPoolPatchH = 2 * kPoolH + 2;
constexpr int kPoolPatchW = 2 * kPoolW + 2;

// grid = (ceil(W/2 / 32), ceil(H/2 / 8), B * n_og); block = (32, 8).  A
// thread owns one pooled pixel, i.e. its 2x2 window of conv outputs, for 16
// output channels.  H and W are even, so every window lies in the image.
template <typename T>
__global__ void __launch_bounds__(kPoolW * kPoolH)
conv3x3_pool_kernel(const T* __restrict__ x, int c_in, int H, int W,
                    const __nv_bfloat16* __restrict__ wgt, const float* __restrict__ bias,
                    int c_out, int n_og, T* __restrict__ out) {
  __shared__ float patch[kPoolChunk][kPoolPatchH][kPoolPatchW];
  __shared__ __align__(16) float wsm[kPoolChunk][9][kPoolOG];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kPoolW + tx;
  const int og = blockIdx.z % n_og;
  const int img = blockIdx.z / n_og;
  const int Hp = H / 2, Wp = W / 2;
  const int cx0 = 2 * blockIdx.x * kPoolW, cy0 = 2 * blockIdx.y * kPoolH;  // conv-tile origin
  const long long plane = (long long)H * W;
  const T* in = x + (long long)img * c_in * plane;

  float acc[4][kPoolOG];  // window position (dy, dx) -> 2 * dy + dx
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int o = 0; o < kPoolOG; ++o) acc[p][o] = 0.0f;

  for (int c0 = 0; c0 < c_in; c0 += kPoolChunk) {
    for (int idx = tid; idx < kPoolChunk * kPoolPatchH * kPoolPatchW; idx += kPoolW * kPoolH) {
      const int c = idx / (kPoolPatchH * kPoolPatchW);
      const int rem = idx - c * (kPoolPatchH * kPoolPatchW);
      const int py = rem / kPoolPatchW, px = rem - py * kPoolPatchW;
      const int gy = cy0 + py - 1, gx = cx0 + px - 1, cc = c0 + c;
      float v = 0.0f;
      if (cc < c_in && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        v = bf16_operand(in[cc * plane + (long long)gy * W + gx]);
      }
      patch[c][py][px] = v;
    }
    for (int idx = tid; idx < kPoolChunk * 9 * kPoolOG; idx += kPoolW * kPoolH) {
      const int c = idx / (9 * kPoolOG);
      const int rem = idx - c * (9 * kPoolOG);
      const int t = rem / kPoolOG, o = rem - t * kPoolOG;
      const int cc = c0 + c, oo = og * kPoolOG + o;
      wsm[c][t][o] = (cc < c_in && oo < c_out)
                         ? __bfloat162float(wgt[((long long)oo * c_in + cc) * 9 + t])
                         : 0.0f;
    }
    __syncthreads();

    const int n_c = min(kPoolChunk, c_in - c0);
    for (int c = 0; c < n_c; ++c) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          float v[4];
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            v[p] = patch[c][2 * ty + (p >> 1) + ky][2 * tx + (p & 1) + kx];
          }
          const float4* w4 = reinterpret_cast<const float4*>(&wsm[c][ky * 3 + kx][0]);
#pragma unroll
          for (int j = 0; j < kPoolOG / 4; ++j) {
            const float4 w = w4[j];
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              acc[p][4 * j + 0] += v[p] * w.x;
              acc[p][4 * j + 1] += v[p] * w.y;
              acc[p][4 * j + 2] += v[p] * w.z;
              acc[p][4 * j + 3] += v[p] * w.w;
            }
          }
        }
      }
    }
    __syncthreads();
  }

  const int pxo = blockIdx.x * kPoolW + tx, pyo = blockIdx.y * kPoolH + ty;
  if (pxo >= Wp || pyo >= Hp) return;
  const long long pplane = (long long)Hp * Wp;
  T* dst = out + (long long)img * c_out * pplane + (long long)pyo * Wp + pxo;
#pragma unroll
  for (int o = 0; o < kPoolOG; ++o) {
    const int oo = og * kPoolOG + o;
    if (oo >= c_out) continue;
    const float b = bias[oo];
    float m = fmaxf(acc[0][o] + b, 0.0f);
#pragma unroll
    for (int p = 1; p < 4; ++p) m = fmaxf(m, fmaxf(acc[p][o] + b, 0.0f));
    store(dst + oo * pplane, m);
  }
}

template <typename T>
cudaError_t launch_conv3x3_pool(const T* x, int batch, int c_in, int h, int w,
                                const __nv_bfloat16* wgt, const float* bias, int c_out, T* out,
                                cudaStream_t s) {
  const int n_og = (c_out + kPoolOG - 1) / kPoolOG;
  const dim3 grid((w / 2 + kPoolW - 1) / kPoolW, (h / 2 + kPoolH - 1) / kPoolH, batch * n_og);
  conv3x3_pool_kernel<T><<<grid, dim3(kPoolW, kPoolH), 0, s>>>(
      x, c_in, h, w, wgt, bias, c_out, n_og, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: NCHW [batch, c_in, h, w], bf16 (x_f32 == 0) or f32.  xt: bf16 scratch
// [batch, h, w, c_t], 16-byte aligned, c_t = c_in rounded up to 8.  wp: bf16
// [c_out_pad, 9, c_in_pad], K-major (tap, then input channel; zeros in the
// padding), c_in_pad a multiple of 64, c_out_pad of 8.  bias: f32 [c_out].
// out: NCHW [batch, c_out, h, w] of x's type.  Two launches: the NHWC pass
// into xt, then the implicit GEMM.
int mdie_conv3x3(const void* x, int x_f32, int batch, int c_in, int h, int w, void* xt,
                 const void* wp, int c_in_pad, int c_out_pad, const void* bias, int c_out,
                 int relu, void* out, void* stream) {
  const int c_t = (c_in + 7) / 8 * 8;
  if (batch <= 0 || batch > 65535 || c_in <= 0 || c_out <= 0 || h <= 0 || w <= 0 ||
      c_in_pad % conv::kBK || c_in_pad < c_in || c_out_pad % 8 || c_out_pad < c_out)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* y = static_cast<__nv_bfloat16*>(xt);
  const cudaError_t err = launch_nchw_to_nhwc(x, x_f32, batch, c_in, h * w, c_t, c_t, y, s);
  if (err) return static_cast<int>(err);
  return static_cast<int>(dispatch_conv3x3(y, batch, c_t, h, w, tile_width_log2(w), wp,
                                           c_in_pad, c_out_pad, static_cast<const float*>(bias),
                                           c_out, relu, out, x_f32, s));
}

// x: NCHW [batch, c_in, h, w] (h, w even), bf16 if x_bf16 else f32;
// out: [batch, c_out, h/2, w/2] of x's type.  wgt, bias as for mdie_conv3x3.
int mdie_conv3x3_pool(const void* x, int x_bf16, int batch, int c_in, int h, int w,
                      const void* wgt, const void* bias, int c_out, void* out, void* stream) {
  const auto* wb = static_cast<const __nv_bfloat16*>(wgt);
  const auto* bi = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return static_cast<int>(launch_conv3x3_pool<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x), batch, c_in, h, w, wb, bi, c_out,
        static_cast<__nv_bfloat16*>(out), s));
  }
  return static_cast<int>(launch_conv3x3_pool<float>(static_cast<const float*>(x), batch, c_in,
                                                     h, w, wb, bi, c_out,
                                                     static_cast<float*>(out), s));
}

}  // extern "C"
