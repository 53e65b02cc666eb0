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
// rounding to the output type (the input's) at the end.  conv3x3_pool takes
// the max of the four f32 sums first and adds the bias and applies the ReLU
// once: the same f32 value, since adding one b and the ReLU are monotone.
// SAME padding: taps outside the image read 0.
//
// Bound: 2*9*c_in*c_out FLOPs per output pixel against ~2*(c_in + c_out)
// bytes, so conv3x3 is compute-bound at the CM shapes; conv3x3_pool's conv1
// (c_in 3, K = 27) is bound by its bytes: at B=128 x 256^2 the 268 MB bf16
// pooled output is 84% of 318 MB, 0.095 ms at 3.35 TB/s, against 0.03 ms of
// bf16 tensor-core products.
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
// conv3x3_pool design: the TPU kernel's two ideas (conv_pool_cm.py:9-25)
// read for wgmma.  (1) Full (ky, kx) K-stacking: an im2col implicit GEMM
// with K = 9 c_in (k = 9c + 3ky + kx) padded to 32 (conv1's 27: two k16
// steps) or to chunks of 64; nine shifted K = 16 products a tap would
// multiply conv1's tensor work 5.3x.  (2) Column polyphase: four fields of
// the im2col operand, one per pool-window position (dy, dx), against the
// same weights, so the 2x2 max is an elementwise fmaxf over accumulators
// that lie in the same registers, and bias + ReLU run once, on the max.
// The GEMM runs transposed (D[channel][pixel]): the weights ([c_out_pad,
// k_pad] from pack_conv's w_pool) are wgmma's A in registers, the im2col
// fields its B in shared memory.  What binds is not the products (0.03 ms
// at conv1's shape) but the instructions each tile costs and, at the floor,
// the pooled output, so the kernel is persistent and warp-specialised
// (conv3x3_pool_wgmma_kernel below): two builder warpgroups copy each
// tile's halo'd NCHW patch by cp.async into a ring several tiles ahead and
// build the im2col rows from it into a ring of stages; two consumer
// warpgroups multiply, pool and TMA-store the bf16 tile through 128-byte
// swizzled staging while the builders work on the next tiles.  The two
// serving shapes give whole tiles (one pooled row of 128 at 256^2, two of
// 64 at 256x384); ragged H/2 and W/2 are clipped.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

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
// An im2col implicit GEMM on the tensor cores over four polyphase fields:
// M = pooled pixels, N = c_out, K = 9 x c_in, k = 9c + 3ky + kx.
namespace pool {
constexpr int kP = 128;                // pooled pixels of a tile: TR rows of TC
constexpr int kConsumers = 2;          // warpgroups, 64 pooled pixels each
constexpr int kBuilders = 2;           // warpgroups, two threads a pooled pixel
constexpr int kBuildThreads = kBuilders * kWarpgroup;
constexpr int kThreads = (kConsumers + kBuilders) * kWarpgroup;
constexpr int kM = 64;                 // output channels of a wgmma (its M)
constexpr int kPlaneMax = 1088;        // (2 TR + 2) x (2 TC + 16) patch pixels at most
constexpr int kBoxBytes = kM * 64 * 2; // a consumer's staged bf16 tile: 64 rows of 128 B
template <typename T, int KSTEPS>
struct Cfg {
  static constexpr int kKC = 16 * KSTEPS;             // im2col columns of a K chunk
  static constexpr int kQ = kKC / 8;                  // 16-byte k groups of a pixel's row
  static constexpr int kNch = KSTEPS == 2 ? 3 : 9;    // input channels a chunk can span
  static constexpr int kStageBytes = 4 * kQ * kP * 16;  // four fields' im2col, [f][q][pixel]
  static constexpr int kStages = KSTEPS == 2 ? 3 : (sizeof(T) == 2 ? 2 : 1);
  static constexpr int kPatchBytes = (kNch * kPlaneMax * (int)sizeof(T) + 15) / 16 * 16;
  static constexpr int kPatches = KSTEPS == 2 ? 4 : 2;  // the ring of patches (one K chunk)
  static constexpr int kOutOff = kStages * kStageBytes;
  static constexpr int kPatchOff = kOutOff + kConsumers * 2 * kBoxBytes;  // two staging tiles each
  static constexpr int kTabOff = kPatchOff + kPatches * kPatchBytes;
  static constexpr int kBarOffset = kTabOff + kKC * 4;
  static constexpr int kSmemBytes = kBarOffset + 2 * kStages * 8 + 1024;  // + alignment slack
  static constexpr int kAcc = 64 / 2;                 // f32 sums a field a thread (N = 64)
};
}  // namespace pool

// 4-byte asynchronous copy global -> shared; zeros when !ok.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
// 16-byte asynchronous copy global -> shared (both 16-byte aligned); zeros when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// All but the newest N committed copy groups have landed.
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }
// A staged patch element as its bf16 operand's bits (bf16 x is staged as it lies).
__device__ __forceinline__ uint32_t operand_bits(uint16_t v) { return v; }
__device__ __forceinline__ uint32_t operand_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

// Persistent and warp-specialised; block i takes tiles i, i + grid, ... of
// TR x TC pooled pixels (TC = 1 << tc_log2, TR = 128 / TC), image-major, in
// units (tile, M tile of 64 channels, K chunk).  The GEMM is transposed,
// D[channel][pixel] = W[channel][k] . X[k][pixel]: the weights are wgmma's A,
// held in registers (loaded once for the whole walk when one unit covers a
// tile, as for conv1), and the im2col operand is B, read from shared memory.
//
// Builder warpgroups: copy each unit's halo'd patch ((2TR + 2) rows x (2TC
// + 16) columns of conv pixels from a 16-byte aligned column, 16 bytes a
// copy where the rows allow it; zeros outside the image) from NCHW by
// cp.async, with one K chunk into a ring of patches three tiles ahead of the
// one they build from (the copies' latency is what a tile would otherwise
// wait for); then build the four fields' im2col rows into a ring stage:
// field (dy, dx) holds, for pooled pixel (i, j), the patch at conv pixel
// (2i + dy, 2j + dx) shifted by each k's tap; two threads build the 16-byte
// rows (8 k) of one pixel, alternate k groups each, through a k ->
// patch-offset table (one division a column a chunk, none an element; the
// lanes of a load read one tap of consecutive pixels).
//
// Consumer warpgroups, 64 pooled pixels each: wgmma m64n64k16 (64 channels
// x 64 pixels) over the four fields into accumulator sets whose elements lie
// in the same registers, so the pool is an elementwise max (with one K
// chunk, two sets folded by a running max as the fields finish);
// then bias and ReLU once (max_i relu(a_i + b) == relu(max_i a_i + b)) and
// one rounding.  bf16 out with TC >= 64: a thread's two neighbouring pixels
// go as one 4-byte store into a 128-byte-swizzled channel-major staging tile
// (the eight channels of a warp's store land in eight different 16-byte
// chunks), TMA-stored as a box {64, 1, 64, 1}, two staging tiles in turn,
// so the stores drain while the next tile runs; otherwise NCHW stores
// straight from the registers.  The builders and the consumers meet only at
// the ring's mbarriers, so building, products and stores overlap.
template <typename T, int KSTEPS>
__global__ void __launch_bounds__(pool::kThreads, 1)
conv3x3_pool_wgmma_kernel(const __grid_constant__ CUtensorMap map_o, int tma_out,
                          const T* __restrict__ x, int batch, int c_in, int H, int W,
                          const __nv_bfloat16* __restrict__ wp, int k_pad, int c_out_pad,
                          const float* __restrict__ bias, int c_out, T* __restrict__ out,
                          int tc_log2) {
  using namespace pool;
  using C = Cfg<T, KSTEPS>;
  using PT = typename std::conditional<sizeof(T) == 2, uint16_t, float>::type;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* empty = full + C::kStages;

  const int wg = threadIdx.x / kWarpgroup, tid = threadIdx.x % kWarpgroup;
  const int lane = tid % 32;
  if (threadIdx.x == 0) {
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(&full[st], kBuildThreads);       // every builder thread
      mbar_init(&empty[st], kConsumers * 4);     // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int tc = 1 << tc_log2, tr = kP >> tc_log2;
  const int pw = 2 * tc + 16, prows = 2 * tr + 2, plane = prows * pw;
  const int Hp = H / 2, Wp = W / 2;
  const int wb = (Wp + tc - 1) / tc, per_img = (Hp + tr - 1) / tr * wb;
  const int tiles = batch * per_img;  // the host keeps it below 2^31
  const int k_chunks = k_pad / C::kKC, m_tiles = (c_out + kM - 1) / kM;

  if (wg >= kConsumers) {
    // ------------------------------------------------------------ builders
    asm volatile("setmaxnreg.dec.sync.aligned.u32 80;\n");
    const int bt = threadIdx.x - kConsumers * kWarpgroup, warp = bt / 32;
    PT* patches = reinterpret_cast<PT*>(smem + C::kPatchOff);
    int* tab = reinterpret_cast<int*>(smem + C::kTabOff);
    const int k_real = 9 * c_in;
    const long long hw = (long long)H * W;
    // 16-byte copies when every row starts 16-byte aligned, else 4-byte ones;
    // a copy lies wholly inside or outside the image (W is even, and a
    // multiple of 16 / sizeof(T) for the wide ones).
    const int per = (W * (int)sizeof(T)) % 16 == 0 ? 16 / (int)sizeof(T) : 4 / (int)sizeof(T);
    // Copy the channels of chunk kc of tile t's patch into dst.
    auto stage_patch = [&](int t, int kc, PT* dst) {
      const int k0 = kc * C::kKC, c_first = k0 / 9;
      const int nch = min(c_in - 1, (k0 + C::kKC - 1) / 9) - c_first + 1;
      const int b = t / per_img, rem = t - b * per_img;
      const int gy0 = 2 * (rem / wb * tr) - 1, gx0 = 2 * (rem % wb * tc) - 8;
      const long long img = (long long)b * c_in * hw;
      for (int row = warp; row < nch * prows; row += kBuildThreads / 32) {
        const int cl = row / prows, r = row - cl * prows, gy = gy0 + r;
        const bool row_in = gy >= 0 && gy < H;
        const long long src = img + (c_first + cl) * hw + (long long)gy * W + gx0;
        PT* d = dst + cl * plane + r * pw;
        for (int u = lane * per; u < pw; u += 32 * per) {
          const bool ok = row_in && gx0 + u >= 0 && gx0 + u < W;
          if (per * sizeof(T) == 16)
            cp_async16(d + u, ok ? x + src + u : x, ok);
          else
            cp_async4(d + u, ok ? x + src + u : x, ok);
        }
      }
    };
    // Chunk kc's k -> patch offset, -1 past 9 c_in (K padding).
    auto fill_tab = [&](int kc) {
      if (bt < C::kKC) {
        const int k0 = kc * C::kKC, k = k0 + bt;
        int o = -1;
        if (k < k_real) {
          const int c = k / 9, tap = k - 9 * c, ky = tap / 3;
          o = (c - k0 / 9) * plane + ky * pw + (tap - 3 * ky);
        }
        tab[bt] = o;
      }
    };
    const int mb = bt % kP;  // this thread's pooled pixel; its k groups q0, q0 + 2, ...
    const int q0 = bt / kP, pix = 2 * (mb >> tc_log2) * pw + 2 * (mb & (tc - 1)) + 7;
    int stage = 0;
    uint32_t phase = 0;
    // Build the four fields' im2col rows of pooled pixel mb into the next ring stage.
    auto build = [&](const PT* patch) {
      mbar_wait(&empty[stage], phase ^ 1);
      uint4* sx = reinterpret_cast<uint4*>(smem + stage * C::kStageBytes);
      patch += pix;
#pragma unroll
      for (int q = q0; q < C::kQ; q += kBuilders) {
        int o[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) o[i] = tab[8 * q + i];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const PT* src = patch + (f >> 1) * pw + (f & 1);
          uint32_t w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t lo = o[2 * i] >= 0 ? operand_bits(src[o[2 * i]]) : 0u;
            const uint32_t hi = o[2 * i + 1] >= 0 ? operand_bits(src[o[2 * i + 1]]) : 0u;
            w[i] = lo | (hi << 16);
          }
          sx[(f * C::kQ + q) * kP + mb] = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
      fence_proxy_async();  // the generic-proxy writes are seen by wgmma
      mbar_arrive(&full[stage]);
      if (++stage == C::kStages) {
        stage = 0;
        phase ^= 1;
      }
    };
    constexpr int kSlotElems = C::kPatchBytes / sizeof(PT);
    if (k_chunks == 1) {
      // One K chunk: a ring of kPatches patches, tiles kPatches - 1 ahead.
      fill_tab(0);
      constexpr int R = C::kPatches;
#pragma unroll
      for (int i = 0; i + 1 < R; ++i) {
        const int t = blockIdx.x + i * gridDim.x;
        if (t < tiles) stage_patch(t, 0, patches + i * kSlotElems);
        cp_async_commit();
      }
      for (int t = blockIdx.x, i = 0; t < tiles; t += gridDim.x, ++i) {
        cp_async_wait<R - 2>();          // this tile's copies have landed
        named_barrier(3, kBuildThreads);  // all of them; the last tile's builds are done
        const int tn = t + (R - 1) * gridDim.x;
        if (tn < tiles) stage_patch(tn, 0, patches + (i + R - 1) % R * kSlotElems);
        cp_async_commit();
        for (int mt = 0; mt < m_tiles; ++mt) build(patches + i % R * kSlotElems);
      }
    } else {
      for (int t = blockIdx.x; t < tiles; t += gridDim.x)
        for (int mt = 0; mt < m_tiles; ++mt)
          for (int kc = 0; kc < k_chunks; ++kc) {
            named_barrier(3, kBuildThreads);  // the last unit's builds are done with patch and table
            stage_patch(t, kc, patches);
            cp_async_commit();
            fill_tab(kc);
            cp_async_wait<0>();
            named_barrier(3, kBuildThreads);
            build(patches);
          }
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 168;\n");  // 2 x 128 x (168 + 80) < 65536
  const int warp = tid / 32, g = lane / 4, q4 = lane % 4;
  const bool held = k_chunks == 1 && m_tiles == 1;
  const long long phw = (long long)Hp * Wp;
  const int box_px = 64 * wg;  // this warpgroup's first pooled pixel of a tile
  uint8_t* so = smem + C::kOutOff + wg * 2 * kBoxBytes;
  // The weights' A fragments of M tile mt, K chunk kc: rows (channels)
  // 64 mt + 16 warp + g (+ 8), k 16 ks + 2 q4 (+ 1) and + 8; zeros past
  // c_out_pad.
  uint32_t wa[KSTEPS][4];
  auto load_a = [&](int mt, int kc) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = mt * kM + 16 * warp + g + 8 * (r & 1);
      const auto* src = reinterpret_cast<const uint32_t*>(wp + (long long)row * k_pad + kc * C::kKC +
                                                          8 * (r >> 1) + 2 * q4);
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) wa[ks][r] = row < c_out_pad ? __ldg(src + 8 * ks) : 0u;
    }
  };
  if (held) load_a(0, 0);
  // One K chunk (KSTEPS 2: K <= 32): the fields run two at a time into two
  // accumulator sets folded by a running max, so a thread holds 64 sums, not
  // 128.  More chunks: four sets, one a field, each summed over the chunks.
  constexpr int kSets = KSTEPS == 2 ? 2 : 4;
  float acc[kSets][C::kAcc];
  int stage = 0, staged = 0;
  uint32_t phase = 0;
  auto zero = [&](float* d) {
#pragma unroll
    for (int i = 0; i < C::kAcc; ++i) d[i] = 0.0f;
  };
  auto fold = [&](float* d, const float* e) {
#pragma unroll
    for (int i = 0; i < C::kAcc; ++i) d[i] = fmaxf(d[i], e[i]);
  };
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int b = t / per_img, rem = t - b * per_img;
    const int hp0 = rem / wb * tr + (box_px >> tc_log2), wp0 = (rem % wb) * tc + (box_px & (tc - 1));
    for (int mt = 0; mt < m_tiles; ++mt) {
#pragma unroll
      for (int v = 0; v < kSets; ++v) zero(acc[v]);
      for (int kc = 0; kc < k_chunks; ++kc) {
        if (!held) load_a(mt, kc);
        mbar_wait(&full[stage], phase);
        const uint4* sx = reinterpret_cast<const uint4*>(smem + stage * C::kStageBytes);
        auto mma = [&](int f, float* d) {
#pragma unroll
          for (int ks = 0; ks < KSTEPS; ++ks)
            wgmma_rs_bf16<64>(d, wa[ks],
                              smem_desc_interleave(&sx[(f * C::kQ + 2 * ks) * kP + box_px],
                                                   kP * 16, 128));
        };
        wgmma_fence();
        if constexpr (kSets == 2) {
          mma(0, acc[0]);
          mma(1, acc[1]);
          wgmma_commit();
#pragma unroll
          for (int f = 2; f < 4; ++f) {
            wgmma_wait<0>();
            fence_regs<C::kAcc>(acc[0]);
            fence_regs<C::kAcc>(acc[1]);
            fold(acc[0], acc[1]);
            zero(acc[1]);
            wgmma_fence();
            mma(f, acc[1]);
            wgmma_commit();
          }
          wgmma_wait<0>();
          fence_regs<C::kAcc>(acc[0]);
          fence_regs<C::kAcc>(acc[1]);
          fold(acc[0], acc[1]);
        } else {
#pragma unroll
          for (int f = 0; f < 4; ++f) mma(f, acc[f]);
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int f = 0; f < 4; ++f) fence_regs<C::kAcc>(acc[f]);
        }
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      if constexpr (kSets == 4) {
        fold(acc[0], acc[1]);
        fold(acc[2], acc[3]);
        fold(acc[0], acc[2]);
      }

      // Epilogue: acc[0] holds the 2x2 max; + bias, ReLU, one rounding.  Sum
      // 4j + 2h + e is channel 64 mt + 16 warp + g + 8h, pooled pixel
      // box_px + 8j + 2 q4 + e of the tile.
      float* r = acc[0];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ch = mt * kM + 16 * warp + g + 8 * h;
        const float bch = ch < c_out ? __ldg(bias + ch) : 0.0f;
#pragma unroll
        for (int j = 0; j < C::kAcc / 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) r[4 * j + 2 * h + e] = fmaxf(r[4 * j + 2 * h + e] + bch, 0.0f);
      }
      if (tma_out) {
        uint8_t* out_buf = so + (staged & 1) * kBoxBytes;
        if (tid == 0) tma_store_wait_read<1>();  // the store that last read out_buf is done
        named_barrier(1 + wg, kWarpgroup);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * warp + g + 8 * h;
#pragma unroll
          for (int j = 0; j < C::kAcc / 4; ++j) {
            const int p = 8 * j + 2 * q4;  // two pixels, 4 bytes
            *reinterpret_cast<__nv_bfloat162*>(out_buf + row * 128 + (((p >> 3) ^ (row & 7)) << 4) +
                                               (p & 7) * 2) =
                __floats2bfloat162_rn(r[4 * j + 2 * h], r[4 * j + 2 * h + 1]);
          }
        }
        fence_proxy_async();
        named_barrier(1 + wg, kWarpgroup);
        if (tid == 0) {
          tma_store_4d(&map_o, out_buf, wp0, hp0, mt * kM, b);
          tma_store_commit();
        }
        ++staged;
        continue;
      }
      const int hb0 = hp0 - (box_px >> tc_log2), wb0 = wp0 - (box_px & (tc - 1));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ch = mt * kM + 16 * warp + g + 8 * h;
        if (ch >= c_out) continue;
        T* dst = out + ((long long)b * c_out + ch) * phw;
#pragma unroll
        for (int j = 0; j < C::kAcc / 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = box_px + 8 * j + 2 * q4 + e;
            const int hh = hb0 + (m >> tc_log2), ww = wb0 + (m & (tc - 1));
            if (hh < Hp && ww < Wp) store(dst + (long long)hh * Wp + ww, r[4 * j + 2 * h + e]);
          }
      }
    }
  }
  if (tid == 0) tma_store_wait_all();
}

template <typename T, int KSTEPS>
cudaError_t launch_conv3x3_pool(const T* x, int batch, int c_in, int h, int w,
                                const __nv_bfloat16* wp, int k_pad, int c_out_pad,
                                const float* bias, int c_out, T* out, int tc_log2,
                                cudaStream_t s) {
  using C = pool::Cfg<T, KSTEPS>;
  auto kernel = conv3x3_pool_wgmma_kernel<T, KSTEPS>;
  const int tc = 1 << tc_log2, tr = pool::kP >> tc_log2, hp = h / 2, wpx = w / 2;
  const long long tiles = (long long)batch * ((hp + tr - 1) / tr) * ((wpx + tc - 1) / tc);
  if (tiles > (1ll << 31) - 1) return cudaErrorInvalidValue;
  // bf16 rows of whole 16 bytes, a consumer's 64 pixels in one pooled row,
  // and a box within the tensor: swizzled TMA stores.
  CUtensorMap map_o = {};
  const int tma_out = sizeof(T) == 2 && wpx % 8 == 0 && tc >= 64 && wpx >= 64 &&
                      pool::kM <= c_out;
  cudaError_t err;
  if (tma_out) {
    const uint64_t Wp = wpx, Hp = hp, Co = c_out, Bn = batch;
    const uint64_t dims[4] = {Wp, Hp, Co, Bn}, strides[3] = {Wp * 2, Hp * Wp * 2, Co * Hp * Wp * 2};
    const uint32_t box[4] = {64, 1, pool::kM, 1};
    if ((err = make_map_bf16(&map_o, out, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B)))
      return err;
  }
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  C::kSmemBytes)))
    return err;
  const int grid = static_cast<int>(tiles < sm_count() ? tiles : sm_count());
  kernel<<<grid, pool::kThreads, C::kSmemBytes, s>>>(map_o, tma_out, x, batch, c_in, h, w, wp,
                                                     k_pad, c_out_pad, bias, c_out, out, tc_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_conv3x3_pool(const T* x, int batch, int c_in, int h, int w,
                                  const __nv_bfloat16* wp, int k_pad, int c_out_pad,
                                  const float* bias, int c_out, T* out, int tc_log2,
                                  cudaStream_t s) {
  if (k_pad == 32)
    return launch_conv3x3_pool<T, 2>(x, batch, c_in, h, w, wp, k_pad, c_out_pad, bias, c_out, out,
                                     tc_log2, s);
  return launch_conv3x3_pool<T, 4>(x, batch, c_in, h, w, wp, k_pad, c_out_pad, bias, c_out, out,
                                   tc_log2, s);
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
// out: [batch, c_out, h/2, w/2] of x's type.  wp: bf16 [c_out_pad, k_pad],
// K-major im2col weights (k = 9c + 3ky + kx; zeros past 9 c_in and c_out),
// k_pad 32 (9 c_in <= 32) or a multiple of 64; bias f32 [c_out]; tc_log2:
// log2 of the tile's pooled columns, 3..log2(pool::kP).  One launch.
int mdie_conv3x3_pool(const void* x, int x_bf16, int batch, int c_in, int h, int w,
                      const void* wp, int k_pad, int c_out_pad, const void* bias, int c_out,
                      void* out, int tc_log2, void* stream) {
  if (batch <= 0 || c_in <= 0 || c_out <= 0 || h <= 0 || w <= 0 || h % 2 || w % 2 ||
      c_out_pad < c_out || tc_log2 < 3 || (1 << tc_log2) > pool::kP || k_pad < 9 * c_in ||
      (k_pad != 32 && k_pad % 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* wb = static_cast<const __nv_bfloat16*>(wp);
  const auto* bi = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return static_cast<int>(dispatch_conv3x3_pool<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x), batch, c_in, h, w, wb, k_pad, c_out_pad, bi, c_out,
        static_cast<__nv_bfloat16*>(out), tc_log2, s));
  return static_cast<int>(dispatch_conv3x3_pool<float>(static_cast<const float*>(x), batch, c_in,
                                                       h, w, wb, k_pad, c_out_pad, bi, c_out,
                                                       static_cast<float*>(out), tc_log2, s));
}

}  // extern "C"
