// The in-kernel transpose probes for Hopper (sm_90a), bf16:
//   transpose:  o[b] = x[b]^T,      x [B, P, C] -> o [B, C, P];
//   rhsT:       o[b] = M . x[b]^T,  x [B, P, 64], M [64, 64] -> o [B, 64, P];
//   lhsT:       o[b] = x[b]^T . M,  x [B, 64, P], M [64, 64] -> o [B, P, 64];
// the products accumulate in f32 and round once to bf16.  With M = I (what
// the probe feeds) rhsT and lhsT are transposes, exactly.
//
// Replaces:
//   benchmarks/exp_io_transpose.py
//     kernel_rhsT (pallas_call at :73)   -> rhsT (product_kernel<false>)
//     kernel_lhsT (pallas_call at :95)   -> lhsT (product_kernel<true>)
//     kernel_jnpT (pallas_call at :116)  -> transpose
//
// Bound: all three move bytes, not operations.  At the probe's B=128,
// P=128*128, C=64 each reads and writes 268 MB (0.160 ms at 3.35 TB/s);
// rhsT and lhsT add 2*64 operations an output element (17 GFLOP), which the
// tensor cores do in a tenth of that time, but the FP32 pipes would not.
// The TPU kernels took a whole [P, C] image into VMEM per grid step and
// turned it with the matrix unit.
//
// transpose: a thread block turns a 64x64 tile in shared memory, rows padded
// by one element so that the column reads of the write phase hit 32
// distinct banks; each lane moves a bf16 pair on both sides, so a warp
// reads and writes 128-byte rows.
//
// rhsT, lhsT (product_kernel): a kernel that only streams has to keep enough
// bytes in flight, both ways, on every SM, and spend no instructions on
// addresses.  So it is persistent and asynchronous at both ends.  Two
// thread blocks per SM (105 KB of shared memory each) walk the flattened
// (image, 128-pixel tile) space, block i taking tiles i, i + grid, ..., so
// the blocks in flight work on neighbouring pixels and the batch has no grid
// cap.  M is loaded once per block by TMA into a 128-byte-swizzled 8 KB tile
// and stays.  One producer thread keeps a ring of four 16 KB stages of x in
// flight by TMA (128 pixels x 64 channels, 128-byte swizzle, completion on
// the stage's "full" mbarrier): rhsT reads x [B, P, 64] as one K-major box
// {64 ch, 128 px}, the B operand of wgmma with N = pixels; lhsT reads x
// [B, 64, P] as two MN-major boxes {64 px, 64 ch}, each the A operand of
// wgmma read through the transpose bit (bf16 allows it from shared memory),
// so no thread turns x.  One consumer warpgroup runs the products (rhsT:
// m64n128k16 with A = M, 4 K steps; lhsT: m64n64k16 on each 64-pixel half
// with B = M read N-major through the transpose bit), frees the stage on its
// "empty" mbarrier, rounds the f32 sums to bf16 once into a swizzled 16 KB
// staging tile (conflict-free: the 8 rows of a store land in 8 different
// 16-byte chunks) and TMA-stores it: lhsT's [128 px x 64 ch] is one
// contiguous 16 KB run of o, rhsT's [64 ch x 128 px] two boxes {64 px,
// 64 ch}.  Two staging tiles are used in turn, each reused only after the
// store that read it (cp.async.bulk.wait_group.read), so a tile's store
// overlaps the next tile's loads and products.  Loads and stores mark their
// L2 lines evict-first: nothing is read twice.  What binds the design is the
// DRAM rate on the side that runs along P (64 rows of 256 bytes a tile, 32 KB
// apart at the probe's P): deeper rings, more staging tiles, a second
// consumer warpgroup, 64- or 256-pixel tiles and contiguous runs of tiles
// per block were measured and gained nothing (PERF.md, section 6).  Ragged P: TMA
// needs 16-byte row strides, so P is any multiple of 8; the ragged last tile
// reads zeros past P and its store is clipped at P (a 64-pixel box wholly
// past P is neither loaded nor stored; lhsT's products on its stale rows are
// never stored, since each output row depends on its own pixel only); every
// box starts on a 64-element boundary, as TMA requires of its innermost
// coordinate.  Each mbarrier wait traps after 4 s, so a pipeline fault fails
// the launch instead of hanging the card.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- transpose
constexpr int kT = 64;
constexpr int kTPad = 1;

// grid = (ceil(P / 64), ceil(C / 64), B); block = (32, 8).  P and C even.
__global__ void __launch_bounds__(256)
transpose_kernel(const bf16* __restrict__ x, int P, int C, bf16* __restrict__ o) {
  __shared__ bf16 tile[kT][kT + kTPad];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int p0 = blockIdx.x * kT, c0 = blockIdx.y * kT;
  const long long base = (long long)blockIdx.z * P * C;
  for (int r = ty; r < kT; r += 8) {
    const int p = p0 + r, c = c0 + 2 * tx;
    if (p < P && c < C) {
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(x + base + (long long)p * C + c);
      tile[r][2 * tx] = v.x;
      tile[r][2 * tx + 1] = v.y;
    }
  }
  __syncthreads();
  for (int r = ty; r < kT; r += 8) {
    const int c = c0 + r, p = p0 + 2 * tx;
    if (c < C && p < P) {
      __nv_bfloat162 v;
      v.x = tile[2 * tx][r];
      v.y = tile[2 * tx + 1][r];
      *reinterpret_cast<__nv_bfloat162*>(o + base + (long long)c * P + p) = v;
    }
  }
}

// --------------------------------------------------------- rhsT and lhsT
namespace prod {
constexpr int kC = 64;                                   // channels: the contraction, M's sides
constexpr int kTile = 128;                               // pixels a tile
constexpr int kBoxes = kTile / 64;                       // 64 x 64 boxes a tile
constexpr int kStages = 4;                               // x tiles in flight a block
constexpr int kThreads = kWarpgroup + 32;                // one consumer warpgroup + a producer warp
constexpr int kMBytes = kC * kC * 2;                     // 64 rows x 128 B
constexpr int kTileBytes = kTile * kC * 2;               // a stage, and a staging tile
constexpr int kBoxBytes = 64 * kC * 2;                   // one 64 x 64 box
constexpr int kStageOffset = kMBytes;
constexpr int kOutOffset = kStageOffset + kStages * kTileBytes;
constexpr int kBarOffset = kOutOffset + 2 * kTileBytes;  // two staging tiles, used in turn
constexpr int kSmemBytes = kBarOffset + (2 * kStages + 1) * 8 + 1024;  // + alignment slack
constexpr int kAcc = kC * kTile / kWarpgroup;            // f32 sums a consumer thread
static_assert(2 * (kSmemBytes + 1024) <= 228 * 1024, "two blocks an SM");
}  // namespace prod

// x and o stream through L2 once: both sides mark their lines evict-first.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
__device__ __forceinline__ void tma_load_3d_hint(void* dst, const CUtensorMap* map, uint64_t* bar,
                                                 int c0, int c1, int c2, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void tma_store_3d_hint(const CUtensorMap* map, const void* src, int c0,
                                                  int c1, int c2, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%2, %3, %4}], [%1], %5;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// grid = min(tiles, blocks resident on the card); block = prod::kThreads.
// rhsT (kLhsT false): o[b][i][p] = sum_k M[i][k] x[b][p][k];
// lhsT (kLhsT true):  o[b][p][j] = sum_k x[b][k][p] M[k][j].
// map_m: M [64, 64], box {64, 64}; the maps of x and o are [B, P, 64] with
// box {64 ch, 128 px} (rhsT's x, lhsT's o) or [B, 64, P] with box {64 px,
// 64 ch} (rhsT's o, lhsT's x), all with the 128-byte swizzle.  Block i takes
// tiles i, i + grid, ...: the blocks in flight work on neighbouring pixels.
template <bool kLhsT>
__global__ void __launch_bounds__(prod::kThreads, 2)
product_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_m,
               const __grid_constant__ CUtensorMap map_o, int P, long long tiles) {
  using namespace prod;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ms = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* m_ready = empty + kStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    mbar_init(m_ready, 1);
    mbar_fence_init();
  }
  __syncthreads();
  const int p_tiles = (P + kTile - 1) / kTile;
  const uint64_t policy = evict_first_policy();

  if (threadIdx.x >= kWarpgroup) {
    // ------------------------------------------------------------ producer
    if (threadIdx.x == kWarpgroup) {
      prefetch_tensormap(&map_x);
      prefetch_tensormap(&map_o);
      mbar_expect_tx(m_ready, kMBytes);
      tma_load_2d(ms, &map_m, m_ready, 0, 0);
      int stage = 0;
      uint32_t phase = 0;
      for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int b = static_cast<int>(t / p_tiles), p0 = static_cast<int>(t % p_tiles) * kTile;
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* st = smem + kStageOffset + stage * kTileBytes;
        if constexpr (kLhsT) {
          // a box wholly past P is not loaded: its rows are never stored
          const int boxes = min(kBoxes, (P - p0 + 63) / 64);
          mbar_expect_tx(&full[stage], boxes * kBoxBytes);
          for (int i = 0; i < boxes; ++i)
            tma_load_3d_hint(st + i * kBoxBytes, &map_x, &full[stage], p0 + 64 * i, 0, b, policy);
        } else {
          mbar_expect_tx(&full[stage], kTileBytes);
          tma_load_3d_hint(st, &map_x, &full[stage], 0, p0, b, policy);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumer
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  mbar_wait(m_ready, 0);
  float acc[kAcc];
  int stage = 0;
  uint32_t phase = 0;
  for (long long t = blockIdx.x, it = 0; t < tiles; t += gridDim.x, ++it) {
    const int b = static_cast<int>(t / p_tiles), p0 = static_cast<int>(t % p_tiles) * kTile;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
    mbar_wait(&full[stage], phase);
    const uint8_t* st = smem + kStageOffset + stage * kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk) {
      if constexpr (kLhsT) {
        // A = x^T: 64 pixels of a box per row of 128 B, one row per
        // channel (MN-major); a 16-channel K step is 16 rows on.  B = M
        // [k][j], N-major likewise.
        const uint64_t db = smem_desc(ms + kk * 16 * 128, kBoxBytes, 1024);
#pragma unroll
        for (int i = 0; i < kBoxes; ++i)
          wgmma_bf16<64, 1, 1>(acc + 32 * i,
                               smem_desc(st + i * kBoxBytes + kk * 16 * 128, kBoxBytes, 1024), db);
      } else {
        // A = M [i][k] and B = x [p][k], both K-major: a 16-channel K step
        // is 32 bytes into each 128-byte row.
        wgmma_bf16<kTile, 0, 0>(acc, smem_desc(ms + kk * 32, 16, 1024),
                                smem_desc(st + kk * 32, 16, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<kAcc>(acc);
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }

    // Epilogue.  Sum group j (4 f32 a thread: rows r and r + 8, two
    // neighbouring columns) lands in box j / 8, 16-byte chunk j % 8: rhsT's
    // boxes are the 64-pixel slices of [64 ch][128 px], lhsT's the 64-row
    // slices of [128 px][64 ch], so one address rule serves both.
    uint8_t* buf = smem + kOutOffset + (it & 1) * kTileBytes;
    if (tid == 0) tma_store_wait_read<1>();  // the store that read buf two tiles ago is done
    named_barrier(1, kWarpgroup);
    const int r0 = 16 * warp + lane / 4;
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        uint8_t* q = buf + (j / 8) * kBoxBytes + r * 128 + (((j % 8) ^ (r & 7)) * 16) + (lane % 4) * 4;
        *reinterpret_cast<uint32_t*>(q) = pack_bf16x2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    fence_proxy_async();
    named_barrier(1, kWarpgroup);
    if (tid == 0) {
      if constexpr (kLhsT) {
        tma_store_3d_hint(&map_o, buf, 0, p0, b, policy);
      } else {
        for (int i = 0; i < kBoxes && p0 + 64 * i < P; ++i)
          tma_store_3d_hint(&map_o, buf + i * kBoxBytes, p0 + 64 * i, 0, b, policy);
      }
      tma_store_commit();
    }
  }
  if (tid == 0) tma_store_wait_all();
}

template <bool kLhsT>
cudaError_t launch_product(const void* x, const void* m, int batch, int p, void* out,
                           cudaStream_t s) {
  using namespace prod;
  if (batch <= 0 || p <= 0 || p % 8) return cudaErrorInvalidValue;
  const long long tiles = static_cast<long long>(batch) * ((p + kTile - 1) / kTile);
  const uint64_t B = batch, P = p;
  // [B, P, 64] (channels innermost) and [B, 64, P] (pixels innermost)
  const uint64_t dims_pc[3] = {kC, P, B}, strides_pc[2] = {kC * 2, P * kC * 2};
  const uint64_t dims_cp[3] = {P, kC, B}, strides_cp[2] = {P * 2, kC * P * 2};
  const uint32_t box_pc[3] = {kC, kTile, 1}, box_cp[3] = {64, kC, 1};
  const uint64_t dims_m[2] = {kC, kC}, strides_m[1] = {kC * 2};
  const uint32_t box_m[2] = {kC, kC};
  CUtensorMap map_x, map_m, map_o;
  cudaError_t err;
  if ((err = make_map_bf16(&map_m, m, 2, dims_m, strides_m, box_m, CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (err = make_map_bf16(&map_x, x, 3, kLhsT ? dims_cp : dims_pc, kLhsT ? strides_cp : strides_pc,
                           kLhsT ? box_cp : box_pc, CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (err = make_map_bf16(&map_o, out, 3, kLhsT ? dims_pc : dims_cp, kLhsT ? strides_pc : strides_cp,
                           kLhsT ? box_pc : box_cp, CU_TENSOR_MAP_SWIZZLE_128B)))
    return err;
  if ((err = cudaFuncSetAttribute(product_kernel<kLhsT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kSmemBytes)))
    return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, product_kernel<kLhsT>, kThreads,
                                                           kSmemBytes)))
    return err;
  const long long resident = static_cast<long long>(sm_count()) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  product_kernel<kLhsT><<<grid, kThreads, kSmemBytes, s>>>(map_x, map_m, map_o, p, tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [batch, p, c] bf16 -> out [batch, c, p]; p and c even.
int mdie_probe_transpose(const void* x, int batch, int p, int c, void* out, void* stream) {
  if (batch <= 0 || p <= 0 || c <= 0 || p % 2 || c % 2) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((p + kT - 1) / kT, (c + kT - 1) / kT, batch);
  transpose_kernel<<<grid, dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), p, c, static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}

// x [batch, p, 64], m [64, 64] bf16 -> out [batch, 64, p]; p a multiple of 8,
// all three 16-byte aligned.
int mdie_probe_rhsT(const void* x, const void* m, int batch, int p, void* out, void* stream) {
  return static_cast<int>(launch_product<false>(x, m, batch, p, out, static_cast<cudaStream_t>(stream)));
}

// x [batch, 64, p], m [64, 64] bf16 -> out [batch, p, 64]; p a multiple of 8,
// all three 16-byte aligned.
int mdie_probe_lhsT(const void* x, const void* m, int batch, int p, void* out, void* stream) {
  return static_cast<int>(launch_product<true>(x, m, batch, p, out, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
