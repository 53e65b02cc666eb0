// Batched GEMM of the int8 / bf16 throughput probe for Hopper (sm_90a):
// o[i] = a[i] @ b[i], a [batch, M, K], b [batch, K, N], o [batch, M, N],
// all row-major, accumulated in acc_dtype and cast once to out_dtype.
//
// Replaces:
//   benchmarks/exp_int8_reprobe.py
//     _mm_kernel (pallas_call at :52, built by build :49)      -> probe_matmul
//
// Two type sets, those of the probe (exp_int8_reprobe.py:97-99):
//   bf16 operands, f32 accumulation, bf16 out (one round-to-nearest-even);
//   int8 operands, i32 accumulation, i32 out (exact).
//
// Bound: 2*M*K*N operations against (M*K + K*N) operand bytes and M*N output
// elements a block; at the probe's [1536,512]x[512,2048] x 32 the bf16 GEMM
// is bound by the tensor cores (103 GFLOP at 989 TFLOP/s) and the int8 one
// by its i32 output (403 MB of 461 MB at 3.35 TB/s).  The TPU grid (block,
// N/512) with the whole [M, K] operand in VMEM was a VMEM answer.
//
// bf16 design (gemm_bf16_kernel): the card's full tensor-core rate is only
// reached through wgmma fed by TMA, so the kernel is warp-specialised and
// persistent.  One thread block per SM walks output tiles of 128x256 (batch,
// then M, then N).  Warpgroup 2 is the producer: one thread keeps a ring of
// four stages of 64 K-elements in flight, each one TMA box of A (viewed as
// [batch, M, K], K-major, 16 KB) and four boxes of B ([batch, K, N], read
// N-major as it lies, 4 x 8 KB), all with the 128-byte swizzle, completion
// on the stage's "full" mbarrier.  Warpgroups 0 and 1 are the consumers:
// each runs wgmma m64n256k16 on its 64-row half (B with the transpose bit,
// so it is never transposed in memory), keeps one group of products in
// flight, and frees a stage on its "empty" mbarrier (one arrival a warp)
// once the products that read it are done.  Registers are moved from the
// producer (40) to the consumers (232) with setmaxnreg.  The epilogue rounds
// the f32 sums to bf16 once and, in two halves of 128 columns, writes them
// into a 128-byte-swizzled staging area (conflict-free: the 8 rows of a
// store land in 8 different 16-byte chunks) that two TMA stores a
// warpgroup write out, clipping the ragged M and N edges; the producer
// meanwhile loads the next tile.  Staging half the tile is what leaves room
// for a fourth stage (4 x 48 KB + 32 KB).  K is
// any multiple of 8 (TMA strides are multiples of 16 bytes): a ragged last
// K step reads zeros past K, from the 3-D maps' bounds.
//
// int8 design (transpose_i8_kernel + gemm_int8_kernel): at the probe's
// shape the bound is 0.138 ms of bytes (the i32 output is 403 MB of 461 MB;
// the products alone take 0.052 ms at 1,979 TOP/s), so the kernel must keep
// the output stream busy while it multiplies.  8-bit wgmma takes both
// operands K-major only (no transpose bit), and b lies N-major, as it does
// for o^T = b^T a^T too.  So a first pass turns b into an int8 scratch bt
// [batch, N, K] (67 MB moved, counted in the kernel's time), and the GEMM
// runs on the bf16 kernel's frame: persistent, warp-specialised, a TMA
// producer with a ring of four stages of 128 K (one 16 KB box of A and one
// of bt, 128-byte swizzle), two consumer warpgroups on wgmma m64n128k32
// .s32.s8.s8 over 128x128 tiles.  The epilogue stages each consumer's
// 64x128 i32 sums in four 128-byte-swizzled boxes and TMA-stores them; the
// consumer goes on to the next tile's products while they drain, and waits
// for them only before its next epilogue.  M and N multiples of 128, K of 32
// (the pass's tiles; the GEMM's maps read zeros past a ragged last K step).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

namespace {

// ------------------------------------------------------------- bf16: wgmma
namespace bf16 {
constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 4;
constexpr int kConsumers = 2;                               // warpgroups, 64 rows each
constexpr int kThreads = (kConsumers + 1) * kWarpgroup;     // + the producer warpgroup
constexpr int kABytes = kBM * kBK * 2;                      // 128 rows x 128 B
constexpr int kBBoxBytes = kBK * 64 * 2;                    // 64 K rows x 64 N
constexpr int kBBytes = (kBN / 64) * kBBoxBytes;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kOutBoxBytes = 64 * 64 * 2;                   // 64 rows x 64 N
constexpr int kOutBoxes = 2;                                // a consumer's staged boxes
constexpr int kOutBytes = kConsumers * kOutBoxes * kOutBoxBytes;
constexpr int kBarOffset = kStages * kStageBytes + kOutBytes;
constexpr int kSmemBytes = kBarOffset + 2 * kStages * 8 + 1024;  // + alignment slack
constexpr int kAcc = kBN / 2;                               // f32 sums a consumer thread
}  // namespace bf16

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void __launch_bounds__(bf16::kThreads, 1)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const __grid_constant__ CUtensorMap map_o, int batch, int M, int K, int N) {
  using namespace bf16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* empty = full + kStages;

  const int wg = threadIdx.x / kWarpgroup, tid = threadIdx.x % kWarpgroup;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int m_tiles = (M + kBM - 1) / kBM, n_tiles = (N + kBN - 1) / kBN;
  const int k_steps = (K + kBK - 1) / kBK;
  const int tiles = batch * m_tiles * n_tiles;

  if (wg == kConsumers) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int b = t / (m_tiles * n_tiles), rem = t % (m_tiles * n_tiles);
        const int m0 = rem / n_tiles * kBM, n0 = rem % n_tiles * kBN;
        for (int kb = 0; kb < k_steps; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* st = smem + stage * kStageBytes;
          mbar_expect_tx(&full[stage], kStageBytes);
          tma_load_3d(st, &map_a, &full[stage], kb * kBK, m0, b);
#pragma unroll
          for (int j = 0; j < kBN / 64; ++j)
            tma_load_3d(st + kABytes + j * kBBoxBytes, &map_b, &full[stage], n0 + 64 * j,
                        kb * kBK, b);
          if (++stage == kStages) {
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
    uint8_t* out_smem = smem + kStages * kStageBytes + wg * kOutBoxes * kOutBoxBytes;
    float acc[kAcc];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int b = t / (m_tiles * n_tiles), rem = t % (m_tiles * n_tiles);
      const int m0 = rem / n_tiles * kBM, n0 = rem % n_tiles * kBN;
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
      int prev = -1;
      for (int kb = 0; kb < k_steps; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint8_t* st = smem + stage * kStageBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t da = smem_desc(st + wg * 64 * 128 + kk * 32, 16, 1024);
          const uint64_t db = smem_desc(st + kABytes + kk * 16 * 128, kBBoxBytes, 1024);
          wgmma_bf16<kBN, 0, 1>(acc, da, db);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products are done: free its stage
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs<kAcc>(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);

      // Epilogue, in two halves of 128 columns through one staging area:
      // each half waits until the previous stores have read it.
      const int r0 = 16 * warp + lane / 4;
#pragma unroll
      for (int half = 0; half < kBN / 64 / kOutBoxes; ++half) {
        if (tid == 0) tma_store_wait_read<0>();
        named_barrier(1 + wg, kWarpgroup);
#pragma unroll
        for (int j = 0; j < kOutBoxes * 8; ++j) {
          const int jj = half * kOutBoxes * 8 + j, box = j / 8, chunk = j % 8;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            uint8_t* p = out_smem + box * kOutBoxBytes + r * 128 + ((chunk ^ (r & 7)) * 16) +
                         (lane % 4) * 4;
            *reinterpret_cast<uint32_t*>(p) =
                pack_bf16x2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
          }
        }
        fence_proxy_async();
        named_barrier(1 + wg, kWarpgroup);
        if (tid == 0 && m0 + 64 * wg < M) {
#pragma unroll
          for (int box = 0; box < kOutBoxes; ++box) {
            const int n = n0 + 64 * (half * kOutBoxes + box);
            if (n < N) tma_store_3d(&map_o, out_smem + box * kOutBoxBytes, n, m0 + 64 * wg, b);
          }
          tma_store_commit();
        }
      }
    }
    if (tid == 0) tma_store_wait_all();
  }
}

cudaError_t launch_bf16(const void* a, const void* b, int batch, int m, int k, int n, void* out,
                        cudaStream_t s) {
  using namespace bf16;
  if (batch <= 0 || m <= 0 || k <= 0 || n <= 0 || k % 8 || n % 8) return cudaErrorInvalidValue;
  const uint64_t B = batch, M = m, K = k, N = n;
  CUtensorMap map_a, map_b, map_o;
  const uint64_t dims_a[3] = {K, M, B}, strides_a[2] = {K * 2, M * K * 2};
  const uint64_t dims_b[3] = {N, K, B}, strides_b[2] = {N * 2, K * N * 2};
  const uint64_t dims_o[3] = {N, M, B}, strides_o[2] = {N * 2, M * N * 2};
  const uint32_t box_a[3] = {kBK, kBM, 1}, box_b[3] = {64, kBK, 1}, box_o[3] = {64, 64, 1};
  cudaError_t err;
  if ((err = make_map_bf16(&map_a, a, 3, dims_a, strides_a, box_a, CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (err = make_map_bf16(&map_b, b, 3, dims_b, strides_b, box_b, CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (err = make_map_bf16(&map_o, out, 3, dims_o, strides_o, box_o, CU_TENSOR_MAP_SWIZZLE_128B)))
    return err;
  if ((err = cudaFuncSetAttribute(gemm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kSmemBytes)))
    return err;
  const long long tiles = B * ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  if (tiles > (1ll << 31) - 1) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(tiles < sm_count() ? tiles : sm_count());
  gemm_bf16_kernel<<<grid, kThreads, kSmemBytes, s>>>(map_a, map_b, map_o, batch, m, k, n);
  return cudaGetLastError();
}

// ------------------------------------------------------------ int8: wgmma
namespace i8 {
constexpr int kBM = 128, kBN = 128, kBK = 128, kStages = 4;  // kBK: int8 = 128-byte rows
constexpr int kConsumers = 2;                               // warpgroups, 64 rows each
constexpr int kThreads = (kConsumers + 1) * kWarpgroup;     // + the producer warpgroup
constexpr int kABytes = kBM * kBK;                          // 128 M rows x 128 B
constexpr int kBBytes = kBN * kBK;                          // 128 N rows x 128 B
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kOutBoxCols = 32;                             // i32 columns of a 128-byte box row
constexpr int kOutBoxBytes = 64 * kOutBoxCols * 4;          // 64 rows x 32 i32
constexpr int kOutBoxes = kBN / kOutBoxCols;                // a consumer's whole 64 x 128 tile
constexpr int kOutBytes = kConsumers * kOutBoxes * kOutBoxBytes;
constexpr int kBarOffset = kStages * kStageBytes + kOutBytes;
constexpr int kSmemBytes = kBarOffset + 2 * kStages * 8 + 1024;  // + alignment slack
constexpr int kAcc = kBN / 2;                               // i32 sums a consumer thread
constexpr int kTK = 32, kTN = 128;                          // the transpose pass's tile
}  // namespace i8

// The pre-pass: bt[z] = b[z]^T, b [batch, K, N] -> bt [batch, N, K], int8,
// so that B is K-major for wgmma.  grid = (N / 128, K / 32, batch); block =
// 256.  A thread loads 16 bytes of a 128-byte row of b, and stores 16
// consecutive k of one column n, so a warp writes 16 whole 32-byte sectors.
__global__ void __launch_bounds__(256)
transpose_i8_kernel(const int8_t* __restrict__ b, int K, int N, int8_t* __restrict__ bt) {
  using namespace i8;
  __shared__ uint32_t tile[kTK][kTN / 4 + 1];  // rows of 132 bytes: column reads spread over banks
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.z * K * N;
  const int k0 = blockIdx.y * kTK, n0 = blockIdx.x * kTN;
  {
    const int r = tid / 8, c = tid % 8;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(b + base + (long long)(k0 + r) * N + n0 + 16 * c));
    tile[r][4 * c] = v.x;
    tile[r][4 * c + 1] = v.y;
    tile[r][4 * c + 2] = v.z;
    tile[r][4 * c + 3] = v.w;
  }
  __syncthreads();
  const int n = tid / 2, half = tid % 2;
  const auto* t8 = reinterpret_cast<const uint8_t*>(&tile[0][0]);
  constexpr int kRow = (kTN / 4 + 1) * 4;
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[i] |= static_cast<uint32_t>(t8[(16 * half + 4 * i + j) * kRow + n]) << (8 * j);
  }
  *reinterpret_cast<uint4*>(bt + base + (long long)(n0 + n) * K + k0 + 16 * half) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

// The GEMM on the transposed B: o[z] = a[z] . bt[z]^T, both operands
// K-major.  The frame of gemm_bf16_kernel: persistent, one producer thread
// keeping kStages stages of 128 K (one 128-byte-swizzled TMA box of A [128
// M rows] and one of bt [128 N rows]) in flight, two consumer warpgroups
// running wgmma m64n128k32 s8 on their 64-row halves.  The epilogue stages a
// consumer's whole 64 x 128 i32 tile in four 128-byte-swizzled boxes and
// TMA-stores them; it waits only for the previous tile's stores to have
// read the staging, so the stores drain while the next tile's products run.
__global__ void __launch_bounds__(i8::kThreads, 1)
gemm_int8_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const __grid_constant__ CUtensorMap map_o, int batch, int M, int K, int N) {
  using namespace i8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* empty = full + kStages;

  const int wg = threadIdx.x / kWarpgroup, tid = threadIdx.x % kWarpgroup;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int m_tiles = (M + kBM - 1) / kBM, n_tiles = (N + kBN - 1) / kBN;
  const int k_steps = (K + kBK - 1) / kBK;
  const int tiles = batch * m_tiles * n_tiles;

  if (wg == kConsumers) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int b = t / (m_tiles * n_tiles), rem = t % (m_tiles * n_tiles);
        const int m0 = rem / n_tiles * kBM, n0 = rem % n_tiles * kBN;
        for (int kb = 0; kb < k_steps; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* st = smem + stage * kStageBytes;
          mbar_expect_tx(&full[stage], kStageBytes);
          tma_load_3d(st, &map_a, &full[stage], kb * kBK, m0, b);
          tma_load_3d(st + kABytes, &map_b, &full[stage], kb * kBK, n0, b);
          if (++stage == kStages) {
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
    uint8_t* out_smem = smem + kStages * kStageBytes + wg * kOutBoxes * kOutBoxBytes;
    int acc[kAcc];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int b = t / (m_tiles * n_tiles), rem = t % (m_tiles * n_tiles);
      const int m0 = rem / n_tiles * kBM, n0 = rem % n_tiles * kBN;
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0;
      int prev = -1;
      for (int kb = 0; kb < k_steps; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint8_t* st = smem + stage * kStageBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk) {
          // A: this warpgroup's 64 rows; B: the 128 N rows; both K-major,
          // 32 int8 = 32 bytes a step.
          const uint64_t da = smem_desc(st + wg * 64 * 128 + kk * 32, 16, 1024);
          const uint64_t db = smem_desc(st + kABytes + kk * 32, 16, 1024);
          wgmma_s8<kBN>(acc, da, db);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products are done: free its stage
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs<kAcc>(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);

      // Epilogue: sum group j (rows r and r + 8, columns 8j + 2(lane % 4)
      // and + 1) goes to box j / 4, 16-byte chunk 2(j % 4) + (lane % 4) / 2,
      // swizzled by the row, 8 bytes a store.
      if (tid == 0) tma_store_wait_read<0>();  // the previous tile's stores have read the staging
      named_barrier(1 + wg, kWarpgroup);
      const int r0 = 16 * warp + lane / 4, q = lane % 4;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int box = j / 4, chunk = 2 * (j % 4) + q / 2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          uint8_t* p = out_smem + box * kOutBoxBytes + r * 128 + ((chunk ^ (r & 7)) * 16) + (q & 1) * 8;
          *reinterpret_cast<int2*>(p) = make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
      fence_proxy_async();
      named_barrier(1 + wg, kWarpgroup);
      if (tid == 0) {
#pragma unroll
        for (int box = 0; box < kOutBoxes; ++box)
          tma_store_3d(&map_o, out_smem + box * kOutBoxBytes, n0 + kOutBoxCols * box, m0 + 64 * wg, b);
        tma_store_commit();
      }
    }
    if (tid == 0) tma_store_wait_all();
  }
}

cudaError_t launch_int8(const void* a, const void* b, int batch, int m, int k, int n, void* out,
                        void* bt, cudaStream_t s) {
  using namespace i8;
  if (batch <= 0 || batch > 65535 || m <= 0 || k <= 0 || n <= 0 || m % kBM || n % kBN || k % kTK)
    return cudaErrorInvalidValue;
  const uint64_t B = batch, M = m, K = k, N = n;
  CUtensorMap map_a, map_b, map_o;
  const uint64_t dims_a[3] = {K, M, B}, strides_a[2] = {K, M * K};
  const uint64_t dims_b[3] = {K, N, B}, strides_b[2] = {K, N * K};
  const uint64_t dims_o[3] = {N, M, B}, strides_o[2] = {N * 4, M * N * 4};
  const uint32_t box_a[3] = {kBK, kBM, 1}, box_b[3] = {kBK, kBN, 1};
  const uint32_t box_o[3] = {kOutBoxCols, 64, 1};
  cudaError_t err;
  if ((err = make_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, a, 3, dims_a, strides_a, box_a,
                      CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (err = make_map(&map_b, CU_TENSOR_MAP_DATA_TYPE_UINT8, bt, 3, dims_b, strides_b, box_b,
                      CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (err = make_map(&map_o, CU_TENSOR_MAP_DATA_TYPE_INT32, out, 3, dims_o, strides_o, box_o,
                      CU_TENSOR_MAP_SWIZZLE_128B)))
    return err;
  transpose_i8_kernel<<<dim3(n / kTN, k / kTK, batch), 256, 0, s>>>(
      static_cast<const int8_t*>(b), k, n, static_cast<int8_t*>(bt));
  if ((err = cudaGetLastError())) return err;
  if ((err = cudaFuncSetAttribute(gemm_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kSmemBytes)))
    return err;
  const long long tiles = B * (M / kBM) * (N / kBN);
  if (tiles > (1ll << 31) - 1) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(tiles < sm_count() ? tiles : sm_count());
  gemm_int8_kernel<<<grid, kThreads, kSmemBytes, s>>>(map_a, map_b, map_o, batch, m, k, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a [batch, m, k], b [batch, k, n], row-major, 16-byte aligned.
// int8 == 0: bf16 operands, bf16 out; k and n multiples of 8; bt unused.
// int8 == 1: int8 operands, int32 out; m and n multiples of 128, k of 32,
// batch <= 65535; bt: int8 scratch [batch, n, k], 16-byte aligned.  Two
// launches: the transpose of b into bt, then the GEMM.
int mdie_probe_matmul(const void* a, const void* b, int int8, int batch, int m, int k, int n,
                      void* out, void* bt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8) return static_cast<int>(launch_int8(a, b, batch, m, k, n, out, bt, s));
  return static_cast<int>(launch_bf16(a, b, batch, m, k, n, out, s));
}

}  // extern "C"
