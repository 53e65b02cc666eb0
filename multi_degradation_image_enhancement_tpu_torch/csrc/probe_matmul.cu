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
// int8 design (gemm_int8_kernel): wgmma on s8 needs both operands K-major,
// and B lies N-major, so the int8 GEMM keeps WMMA mma.sync: a thread block
// owns a 128x128 output tile of one batch entry and walks K 32 elements a
// step through two cp.async stages; every 16-element row slice is staged on
// a 32-byte boundary (an int8 slice is padded), as wmma::load_matrix_sync
// requires; eight warps each hold a 32x64 accumulator; the i32 output is
// stored from the fragments directly.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
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

// --------------------------------------------------------- int8: mma.sync
using namespace nvcuda;

namespace i8 {
constexpr int kBM = 128, kBN = 128;  // output tile of a thread block
constexpr int kBK = 32;              // elements of K per pipeline stage
constexpr int kSliceBytes = 32;      // shared bytes of a 16-element row slice (16 + 16 pad)
constexpr int kPadBytes = 16;        // row padding of the shared tiles
constexpr int kThreads = 256;        // 8 warps as 4 (rows) x 2 (columns)
constexpr int kWarpM = 32, kWarpN = 64;
constexpr int kARowBytes = kBK / 16 * kSliceBytes + kPadBytes;  // A tile: [kBM] rows
constexpr int kBRowBytes = kBN / 16 * kSliceBytes + kPadBytes;  // B tile: [kBK] rows
constexpr int kABytes = kBM * kARowBytes;
constexpr int kBBytes = kBK * kBRowBytes;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kLda = kARowBytes, kLdb = kBRowBytes;  // WMMA leading dimensions (elements)
constexpr int kSlice = kSliceBytes;                  // elements from one slice to the next
}  // namespace i8

__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gptr) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem_ptr)), "l"(gptr));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Stage K step ``kt``: A rows [0, kBM) of the block from element kt*kBK of
// each row; B rows kt*kBK .. +kBK of the block's kBN columns.  Each 16-byte
// copy is one row slice, placed at the start of its 32-byte slot.
__device__ __forceinline__ void load_stage_i8(unsigned char* stage, const unsigned char* a_blk,
                                              const unsigned char* b_blk, int K, int N, int kt,
                                              int tid) {
  using namespace i8;
  constexpr int kAChunks = kBK / 16;
  for (int c = tid; c < kBM * kAChunks; c += kThreads) {
    const int r = c / kAChunks, q = c % kAChunks;
    cp_async16(stage + r * kARowBytes + q * kSliceBytes,
               a_blk + (long long)r * K + (long long)kt * kBK + q * 16);
  }
  constexpr int kBChunks = kBN / 16;
  for (int c = tid; c < kBK * kBChunks; c += kThreads) {
    const int r = c / kBChunks, q = c % kBChunks;
    cp_async16(stage + kABytes + r * kBRowBytes + q * kSliceBytes,
               b_blk + ((long long)kt * kBK + r) * N + q * 16);
  }
}

// grid = (N / 128, M / 128, batch); block = 256.
__global__ void __launch_bounds__(i8::kThreads)
gemm_int8_kernel(const signed char* __restrict__ a, const signed char* __restrict__ b, int M,
                 int K, int N, int* __restrict__ out) {
  using namespace i8;
  __shared__ __align__(128) unsigned char smem[2 * kStageBytes];

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const long long img = blockIdx.z;
  const int bm = blockIdx.y, bn = blockIdx.x;
  const auto* a_blk = reinterpret_cast<const unsigned char*>(a + (img * M + (long long)bm * kBM) * K);
  const auto* b_blk = reinterpret_cast<const unsigned char*>(b + img * K * N + (long long)bn * kBN);

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int k_steps = K / kBK;
  load_stage_i8(smem, a_blk, b_blk, K, N, 0, tid);
  cp_async_commit();
  for (int kt = 0; kt < k_steps; ++kt) {
    if (kt + 1 < k_steps) {
      load_stage_i8(smem + ((kt + 1) & 1) * kStageBytes, a_blk, b_blk, K, N, kt + 1, tid);
      cp_async_commit();
      cp_async_wait<1>();  // step kt has landed; step kt + 1 stays in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* st = smem + (kt & 1) * kStageBytes;
    const signed char* As = reinterpret_cast<const signed char*>(st);
    const signed char* Bs = reinterpret_cast<const signed char*>(st + kABytes);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * kWarpM + i * 16) * kLda + kk / 16 * kSlice, kLda);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * kLdb + (wn * kWarpN / 16 + j) * kSlice, kLdb);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // nobody reads this stage again before it is refilled
  }

  const long long row0 = (long long)bm * kBM + wm * kWarpM;
  const int col0 = bn * kBN + wn * kWarpN;
  int* o = out + img * M * N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(o + (row0 + i * 16) * N + col0 + j * 16, acc[i][j], N,
                              wmma::mem_row_major);
}

cudaError_t launch_int8(const void* a, const void* b, int batch, int m, int k, int n, void* out,
                        cudaStream_t s) {
  using namespace i8;
  if (batch <= 0 || batch > 65535 || m % kBM || n % kBN || k % kBK) return cudaErrorInvalidValue;
  const dim3 grid(n / kBN, m / kBM, batch);
  gemm_int8_kernel<<<grid, kThreads, 0, s>>>(static_cast<const signed char*>(a),
                                             static_cast<const signed char*>(b), m, k, n,
                                             static_cast<int*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a [batch, m, k], b [batch, k, n], row-major, 16-byte aligned.
// int8 == 0: bf16 operands, bf16 out; k and n multiples of 8.
// int8 == 1: int8 operands, int32 out; m and n multiples of 128, k of 32.
int mdie_probe_matmul(const void* a, const void* b, int int8, int batch, int m, int k, int n,
                      void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8) return static_cast<int>(launch_int8(a, b, batch, m, k, n, out, s));
  return static_cast<int>(launch_bf16(a, b, batch, m, k, n, out, s));
}

}  // extern "C"
