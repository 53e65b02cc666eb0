// Batched GEMM of the int8 / bf16 throughput probe for Hopper (sm_90a):
// o[i] = a[i] @ b[i], a [batch, M, K], b [batch, K, N], o [batch, M, N],
// all row-major, accumulated in acc_dtype and cast once to out_dtype.
//
// Replaces:
//   benchmarks/exp_int8_reprobe.py
//     _mm_kernel (pallas_call at :52, built by build :49)      -> probe_matmul
//
// Two instantiations, those of the probe (exp_int8_reprobe.py:97-99):
//   bf16 operands, f32 accumulation, bf16 out (one round-to-nearest-even);
//   int8 operands, i32 accumulation, i32 out (exact).
//
// Bound: 2*M*K*N operations against (M*K + K*N) operand bytes and M*N output
// elements a block; at the probe's [1536,512]x[512,2048] x 32 the bf16 GEMM
// is bound by the tensor cores (103 GFLOP at 989 TFLOP/s) and the int8 one
// by its i32 output (403 MB of 461 MB at 3.35 TB/s).  Design: the TPU grid
// (block, N/512) walked one block at a time with the whole [M, K] operand in
// VMEM was a VMEM answer; here a thread block owns a 128x128 output tile of
// one batch entry and walks K 32 elements a step.  Both operand tiles are
// staged in shared memory by cp.async, two stages deep so the next tile's
// copy overlaps this tile's products.  Every 16-element slice of a staged
// row (a WMMA fragment's row) starts on a 32-byte boundary, as
// wmma::load_matrix_sync requires of its pointer: a bf16 slice fills its 32
// bytes, an int8 slice (16 bytes) is followed by 16 bytes of padding; rows
// are padded by 16 more bytes against bank conflicts.  Eight warps each hold
// a 32x64 accumulator (2 x 4 WMMA 16x16x16 fragments, mma.sync on the tensor
// cores) in registers.  The bf16 output goes through a per-warp shared
// scratch so each lane writes 16 bytes; the i32 output is stored from the
// fragments directly.  wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kBM = 128, kBN = 128;  // output tile of a thread block
constexpr int kBK = 32;              // elements of K per pipeline stage
constexpr int kSliceBytes = 32;      // shared bytes of a 16-element row slice
constexpr int kPadBytes = 16;        // row padding of the shared tiles
constexpr int kThreads = 256;        // 8 warps as 4 (rows) x 2 (columns)
constexpr int kWarpM = 32, kWarpN = 64;

template <typename In>
struct Tile {
  static constexpr int kElem = sizeof(In);
  static constexpr int kCopies = kElem;  // 16-byte copies of a slice: 2 bf16, 1 int8
  static constexpr int kARowBytes = kBK / 16 * kSliceBytes + kPadBytes;  // A tile: [kBM] rows
  static constexpr int kBRowBytes = kBN / 16 * kSliceBytes + kPadBytes;  // B tile: [kBK] rows
  static constexpr int kABytes = kBM * kARowBytes;
  static constexpr int kBBytes = kBK * kBRowBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kLda = kARowBytes / kElem;  // WMMA leading dimensions (elements)
  static constexpr int kLdb = kBRowBytes / kElem;
  static constexpr int kSlice = kSliceBytes / kElem;  // elements from one slice to the next
};

template <typename In> struct AccOf;
template <> struct AccOf<__nv_bfloat16> { using type = float; };
template <> struct AccOf<signed char> { using type = int; };

__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gptr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gptr));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Shared byte offset, within a staged row, of the row's 16-byte copy ``q``.
template <typename In>
__device__ __forceinline__ int slot(int q) {
  using T = Tile<In>;
  return q / T::kCopies * kSliceBytes + q % T::kCopies * 16;
}

// Stage K step ``kt``: A rows [0, kBM) of the block from element kt*kBK of
// each row; B rows kt*kBK .. +kBK of the block's kBN columns.
template <typename In>
__device__ __forceinline__ void load_stage(unsigned char* stage, const unsigned char* a_blk,
                                           const unsigned char* b_blk, int K, int N, int kt,
                                           int tid) {
  using T = Tile<In>;
  constexpr int kAChunks = kBK * T::kElem / 16;
  const long long a_row = (long long)K * T::kElem;
  for (int c = tid; c < kBM * kAChunks; c += kThreads) {
    const int r = c / kAChunks, q = c % kAChunks;
    cp_async16(stage + r * T::kARowBytes + slot<In>(q),
               a_blk + r * a_row + (long long)kt * kBK * T::kElem + q * 16);
  }
  constexpr int kBChunks = kBN * T::kElem / 16;
  const long long b_row = (long long)N * T::kElem;
  for (int c = tid; c < kBK * kBChunks; c += kThreads) {
    const int r = c / kBChunks, q = c % kBChunks;
    cp_async16(stage + T::kABytes + r * T::kBRowBytes + slot<In>(q),
               b_blk + ((long long)kt * kBK + r) * b_row + q * 16);
  }
}

// grid = (N / 128, M / 128, batch); block = 256.
template <typename In, typename Out>
__global__ void __launch_bounds__(kThreads)
probe_matmul_kernel(const In* __restrict__ a, const In* __restrict__ b, int M, int K, int N,
                    Out* __restrict__ out) {
  using T = Tile<In>;
  using Acc = typename AccOf<In>::type;
  __shared__ __align__(128) unsigned char smem[2 * T::kStageBytes];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const long long img = blockIdx.z;
  const int bm = blockIdx.y, bn = blockIdx.x;
  const auto* a_blk = reinterpret_cast<const unsigned char*>(
      a + (img * M + (long long)bm * kBM) * K);
  const auto* b_blk = reinterpret_cast<const unsigned char*>(
      b + img * K * N + (long long)bn * kBN);

  wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], Acc(0));

  const int k_steps = K / kBK;
  load_stage<In>(smem, a_blk, b_blk, K, N, 0, tid);
  cp_async_commit();
  for (int kt = 0; kt < k_steps; ++kt) {
    if (kt + 1 < k_steps) {
      load_stage<In>(smem + ((kt + 1) & 1) * T::kStageBytes, a_blk, b_blk, K, N, kt + 1, tid);
      cp_async_commit();
      cp_async_wait<1>();  // step kt has landed; step kt + 1 stays in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* st = smem + (kt & 1) * T::kStageBytes;
    const In* As = reinterpret_cast<const In*>(st);
    const In* Bs = reinterpret_cast<const In*>(st + T::kABytes);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, In, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, In, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * kWarpM + i * 16) * T::kLda + kk / 16 * T::kSlice,
                               T::kLda);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * T::kLdb + (wn * kWarpN / 16 + j) * T::kSlice,
                               T::kLdb);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // nobody reads this stage again before it is refilled
  }

  const long long row0 = (long long)bm * kBM + wm * kWarpM;
  const int col0 = bn * kBN + wn * kWarpN;
  Out* o = out + img * M * N;
  if constexpr (std::is_same<Out, int>::value) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(o + (row0 + i * 16) * N + col0 + j * 16, acc[i][j], N,
                                wmma::mem_row_major);
  } else {
    // The pipeline's buffers are free after the last __syncthreads: each
    // warp rounds its fragments through 1 KB of them, 16 bytes a lane.
    float* scratch = reinterpret_cast<float*>(smem) + warp * 256;
    const int r = lane / 2, c8 = (lane % 2) * 8;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        alignas(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(scratch[r * 16 + c8 + e]);
        *reinterpret_cast<uint4*>(o + (row0 + i * 16 + r) * N + col0 + j * 16 + c8) =
            *reinterpret_cast<const uint4*>(v);
        __syncwarp();
      }
    }
  }
}

template <typename In, typename Out>
cudaError_t launch(const void* a, const void* b, int batch, int m, int k, int n, void* out,
                   cudaStream_t s) {
  if (batch <= 0 || m % kBM || n % kBN || k % kBK) return cudaErrorInvalidValue;
  const dim3 grid(n / kBN, m / kBM, batch);
  probe_matmul_kernel<In, Out><<<grid, kThreads, 0, s>>>(
      static_cast<const In*>(a), static_cast<const In*>(b), m, k, n, static_cast<Out*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a [batch, m, k], b [batch, k, n], row-major, 16-byte aligned; m and n
// multiples of 128, k of 32.  int8 == 0: bf16 operands,
// bf16 out; int8 == 1: int8 operands, int32 out.
int mdie_probe_matmul(const void* a, const void* b, int int8, int batch, int m, int k, int n,
                      void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8) return static_cast<int>(launch<signed char, int>(a, b, batch, m, k, n, out, s));
  return static_cast<int>(launch<__nv_bfloat16, __nv_bfloat16>(a, b, batch, m, k, n, out, s));
}

}  // extern "C"
