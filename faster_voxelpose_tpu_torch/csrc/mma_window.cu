// Tensor-core cost of a windowed contraction, for Hopper (sm_90a).
//
// One kernel template with a plain C interface, loaded with ctypes by
// faster_voxelpose_tpu_torch/ops/window_kernels.py, which also holds its
// plain PyTorch version and its launch counter.
//
//   fvp_mma_window  replaces the matrix-unit microbenchmark body of
//                   scripts/microbench_matmul.py:31 (called at :65): a grid
//                   of B steps; step b slices a (K, M) window from a
//                   resident (128, M) bf16 buffer at row 0 or at oy[b] (a
//                   multiple of 16) and contracts it nmat times against
//                   rhs[b, :K] (K, N) bf16 into a float32 (M, N) sum, of
//                   which the first 8 rows, divided by nmat, are written
//                   as bf16.
//
// One block of 256 threads per step b.  lhs stays in shared memory for
// the whole block (128 x (M + 8) bf16, 166 KB at M = 640); rhs[b, :K] is
// walked in chunks of 64 columns staged in shared memory.  Warp w owns the
// 16-row tiles w, w + 8, ... of the product and holds 4 accumulator
// fragments (16 x 64) at a time; the product is wmma m16n16k16 bf16 with
// float32 accumulation, A read column-major straight from the resident
// window (window^T is the left operand), B row-major from the chunk.
//
// Only 8 of the M rows are stored.  So that the compiler cannot drop the
// other tiles' products, every accumulator is stored to `sink` when *flag
// is non-zero; the flag lives in device memory and is never set.  The
// nmat products are identical on purpose (the script amortises the step's
// overhead that way); the loop over them is not unrolled.  A dynamic
// origin that is not a multiple of 16 inside the buffer gives a step of
// NaN rather than a read outside shared memory.
//
// The launch returns cudaGetLastError(), or the error of the shared-memory
// attribute call, or -1 for a K that is not instantiated.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 128;   // rows of lhs and of one rhs step
constexpr int kChunk = 64;   // rhs columns per chunk: 4 wmma tiles
constexpr int kLdb = kChunk + 8;

size_t smem_bytes(int M) {
  return sizeof(bf16) * ((size_t)kRows * (M + 8) + (size_t)kRows * kLdb) +
         sizeof(float) * kWarps * 256;
}

template <int K, bool DYN>
__global__ void __launch_bounds__(kThreads)
mma_window_kernel(const bf16* __restrict__ lhs,  // (128, M)
                  const bf16* __restrict__ rhs,  // (B, 128, N)
                  const int* __restrict__ oy,    // (B,) multiples of 16
                  bf16* __restrict__ out,        // (B, 8, N)
                  int M, int N, int nmat, float inv_nmat,
                  const int* __restrict__ flag, float* __restrict__ sink) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int lda = M + 8;
  bf16* lhs_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* rhs_s = lhs_s + (size_t)kRows * lda;
  float* stage = reinterpret_cast<float*>(rhs_s + (size_t)kRows * kLdb);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const int keep = *flag;
  const int origin = DYN ? oy[b] : 0;
  if (DYN && (origin < 0 || origin > kRows - K || (origin & 15))) {
    // not a window of lhs: the step's rows are written as NaN
    for (int i = tid; i < 8 * N; i += kThreads)
      out[(size_t)b * 8 * N + i] = __float2bfloat16_rn(nanf(""));
    return;
  }

  // lhs -> shared memory, 8 bf16 (16 bytes) per copy
  const int m8 = M / 8;
  for (int i = tid; i < kRows * m8; i += kThreads) {
    const int r = i / m8, c = i % m8;
    *reinterpret_cast<uint4*>(lhs_s + (size_t)r * lda + c * 8) =
        __ldg(reinterpret_cast<const uint4*>(lhs + (size_t)r * M) + c);
  }

  const bf16* rb = rhs + (size_t)b * kRows * N;
  float* my_stage = stage + warp * 256;
  for (int n0 = 0; n0 < N; n0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed (and lhs is written)
    for (int i = tid; i < K * (kChunk / 8); i += kThreads) {
      const int r = i / (kChunk / 8), c = i % (kChunk / 8);
      *reinterpret_cast<uint4*>(rhs_s + r * kLdb + c * 8) =
          __ldg(reinterpret_cast<const uint4*>(rb + (size_t)r * N + n0) + c);
    }
    __syncthreads();

    for (int mt = warp; mt < M / 16; mt += kWarps) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) wmma::fill_fragment(acc[q], 0.0f);
#pragma unroll 1
      for (int r = 0; r < nmat; ++r) {
#pragma unroll
        for (int k0 = 0; k0 < K; k0 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
          wmma::load_matrix_sync(a, lhs_s + (size_t)(origin + k0) * lda + mt * 16, lda);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
            wmma::load_matrix_sync(bm, rhs_s + k0 * kLdb + q * 16, kLdb);
            wmma::mma_sync(acc[q], a, bm, acc[q]);
          }
        }
      }
      if (mt == 0) {
        // rows 0..7 of the sum, divided by nmat, as bf16
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          wmma::store_matrix_sync(my_stage, acc[q], 16, wmma::mem_row_major);
          __syncwarp();
          for (int i = lane; i < 8 * 16; i += 32) {
            const int row = i / 16, col = i % 16;
            out[((size_t)b * 8 + row) * N + n0 + q * 16 + col] =
                __float2bfloat16_rn(__fmul_rn(my_stage[row * 16 + col], inv_nmat));
          }
          __syncwarp();
        }
      } else if (keep) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wmma::store_matrix_sync(sink + warp * 256, acc[q], 16, wmma::mem_row_major);
      }
    }
  }
}

template <int K, bool DYN>
int launch(const bf16* lhs, const bf16* rhs, const int* oy, bf16* out, int B,
           int M, int N, int nmat, float inv_nmat, const int* flag, float* sink,
           cudaStream_t st) {
  const size_t smem = smem_bytes(M);
  auto kern = mma_window_kernel<K, DYN>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(unsigned)B, kThreads, smem, st>>>(lhs, rhs, oy, out, M, N, nmat,
                                            inv_nmat, flag, sink);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// lhs (128, M) bf16, rhs (B, 128, N) bf16, oy (B,) int32 (read when dyn),
// out (B, 8, N) bf16; M a multiple of 16, N of 64; flag one int32 holding
// 0, sink at least 2048 floats.  inv_nmat is float32 1 / nmat.
int fvp_mma_window(const void* lhs, const void* rhs, const int* oy, void* out,
                   int B, int M, int N, int K, int dyn, int nmat,
                   float inv_nmat, const int* flag, float* sink, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  const bf16* l = static_cast<const bf16*>(lhs);
  const bf16* r = static_cast<const bf16*>(rhs);
  bf16* o = static_cast<bf16*>(out);
#define FVP_MMA(k)                                                            \
  if (K == k)                                                                 \
    return dyn ? launch<k, true>(l, r, oy, o, B, M, N, nmat, inv_nmat, flag,  \
                                 sink, st)                                    \
               : launch<k, false>(l, r, oy, o, B, M, N, nmat, inv_nmat, flag, \
                                  sink, st)
  FVP_MMA(128);
  FVP_MMA(64);
  FVP_MMA(32);
#undef FVP_MMA
  return -1;
}

}  // extern "C"
