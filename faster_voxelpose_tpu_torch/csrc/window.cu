// Windowed bilinear sampling as a dense contraction, for Hopper (sm_90a).
//
// One kernel template with a plain C interface, loaded with ctypes by
// faster_voxelpose_tpu_torch/ops/window_kernels.py, which also holds its
// plain PyTorch version, its launch counters and the notes on what bounds
// it.
//
//   fvp_window_sample  replaces the two sampling prototypes that tuned the
//                      JAX package's production kernel on the TPU:
//                      _sample_kernel (scripts/probe_pallas.py:48, called
//                      at :117) and make_kernel (scripts/sweep_pallas.py:30,
//                      called at :83).
//
// Samples come in blocks of S that share a small heatmap window.  Per
// block and view: the window origin is floor(min) of the block's pixel
// coordinates, clipped so that the window stays inside the image and
// rounded down to a multiple of 8 (the TPU's slicing alignment; it decides
// which samples fall outside the window, so it is kept); the bilinear
// weights are separable, max(0, 1 - |x - xi|); the contracted axis (x or y)
// is a matrix product of the window (KW x OW*16) against its weights
// (KW x S), the other axis a multiply and sum over the OW groups of 16
// joint rows; then the view mean and a clamp to [0, 1].
//
// A thread block of 256 threads takes one sample block.  The window of one
// view (at most 40 x 392 floats) is staged in shared memory once and the S
// samples are walked in sub-tiles of 16, because the product of a whole
// block (OW*16 x S floats) would not fit the 227 KB a block may have: per
// sub-tile the weights are written, the product goes to a (OW*16 x 16)
// tile in shared memory, and one thread per (joint, sample) contracts the
// other axis and adds into the block's (16 x S) accumulator.
//
// PREC selects how the product is formed:
//   0 fp32    FFMA, 4 window rows x 1 sample per thread
//   1 tf32x3  wmma m16n16k8: both operands split into two TF32 parts,
//             lo*hi + hi*lo accumulated apart from hi*hi and added last
//   2 tf32    wmma m16n16k8 on the operands rounded to TF32
// wmma's accumulator layout is opaque, so the product is stored to shared
// memory before the rows are regrouped as (window row, joint).
//
// The launch returns cudaGetLastError(), or the error of the shared-memory
// attribute call, or -1 for a configuration that is not instantiated.

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int JP = 16;  // joints padded to 16
constexpr int NS = 16;  // samples per sub-tile: one wmma tile wide

constexpr int PREC_FP32 = 0, PREC_TF32X3 = 1, PREC_TF32 = 2;
constexpr int CONTRACT_X = 0;

static_assert(JP * NS == kThreads, "one (joint, sample) output per thread");

template <int S, int XW, int YW, int CONTRACT>
struct Shape {
  static constexpr int KW = CONTRACT == CONTRACT_X ? XW : YW;  // contracted axis
  static constexpr int OW = CONTRACT == CONTRACT_X ? YW : XW;  // the other axis
  static constexpr int M = OW * JP;    // product rows: (other-axis pixel, joint)
  static constexpr int LDW = M + 8;    // window row stride, floats
  static constexpr int LDT = NS + 4;   // product tile row stride
  static constexpr int LDB = NS + 8;   // weight tile row stride
  static constexpr int N_WIN = KW * LDW;
  static constexpr int N_T = M * LDT;
  static constexpr int N_WK = KW * LDB;
  static constexpr int N_WO = OW * LDB;
  static constexpr int N_ACC = JP * S;
  static_assert(S % NS == 0 && KW % 8 == 0 && OW % 8 == 0, "tile sizes");
  // every region starts on a 32-byte boundary, as wmma loads need
  static_assert(N_WIN % 8 == 0 && N_T % 8 == 0 && N_WK % 8 == 0 && N_WO % 8 == 0,
                "alignment");
  static size_t smem_bytes(int V) {
    return sizeof(float) * ((size_t)N_WIN + N_T + N_WK + N_WO + N_ACC +
                            (size_t)V * 2 * S) + sizeof(int) * 2 * (size_t)V;
  }
};

// Round to TF32 (10 mantissa bits), nearest with ties away from zero, low
// 13 bits cleared: what cvt.rna.tf32.f32 gives and the plain version
// repeats with bit operations.
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float(__float_as_uint(wmma::__float_to_tf32(x)) & 0xffffe000u);
}

template <int S, int XW, int YW, int PREC, int CONTRACT>
__global__ void __launch_bounds__(kThreads)
window_sample_kernel(const float* __restrict__ coords,  // (NB, V, 2, S)
                     const float* __restrict__ hm,      // packed, see below
                     float* __restrict__ out,           // (NB, JP, S)
                     int V, int W, int H, float inv_v) {
  using C = Shape<S, XW, YW, CONTRACT>;
  constexpr int KW = C::KW, OW = C::OW, M = C::M;
  constexpr int LDW = C::LDW, LDT = C::LDT, LDB = C::LDB;
  extern __shared__ __align__(128) float smem[];
  float* win = smem;
  float* t = win + C::N_WIN;
  float* wk = t + C::N_T;
  float* wo = wk + C::N_WK;
  float* acc = wo + C::N_WO;
  float* crd = acc + C::N_ACC;
  int* org = reinterpret_cast<int*>(crd + (size_t)V * 2 * S);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* cb = coords + (size_t)blockIdx.x * V * 2 * S;
  for (int i = tid; i < V * 2 * S; i += kThreads) crd[i] = cb[i];
  for (int i = tid; i < JP * S; i += kThreads) acc[i] = 0.0f;
  __syncthreads();

  // window origins: row r = 2 v + c of the block's coords, c = 0 for x
  for (int r = warp; r < 2 * V; r += kWarps) {
    float m = INFINITY;
    for (int i = lane; i < S; i += 32) m = fminf(m, crd[r * S + i]);
    for (int o = 16; o; o >>= 1) m = fminf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) {
      const float hi = (float)((r & 1) ? H - YW : W - XW);
      const int o = (int)fminf(fmaxf(floorf(m), 0.0f), hi);
      org[r] = (o / 8) * 8;
    }
  }
  __syncthreads();

  // packed heatmaps: contract x -> (V, W, H*JP), contract y -> (V, H, W*JP)
  const int rows = CONTRACT == CONTRACT_X ? W : H;
  const int cols = (CONTRACT == CONTRACT_X ? H : W) * JP;

  for (int v = 0; v < V; ++v) {
    const int ox = org[2 * v], oy = org[2 * v + 1];
    const int ok = CONTRACT == CONTRACT_X ? ox : oy;
    const int oo = CONTRACT == CONTRACT_X ? oy : ox;
    const float* xs = crd + (2 * v) * S;
    const float* ck = CONTRACT == CONTRACT_X ? xs : xs + S;
    const float* co = CONTRACT == CONTRACT_X ? xs + S : xs;

    // stage the window: KW rows of M contiguous floats
    const float* src = hm + ((size_t)v * rows + ok) * cols + (size_t)oo * JP;
    for (int i = tid; i < KW * (M / 4); i += kThreads) {
      const int k = i / (M / 4), m4 = i % (M / 4);
      const float4 val = __ldg(reinterpret_cast<const float4*>(src + (size_t)k * cols) + m4);
      *reinterpret_cast<float4*>(win + k * LDW + m4 * 4) = val;
    }

    for (int s0 = 0; s0 < S; s0 += NS) {
      // separable weights of this sub-tile; 1 - |d| has no product, so
      // nothing contracts into an FMA
      for (int i = tid; i < (KW + OW) * NS; i += kThreads) {
        const int r = i / NS, n = i % NS;
        if (r < KW) {
          wk[r * LDB + n] = fmaxf(0.0f, 1.0f - fabsf(ck[s0 + n] - (float)(ok + r)));
        } else {
          const int q = r - KW;
          wo[q * LDB + n] = fmaxf(0.0f, 1.0f - fabsf(co[s0 + n] - (float)(oo + q)));
        }
      }
      __syncthreads();  // weights, and on the first sub-tile the window

      // t (M x NS) = window^T (M x KW) . wk (KW x NS)
      if (PREC == PREC_FP32) {
        for (int i = tid; i < (M / 4) * NS; i += kThreads) {
          const int n = i % NS, mg = i / NS;
          float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
          for (int k = 0; k < KW; ++k) {
            const float4 w4 = *reinterpret_cast<const float4*>(win + k * LDW + mg * 4);
            const float b = wk[k * LDB + n];
            a0 = fmaf(w4.x, b, a0);
            a1 = fmaf(w4.y, b, a1);
            a2 = fmaf(w4.z, b, a2);
            a3 = fmaf(w4.w, b, a3);
          }
          float* dst = t + (mg * 4) * LDT + n;
          dst[0] = a0;
          dst[LDT] = a1;
          dst[2 * LDT] = a2;
          dst[3 * LDT] = a3;
        }
      } else {
        for (int mt = warp; mt < M / 16; mt += kWarps) {
          wmma::fragment<wmma::accumulator, 16, 16, 8, float> c, c_small;
          wmma::fill_fragment(c, 0.0f);
          wmma::fill_fragment(c_small, 0.0f);
#pragma unroll
          for (int k0 = 0; k0 < KW; k0 += 8) {
            wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::col_major> a, a_lo;
            wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::row_major> b, b_lo;
            wmma::load_matrix_sync(a, win + k0 * LDW + mt * 16, LDW);
            wmma::load_matrix_sync(b, wk + k0 * LDB, LDB);
#pragma unroll
            for (int i = 0; i < a.num_elements; ++i) {
              const float full = a.x[i];
              a.x[i] = tf32_rna(full);
              a_lo.x[i] = tf32_rna(full - a.x[i]);
            }
#pragma unroll
            for (int i = 0; i < b.num_elements; ++i) {
              const float full = b.x[i];
              b.x[i] = tf32_rna(full);
              b_lo.x[i] = tf32_rna(full - b.x[i]);
            }
            if (PREC == PREC_TF32X3) {
              wmma::mma_sync(c_small, a_lo, b, c_small);
              wmma::mma_sync(c_small, a, b_lo, c_small);
            }
            wmma::mma_sync(c, a, b, c);
          }
          if (PREC == PREC_TF32X3) {
#pragma unroll
            for (int i = 0; i < c.num_elements; ++i) c.x[i] += c_small.x[i];
          }
          wmma::store_matrix_sync(t + mt * 16 * LDT, c, LDT, wmma::mem_row_major);
        }
      }
      __syncthreads();

      // the other axis: rows of t are (pixel o, joint j); each product
      // rounds before it is added, as the plain version's multiply and sum
      {
        const int j = tid / NS, n = tid % NS;
        float sum = 0.0f;
#pragma unroll
        for (int o = 0; o < OW; ++o)
          sum = __fadd_rn(sum, __fmul_rn(t[(o * JP + j) * LDT + n], wo[o * LDB + n]));
        acc[j * S + s0 + n] += sum;
      }
      __syncthreads();  // t, wk, wo and (after the last sub-tile) win are free
    }
  }

  float* ob = out + (size_t)blockIdx.x * JP * S;
  for (int i = tid; i < JP * S; i += kThreads)
    ob[i] = fminf(fmaxf(__fmul_rn(acc[i], inv_v), 0.0f), 1.0f);
}

template <int S, int XW, int YW, int PREC, int CONTRACT>
int launch(const float* coords, const float* hm, float* out, int nb, int V,
           int W, int H, float inv_v, cudaStream_t st) {
  using C = Shape<S, XW, YW, CONTRACT>;
  const size_t smem = C::smem_bytes(V);
  auto kern = window_sample_kernel<S, XW, YW, PREC, CONTRACT>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(unsigned)nb, kThreads, smem, st>>>(coords, hm, out, V, W, H, inv_v);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// coords (NB, V, 2, S) pixel (x; y); hm packed (V, W, H*16) for contract = 0
// (x) or (V, H, W*16) for contract = 1 (y), joint 15 zero; out (NB, 16, S).
// prec: 0 fp32, 1 tf32x3, 2 tf32.  inv_v is float32 1 / V.
int fvp_window_sample(const float* coords, const float* hm, float* out, int nb,
                      int V, int W, int H, float inv_v, int S, int XW, int YW,
                      int prec, int contract, void* stream) {
  if (nb <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
#define FVP_WINDOW(s, xw, yw, p, c)                                         \
  if (S == s && XW == xw && YW == yw && prec == p && contract == c)         \
    return launch<s, xw, yw, p, c>(coords, hm, out, nb, V, W, H, inv_v, st)
  FVP_WINDOW(256, 24, 24, PREC_FP32, 0);  // also the probe's configuration
  FVP_WINDOW(256, 24, 24, PREC_TF32X3, 0);
  FVP_WINDOW(256, 24, 24, PREC_TF32, 0);
  FVP_WINDOW(256, 24, 24, PREC_TF32X3, 1);
  FVP_WINDOW(256, 16, 40, PREC_TF32X3, 1);
  FVP_WINDOW(128, 16, 40, PREC_TF32X3, 1);
  FVP_WINDOW(256, 24, 40, PREC_TF32X3, 1);
  FVP_WINDOW(512, 24, 24, PREC_TF32X3, 0);
  FVP_WINDOW(512, 16, 40, PREC_TF32X3, 1);
#undef FVP_WINDOW
  return -1;
}

}  // extern "C"
