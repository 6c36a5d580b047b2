// Windowed bilinear sampling for Hopper (sm_90a): the live taps of each
// block's footprint, staged in shared memory by bulk asynchronous copies.
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
// The function.  Samples come in blocks of S that share a heatmap window of
// XW x YW pixels per view.  Per block and view the window origin is
// floor(min) of the block's pixel coordinates, clipped so that the window
// stays inside the image and rounded down to a multiple of 8 (the TPU's
// slicing alignment; it decides which samples fall outside the window, so
// it is kept).  The bilinear weights are separable, max(0, 1 - |c - p|),
// and a pixel outside the window weighs nothing.  The contracted axis (x or
// y) is summed first, its window values and weights rounded as PREC says;
// then the other axis, each product rounded before it is added; then the
// views in order, times 1 / V, clamped to [0, 1].
//
// The prototypes form that sum as a dense product of the window against
// its weights: KW multiply-adds per contracted row, of which two weights
// are non-zero.  This kernel takes only those: for each sample and axis the
// pixels floor(c) and floor(c) + 1 that lie inside the window, so 4 taps
// per (sample, view, joint).  The zero terms drop out exactly: in the dense
// chain fmaf(w, 0, a) == a and s + 0 == s, so in ascending pixel order the
// contracted sum is fmaf(w1, b1, w0 * b0); in the TF32 modes the products
// of rounded operands are exact in float32.  Tensor cores have nothing left
// to contract.  What sets the time is the device-memory traffic the
// function needs (each block's coords in, its (16, S) output out: the
// bound) and the per-tap instructions that take the taps from shared
// memory; the TF32 modes' roundings of each window value add to the
// latter.
//
// Design.  One block of 256 threads per sample block.  The block's coords
// give each view's window origin and the footprint of its taps: the pixels
// floor(min) .. floor(max) + 1 on each axis, clipped to the window.
// Heatmaps come in one packed layout for both contract axes, (V, H, W, 16)
// with joint 15 zero, so one footprint row is one contiguous run of 64-byte
// pixels: warp 0 copies each row into shared memory with one
// cp.async.bulk, completing on the view's mbarrier.  The footprints are
// packed in view order into one arena, wrapping to its start, and a view
// is copied as soon as the last earlier view whose place it takes has been
// summed: as many views are in flight as the arena holds (all five at the
// tools' spreads of 10 and 12 pixels, two when footprints fill a 24 x 24
// window).  The arena holds one window at least and two at most, and
// otherwise what lets three blocks share an SM of the device, read at
// launch (its shared memory per SM, less each block's reserved and static
// shared memory): on an H100 (228 KB per SM, 1 KB reserved per block, 384
// bytes static) 73,728 bytes for 24 x 24 and 76,416 for 16 x 40 and
// 24 x 40.  A thread takes 4 joints (one float4) of S / 64 samples, four
// neighbouring threads one sample, and keeps its sums in registers across
// the views.
//
// PREC selects the rounding of the contracted axis:
//   0 fp32    float32 operands
//   1 tf32x3  window values and weights split into TF32 hi and lo parts,
//             hi*hi + (lo*hi + hi*lo)
//   2 tf32    operands rounded to TF32
//
// The launch returns cudaGetLastError(), or the error of a device or
// function attribute call (cudaErrorInvalidValue where one window does not
// fit a block's shared memory), or -1 for a configuration that is not
// instantiated.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int JP = 16;                    // joints padded to 16: a pixel is 64 bytes
constexpr int kPixelBytes = JP * sizeof(float);
constexpr int kPerSample = JP / 4;        // threads per sample, one float4 of joints each
constexpr int kSampleStride = kThreads / kPerSample;
constexpr int kMaxViews = 8;

constexpr int PREC_FP32 = 0, PREC_TF32X3 = 1, PREC_TF32 = 2;
constexpr int CONTRACT_X = 0;

constexpr int kBlocksPerSm = 3;  // the arena is sized for three blocks per SM

// Round to TF32 (10 mantissa bits), nearest with ties away from zero, low
// 13 bits cleared: what cvt.rna.tf32.f32 gives, by the bit operations of
// the plain version.
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// The contracted axis at one joint: window values b0, b1 at the pixels
// floor(c), floor(c) + 1 with weights w0, w1 (0 for a pixel outside the
// window), in the dense chain's order.  In the TF32 modes B0, B1 are the
// values rounded to TF32 and b0l, b1l (tf32x3) the rounded remainders;
// W0, W1, w0l, w1l the same of the weights.
template <int PREC>
struct Weights {
  float w0, w1, W0, W1, w0l, w1l;
  __device__ __forceinline__ Weights(float a, float b) : w0(a), w1(b) {
    if (PREC != PREC_FP32) {
      W0 = tf32_rna(a);
      W1 = tf32_rna(b);
    }
    if (PREC == PREC_TF32X3) {
      w0l = tf32_rna(a - W0);
      w1l = tf32_rna(b - W1);
    }
  }
};

template <int PREC>
__device__ __forceinline__ float contract2(const Weights<PREC>& w, float B0, float B1, float b0l,
                                           float b1l) {
  if (PREC == PREC_FP32) return fmaf(w.w1, B1, __fmul_rn(w.w0, B0));
  const float hi = fmaf(w.W1, B1, __fmul_rn(w.W0, B0));  // products of TF32 values are exact
  if (PREC == PREC_TF32) return hi;
  const float lo_hi = fmaf(b1l, w.W1, __fmul_rn(b0l, w.W0));
  const float hi_lo = fmaf(B1, w.w1l, __fmul_rn(B0, w.w0l));
  return __fadd_rn(hi, __fadd_rn(lo_hi, hi_lo));
}

// The two taps of coordinate c on one axis whose live pixels are
// [lo, hi]: weights (0 outside) and offsets into the footprint (0 outside).
struct Taps {
  float w0, w1;
  int i0, i1;
};

__device__ __forceinline__ Taps taps(float c, float lo, float hi) {
  const float p = floorf(c), q = p + 1.0f;
  const bool l0 = p >= lo && p <= hi, l1 = q >= lo && q <= hi;
  Taps t;
  t.w0 = l0 ? fmaxf(0.0f, 1.0f - fabsf(c - p)) : 0.0f;
  t.w1 = l1 ? fmaxf(0.0f, 1.0f - fabsf(c - q)) : 0.0f;
  t.i0 = l0 ? (int)(p - lo) : 0;
  t.i1 = l1 ? (int)(q - lo) : 0;
  return t;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Where each view's footprint lies in the arena and when it may be copied.
struct Plan {
  float fp[kMaxViews][4];   // x lo, x hi, y lo, y hi (pixels, inclusive)
  int off[kMaxViews];       // first pixel in the arena
  int nx[kMaxViews], ny[kMaxViews];
  uint32_t after[kMaxViews + 1];  // views to copy once view c - 1 is summed
  uint64_t bars[kMaxViews];
};

// Warp 0: copy the views of `mask`, one bulk copy per footprint row of
// nx pixels; an empty footprint completes its barrier at once.
__device__ __forceinline__ void stage_views(uint32_t mask, int lane, Plan& pl, const float* hm,
                                            float* arena, int W, int H) {
  for (; mask; mask &= mask - 1) {
    const int v = __ffs(mask) - 1, nx = pl.nx[v], ny = pl.ny[v];
    const int x0 = nx ? (int)pl.fp[v][0] : 0, y0 = ny ? (int)pl.fp[v][2] : 0;
    if (lane == 0) mbar_arrive_expect_tx(&pl.bars[v], (uint32_t)(nx * ny * JP * sizeof(float)));
    __syncwarp();
    float* dst = arena + (size_t)pl.off[v] * JP;
    for (int r = lane; r < ny; r += 32)
      bulk_copy(dst + r * nx * JP, hm + (((size_t)v * H + y0 + r) * W + x0) * JP,
                (uint32_t)(nx * JP * sizeof(float)), &pl.bars[v]);
  }
}

template <int S, int XW, int YW, int PREC, int CONTRACT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
window_sample_kernel(const float* __restrict__ coords,  // (NB, V, 2, S)
                     const float* __restrict__ hm,      // (V, H, W, 16)
                     float* __restrict__ out,           // (NB, 16, S)
                     int V, int W, int H, float inv_v,
                     int arena_pixels) {  // the dynamic shared memory, in pixels
  static_assert(S % 128 == 0, "a warp reads its coords row in float4s");
  constexpr int kItems = S / kSampleStride;  // samples per thread
  extern __shared__ __align__(128) float arena[];
  __shared__ Plan pl;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* cb = coords + (size_t)blockIdx.x * V * 2 * S;

  // window origin and footprint: row r = 2 v + c of the block's coords
  for (int r = warp; r < 2 * V; r += kWarps) {
    const float* row = cb + (size_t)r * S;
    float mn = INFINITY, mx = -INFINITY;
    for (int i = lane * 4; i < S; i += 128) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(row + i));
      mn = fminf(mn, fminf(fminf(q.x, q.y), fminf(q.z, q.w)));
      mx = fmaxf(mx, fmaxf(fmaxf(q.x, q.y), fmaxf(q.z, q.w)));
    }
    for (int o = 16; o; o >>= 1) {
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    if (lane == 0) {
      const int c = r & 1, width = c ? YW : XW;
      const float limit = (float)(c ? H - YW : W - XW);
      const int o = ((int)fminf(fmaxf(floorf(mn), 0.0f), limit) / 8) * 8;
      pl.fp[r >> 1][2 * c] = fminf(fmaxf(floorf(mn), (float)o), (float)(o + width));
      pl.fp[r >> 1][2 * c + 1] =
          fmaxf(fminf(floorf(mx) + 1.0f, (float)(o + width - 1)), (float)(o - 1));
    }
  }
  __syncthreads();

  // the plan: footprints packed in view order, wrapping to the arena's
  // start; a view is copied once the last earlier view it overlaps is
  // summed, so that as many views are in flight as the arena holds
  if (tid == 0) {
    int cur = 0;
    for (int c = 0; c <= V; ++c) pl.after[c] = 0;
    for (int v = 0; v < V; ++v) {
      mbar_init(&pl.bars[v], 1);
      const float* f = pl.fp[v];
      const bool any = f[0] <= f[1] && f[2] <= f[3];
      const int nx = any ? (int)f[1] - (int)f[0] + 1 : 0, ny = any ? (int)f[3] - (int)f[2] + 1 : 0;
      const int size = nx * ny;
      if (cur + size > arena_pixels) cur = 0;
      pl.off[v] = cur;
      pl.nx[v] = nx;
      pl.ny[v] = ny;
      int dep = -1;
      for (int u = v - 1; u >= 0 && size; --u) {
        const int su = pl.nx[u] * pl.ny[u];
        if (su && pl.off[u] < cur + size && cur < pl.off[u] + su) {
          dep = u;
          break;
        }
      }
      pl.after[dep + 1] |= 1u << v;
      cur += size;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) stage_views(pl.after[0], lane, pl, hm, arena, W, H);

  const int g = tid % kPerSample, s_first = tid / kPerSample;
  float4 acc[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int v = 0; v < V; ++v) {
    mbar_wait(&pl.bars[v], 0);
    const int nx = pl.nx[v];
    // an empty footprint adds 0 to every sum; otherwise a tap outside it
    // reads the footprint's first pixel, which this view's copy wrote, with
    // weight 0
    if (nx) {
      const float xlo = pl.fp[v][0], xhi = pl.fp[v][1], ylo = pl.fp[v][2], yhi = pl.fp[v][3];
      const float4* src = reinterpret_cast<const float4*>(arena + (size_t)pl.off[v] * JP) + g;
      const float* xs = cb + (size_t)(2 * v) * S;
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int s = s_first + k * kSampleStride;
        const Taps tx = taps(__ldg(xs + s), xlo, xhi), ty = taps(__ldg(xs + S + s), ylo, yhi);
        // pixel (ix, iy) of the footprint: JP / 4 float4 each, rows of nx
        const int q00 = (ty.i0 * nx + tx.i0) * kPerSample, q10 = (ty.i0 * nx + tx.i1) * kPerSample;
        const int q01 = (ty.i1 * nx + tx.i0) * kPerSample, q11 = (ty.i1 * nx + tx.i1) * kPerSample;
        // (other-axis pixel o, contracted pixel k) pairs, and their weights
        constexpr bool cx = CONTRACT == CONTRACT_X;
        const int a0 = q00, a1 = cx ? q10 : q01;  // o = 0
        const int b0 = cx ? q01 : q10, b1 = q11;  // o = 1
        const Weights<PREC> wk = cx ? Weights<PREC>(tx.w0, tx.w1) : Weights<PREC>(ty.w0, ty.w1);
        const float o0 = cx ? ty.w0 : tx.w0, o1 = cx ? ty.w1 : tx.w1;
        float4 A0 = src[a0], A1 = src[a1], B0 = src[b0], B1 = src[b1];
        float4 A0l, A1l, B0l, B1l;  // tf32x3: the rounded remainders
#define FVP_ROUND(m)                                                                   \
  if (PREC != PREC_FP32) {                                                             \
    const float a0f = A0.m, a1f = A1.m, b0f = B0.m, b1f = B1.m;                        \
    A0.m = tf32_rna(a0f), A1.m = tf32_rna(a1f), B0.m = tf32_rna(b0f), B1.m = tf32_rna(b1f); \
    if (PREC == PREC_TF32X3) {                                                         \
      A0l.m = tf32_rna(a0f - A0.m), A1l.m = tf32_rna(a1f - A1.m);                      \
      B0l.m = tf32_rna(b0f - B0.m), B1l.m = tf32_rna(b1f - B1.m);                      \
    }                                                                                  \
  }
#define FVP_JOINT(m)                                                                  \
  FVP_ROUND(m)                                                                        \
  acc[k].m = __fadd_rn(acc[k].m,                                                      \
                       __fadd_rn(__fmul_rn(contract2<PREC>(wk, A0.m, A1.m, A0l.m, A1l.m), o0), \
                                 __fmul_rn(contract2<PREC>(wk, B0.m, B1.m, B0l.m, B1l.m), o1)))
        FVP_JOINT(x);
        FVP_JOINT(y);
        FVP_JOINT(z);
        FVP_JOINT(w);
#undef FVP_JOINT
#undef FVP_ROUND
      }
    }
    if (pl.after[v + 1]) {
      __syncthreads();  // every thread is done with the views the next copies overwrite
      if (warp == 0) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        stage_views(pl.after[v + 1], lane, pl, hm, arena, W, H);
      }
    }
  }

  float* ob = out + (size_t)blockIdx.x * JP * S;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int s = s_first + k * kSampleStride;
    const float4 a = acc[k];
    ob[(4 * g + 0) * S + s] = fminf(fmaxf(__fmul_rn(a.x, inv_v), 0.0f), 1.0f);
    ob[(4 * g + 1) * S + s] = fminf(fmaxf(__fmul_rn(a.y, inv_v), 0.0f), 1.0f);
    ob[(4 * g + 2) * S + s] = fminf(fmaxf(__fmul_rn(a.z, inv_v), 0.0f), 1.0f);
    ob[(4 * g + 3) * S + s] = fminf(fmaxf(__fmul_rn(a.w, inv_v), 0.0f), 1.0f);
  }
}

// The arena of `kern` on the current device, in pixels: what lets
// kBlocksPerSm blocks share an SM, but at least one window and at most two,
// and no more than a block may opt in to.
cudaError_t arena_size(const void* kern, int window, int* pixels) {
  int dev = 0, per_sm = 0, reserved = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return e;
  const int fixed = (int)fa.sharedSizeBytes;
  const int budget = (per_sm / kBlocksPerSm - reserved - fixed) / kPixelBytes;
  const int most = (optin - fixed) / kPixelBytes;
  *pixels = std::min(std::min(std::max(budget, window), 2 * window), most);
  return *pixels < window ? cudaErrorInvalidValue : cudaSuccess;
}

template <int S, int XW, int YW, int PREC, int CONTRACT>
int launch(const float* coords, const float* hm, float* out, int nb, int V, int W, int H,
           float inv_v, cudaStream_t st) {
  auto kern = window_sample_kernel<S, XW, YW, PREC, CONTRACT>;
  int pixels = 0;
  cudaError_t e = arena_size((const void*)kern, XW * YW, &pixels);
  const size_t smem = (size_t)pixels * kPixelBytes;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(unsigned)nb, kThreads, smem, st>>>(coords, hm, out, V, W, H, inv_v, pixels);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// coords (NB, V, 2, S) pixel (x; y), V <= 8; hm packed (V, H, W, 16), joint
// 15 zero, for either contract axis (0 x, 1 y); out (NB, 16, S).  prec: 0
// fp32, 1 tf32x3, 2 tf32.  inv_v is float32 1 / V.  coords and hm 16-byte
// aligned.
int fvp_window_sample(const float* coords, const float* hm, float* out, int nb, int V, int W,
                      int H, float inv_v, int S, int XW, int YW, int prec, int contract,
                      void* stream) {
  if (nb <= 0) return (int)cudaGetLastError();
  if (V < 1 || V > kMaxViews) return -1;
  const cudaStream_t st = (cudaStream_t)stream;
#define FVP_WINDOW(s, xw, yw, p, c)                                 \
  if (S == s && XW == xw && YW == yw && prec == p && contract == c) \
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
