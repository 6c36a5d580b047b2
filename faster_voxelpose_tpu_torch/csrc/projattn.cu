// MvP's projective attention for Hopper (sm_90a), one launch per decoder
// layer.
//
// A plain C interface, loaded with ctypes by
// faster_voxelpose_tpu_torch/ops/projattn_kernels.py, which holds its plain
// PyTorch version (F.grid_sample per level), its launch counter and the
// notes on what bounds it.  It replaces no Pallas kernel: the JAX package
// has no MvP.
//
// For every query q (a person's joint), view v and head m: the query's
// reference point y in [0, 1]^3 of the capture space is taken to world mm
// (y * size + lo), projected into view v by the port's projection
// (projection.cuh: the camera frame, divide, distortion, intrinsics, clamp
// and the original-image -> network-input affine) and normalised by the
// network input's size to u.  The head's L x P taps lie at u + offset /
// (W_l, H_l) on level l's value map (V, H_l, W_l, D) bf16 channels-last,
// sampled bilinearly as F.grid_sample(align_corners=False,
// padding_mode='zeros') samples: pixel u * W_l - 0.5, corners outside the
// map read 0.  The taps' weights are the softmax over the head's L * P
// logits.  The output s[v, q, m * Dh + c] is the weighted sum over the
// taps of channel c of head m, summed in float32 and rounded to bf16 once.
//
// Design.  One block per (query, view, sample), one warp per head, one lane
// per channel of the head (Dh <= 32 channels): a corner load of a warp
// reads Dh contiguous bf16 (64 bytes at Dh = 32).  Thread 0 projects the
// query's point into the view once, into shared memory; each warp then
// holds its head's logits and offsets one per lane (L * P <= 16 taps),
// takes the softmax by shuffles, and walks the taps with each tap's weight
// and offset broadcast from the lane that holds it.  No atomics, no
// shared-memory staging: the value maps (103 MB at MvP's Panoptic widths)
// exceed the 50 MB L2, and each (query, view, head) reads its own 4 x L x
// P corners, so the work is the gathers' latency; the 750 blocks of 8
// warps at Panoptic (150 queries x 5 views) are resident in one wave on 132
// SMs.  Bound on an H100: bytes, the 4 corners x Dh channels x 2 B of each
// tap, 18.4 MB a launch at Panoptic, 19.0 MB with the offsets and logits
// in and the output out (about 5.7 us at 3.35 TB/s).
// Returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "projection.cuh"

namespace {

constexpr int kMaxLevels = 4;
constexpr int kLanes = 32;  // one warp per head, one lane per channel of it
constexpr unsigned kFull = 0xffffffffu;

// The frames of the projection, 15 host floats in this order.
struct ProjAttnConsts {
  float scale[3];      // world(y) = y * scale + lo: the space's size, mm
  float lo[3];         // the space's centre - size / 2, mm
  float t[6];          // original image -> network input affine, row-major
  float clip_hi;       // max(original image w, h): the pixel's clamp
  float img_w, img_h;  // the network input's size
};

struct Levels {
  const __nv_bfloat16* val[kMaxLevels];
  int H[kMaxLevels], W[kMaxLevels];
};

// Channel `lane` of the bilinear sample at pixel (px, py) of one map whose
// pixels are D channels apart (base points at the head's channel), zeros
// outside; the corner index is clamped before its conversion, so no
// coordinate overflows.
__device__ __forceinline__ float bilinear(const __nv_bfloat16* __restrict__ base, float px,
                                          float py, int H, int W, int D, bool active) {
  const float x0 = floorf(px), y0 = floorf(py);
  const float wx1 = px - x0, wy1 = py - y0;
  const float wx0 = 1.0f - wx1, wy0 = 1.0f - wy1;
  const float wmax = (float)(W - 1), hmax = (float)(H - 1);
  const bool inx0 = x0 >= 0.0f && x0 <= wmax, inx1 = x0 + 1.0f >= 0.0f && x0 + 1.0f <= wmax;
  const bool iny0 = y0 >= 0.0f && y0 <= hmax, iny1 = y0 + 1.0f >= 0.0f && y0 + 1.0f <= hmax;
  const int ix0 = (int)fminf(fmaxf(x0, -1.0f), wmax);
  const int iy0 = (int)fminf(fmaxf(y0, -1.0f), hmax);
  const ptrdiff_t i00 = ((ptrdiff_t)iy0 * W + ix0) * D, row = (ptrdiff_t)W * D;
  float c00 = 0.0f, c01 = 0.0f, c10 = 0.0f, c11 = 0.0f;
  if (active) {
    if (inx0 && iny0) c00 = __bfloat162float(base[i00]);
    if (inx1 && iny0) c01 = __bfloat162float(base[i00 + D]);
    if (inx0 && iny1) c10 = __bfloat162float(base[i00 + row]);
    if (inx1 && iny1) c11 = __bfloat162float(base[i00 + row + D]);
  }
  return c00 * (wx0 * wy0) + c01 * (wx1 * wy0) + c10 * (wx0 * wy1) + c11 * (wx1 * wy1);
}

__global__ void __launch_bounds__(1024)
projattn_kernel(Levels lv, int L, int P, const float* __restrict__ ref,
                const float* __restrict__ offsets, const float* __restrict__ logits,
                const float* __restrict__ cams, ProjAttnConsts k,
                __nv_bfloat16* __restrict__ out, int Q, int V, int M, int Dh) {
  const int q = blockIdx.x, v = blockIdx.y, b = blockIdx.z;
  const int m = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int D = M * Dh, LP = L * P;
  __shared__ float s_uv[2];
  if (threadIdx.x == 0) {
    const float* y = ref + ((size_t)b * Q + q) * 3;
    const float* c = cams + ((size_t)b * V + v) * 21;
    const float x = ADD(MUL(y[0], k.scale[0]), k.lo[0]);
    const float yy = ADD(MUL(y[1], k.scale[1]), k.lo[1]);
    const float z = ADD(MUL(y[2], k.scale[2]), k.lo[2]);
    float qx, qy;
    camera_to_input(c, world_to_camera(c, 0, x, yy, z), world_to_camera(c, 1, x, yy, z),
                    world_to_camera(c, 2, x, yy, z), k.t, k.clip_hi, 0.0f, 0.0f, qx, qy);
    s_uv[0] = DIV(qx, k.img_w);
    s_uv[1] = DIV(qy, k.img_h);
  }
  __syncthreads();
  const float u = s_uv[0], w = s_uv[1];

  // the head's softmax over its L * P logits, one per lane
  const size_t head = ((size_t)b * Q + q) * M + m;
  const float lg = lane < LP ? logits[head * LP + lane] : -INFINITY;
  float mx = lg;
  for (int o = kLanes / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  const float e = lane < LP ? expf(lg - mx) : 0.0f;
  float sum = e;
  for (int o = kLanes / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
  const float a = e / sum;
  const float off = lane < 2 * LP ? offsets[head * 2 * LP + lane] : 0.0f;

  const bool active = lane < Dh;
  float acc = 0.0f;
  for (int l = 0; l < L; ++l) {
    const int H = lv.H[l], W = lv.W[l];
    const float fw = (float)W, fh = (float)H;
    const __nv_bfloat16* base = lv.val[l] + ((size_t)b * V + v) * H * W * D + m * Dh + lane;
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      const int i = l * P + p;
      const float ai = __shfl_sync(kFull, a, i);
      const float dx = __shfl_sync(kFull, off, 2 * i), dy = __shfl_sync(kFull, off, 2 * i + 1);
      const float px = (u + dx / fw) * fw - 0.5f, py = (w + dy / fh) * fh - 0.5f;
      acc += ai * bilinear(base, px, py, H, W, D, active);
    }
  }
  if (active) out[(((size_t)b * V + v) * Q + q) * D + m * Dh + lane] = __float2bfloat16_rn(acc);
}

}  // namespace

extern "C" {

// values: L <= 4 maps (B, V, H_l, W_l, M * Dh) bf16 (v0..v3, unused ones
// null), ref (B, Q, 3), offsets (B, Q, M, L, P, 2), logits (B, Q, M, L, P),
// cams (B, V, 21) float32, consts the 15 host floats of ProjAttnConsts ->
// out (B, V, Q, M * Dh) bf16.  The wrapper checks M <= 32, Dh <= 32 and
// 2 * L * P <= 32.
int fvp_projattn(const void* v0, const void* v1, const void* v2, const void* v3, int H0, int W0,
                 int H1, int W1, int H2, int W2, int H3, int W3, int L, int P,
                 const float* ref, const float* offsets, const float* logits,
                 const float* cams, const float* consts, void* out, int B, int Q, int V, int M,
                 int Dh, void* stream) {
  if (B <= 0 || Q <= 0 || V <= 0) return (int)cudaGetLastError();
  Levels lv;
  const void* vals[kMaxLevels] = {v0, v1, v2, v3};
  const int hs[kMaxLevels] = {H0, H1, H2, H3}, ws[kMaxLevels] = {W0, W1, W2, W3};
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.val[l] = static_cast<const __nv_bfloat16*>(vals[l]);
    lv.H[l] = hs[l];
    lv.W[l] = ws[l];
  }
  ProjAttnConsts k;
  float* dst = reinterpret_cast<float*>(&k);
  for (int i = 0; i < (int)(sizeof(ProjAttnConsts) / sizeof(float)); ++i) dst[i] = consts[i];
  const dim3 grid((unsigned)Q, (unsigned)V, (unsigned)B);
  projattn_kernel<<<grid, M * kLanes, 0, (cudaStream_t)stream>>>(
      lv, L, P, ref, offsets, logits, cams, k, static_cast<__nv_bfloat16*>(out), Q, V, M, Dh);
  return (int)cudaGetLastError();
}

}  // extern "C"
