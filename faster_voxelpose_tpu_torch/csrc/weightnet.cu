// WeightNet's folded front for Hopper (sm_90a): one kernel, weightnet_kernel,
// with a plain C interface, loaded with ctypes by
// faster_voxelpose_tpu_torch/ops/weightnet_kernels.py, which also holds its
// plain PyTorch version and its launch counter.
//
//   fvp_weightnet     feats (M, J, H, W) float32, any strides -> per map the
//                     compute dtype's rounding of the input, the 3x3 conv
//                     (1 -> C channels, zero padding 1) with the folded bias,
//                     the 2x2 max, ReLU and the mean over the (H/2)(W/2)
//                     pooled positions -> out (M*J, C) in the compute dtype
//                     (float32 or bf16).
//
// It replaces no Pallas kernel: the JAX package's WeightNet
// (faster_voxelpose_tpu/models/cnns.py) is flax layers that XLA fuses on the
// TPU.  On the card the same front ran as four library launches: the input's
// reshape copy and cast, cuDNN's fused conv + bias + ReLU (a one-channel
// input, which cuDNN serves on its CUDA-core implicit_convolve_sgemm), an
// NCHW max pool over the (M*J, C, H, W) conv output (134 MB of bf16 at
// Shelf's M*J = 510, C = 32, 64x64, written once and read back) and the
// mean.
//
// Bound on an H100: operations.  At Shelf the work is 510 * 32 * 4096 * 9 =
// 602M multiply-adds, 1.2 GFLOP of float32 FMA on the CUDA cores: about
// 18 us at 67 TFLOP/s.  The bytes are 8.4 MB of float32 maps in and 510 * 32
// values out, about 2.5 us at 3.35 TB/s.  (The benchmark's share,
// roofline.weightnet_kernel, counts the operations at the bf16 tensor-core
// peak, so that it reads the same work whatever implements it; there the
// bytes bound.)
//
// Design.  One block of 128 threads per map; all 450-510 maps of a request
// are one launch, and all fit on the card at once (4 blocks an SM).  The
// block stages its map with a one-pixel zero halo in shared memory (66 x 66
// floats, 17 KB, at 64 x 64), rounded to the compute dtype on the way in,
// with each channel's 9 taps and bias as three float4s beside it: the map is
// read from device memory once, through the strides it arrives with
// (P2PNet's channels-last output needs no copy), and the conv output never
// leaves the SM.  Each thread owns 2 x 4 pooled positions: it keeps the
// 6 x 10 input patch under them in registers and, per channel, computes the
// 32 pre-pool outputs (float32 FMAs from the bias, taps in (kh, kw) order),
// the eight 2x2 maxima, rounds each to the compute dtype (rounding is
// monotone, so once after the max is the library's rounding of every conv
// output before it), applies ReLU and adds them into a float32 warp sum by
// shuffles, kept by the lane of that channel: per channel 288 FMAs against
// three shared loads, ten shuffle steps and the pool's ~64 operations.
// Per-warp channel sums meet in shared memory; C threads add them in warp
// order, multiply by 1 / ((H/2)(W/2)) (torch's mean) and round once.  For
// the float32 model the same template runs with no rounding.  No TF32 and no
// paired bf16 arithmetic: the products of rounded operands are exact in
// float32 and every sum is float32, in another order than cuDNN's.
// Each launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStripX = 4;               // pooled columns a thread takes
constexpr int kStripY = 2;               // pooled rows a thread takes
constexpr int kPatchW = 2 * kStripX + 2;  // input columns under them, halo included
constexpr int kPatchH = 2 * kStripY + 2;  // input rows
constexpr int kMaxChannels = 64;         // two channel sums a lane
constexpr int kErrSharedMemory = -1;

// The compute dtype's rounding of a float32 value, and its loads and stores.
template <typename T>
struct Dtype;

template <>
struct Dtype<float> {
  __device__ static float round(float v) { return v; }
  __device__ static float load(const float* p) { return __ldg(p); }
  __device__ static void store(float* p, float v) { *p = v; }
};

template <>
struct Dtype<__nv_bfloat16> {
  __device__ static float round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
  __device__ static float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  __device__ static void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
};

struct Launch {
  int groups_x, groups_y;  // the map's groups of kStripY x kStripX pooled positions, one a thread
  int tile_w, tile_h;      // shared tile: every thread's patch, halo included, zero beyond
  size_t smem;             // bytes
};

Launch weightnet_launch(int H, int W, int C) {
  Launch l;
  l.groups_x = (W / 2 + kStripX - 1) / kStripX;
  l.groups_y = (H / 2 + kStripY - 1) / kStripY;
  l.tile_w = 2 * kStripX * l.groups_x + 2;
  l.tile_h = 2 * kStripY * l.groups_y + 2;
  l.smem = sizeof(float) * ((size_t)l.tile_h * l.tile_w + (size_t)C * 12 + (size_t)kWarps * C);
  return l;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
weightnet_kernel(const float* __restrict__ x, const T* __restrict__ w,
                 const T* __restrict__ b, T* __restrict__ out, int J, int H, int W, int C,
                 long long sM, long long sJ, long long sH, long long sW, int groups_x,
                 int groups_y, int tile_w, int tile_h, float inv_count) {
  extern __shared__ float4 smem4[];
  float4* wt = smem4;                             // C x 3: taps 0-3, 4-7, (8, bias, 0, 0)
  float* tile = reinterpret_cast<float*>(wt + C * 3);  // tile_h x tile_w, zero halo
  float* red = tile + (size_t)tile_h * tile_w;    // kWarps x C warp sums
  const int map = blockIdx.x;
  const int m = map / J, j = map - m * J;
  const float* src = x + m * sM + j * sJ;

  float* wf = reinterpret_cast<float*>(wt);
  for (int i = threadIdx.x; i < C * 12; i += kThreads) {
    const int ch = i / 12, t = i - ch * 12;
    wf[i] = t < 9 ? Dtype<T>::load(w + ch * 9 + t) : t == 9 ? Dtype<T>::load(b + ch) : 0.0f;
  }
  const int cells = tile_h * tile_w;
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    const int r = i / tile_w - 1, c = i - (r + 1) * tile_w - 1;
    float v = 0.0f;
    if (r >= 0 && r < H && c >= 0 && c < W) v = Dtype<T>::round(__ldg(src + r * sH + c * sW));
    tile[i] = v;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int PH = H / 2, PW = W / 2;
  const int n = groups_y * groups_x;
  float sum_lo = 0.0f, sum_hi = 0.0f;  // this warp's sums of channels lane and lane + 32
  for (int base = 0; base < n; base += kThreads) {
    // every lane of a warp runs every round, so that the shuffles see all 32
    const int s = base + threadIdx.x;
    const int gy = s < n ? s / groups_x : 0;
    const int gx = s < n ? s - gy * groups_x : 0;
    unsigned live = 0;  // bit (r * kStripX + q): pooled (kStripY * gy + r, kStripX * gx + q)
#pragma unroll
    for (int r = 0; r < kStripY; ++r)
#pragma unroll
      for (int q = 0; q < kStripX; ++q)
        if (s < n && kStripY * gy + r < PH && kStripX * gx + q < PW)
          live |= 1u << (r * kStripX + q);
    float in[kPatchH][kPatchW];
    const float* p = tile + (2 * kStripY * gy) * tile_w + 2 * kStripX * gx;
#pragma unroll
    for (int r = 0; r < kPatchH; ++r)
#pragma unroll
      for (int c = 0; c < kPatchW; ++c) in[r][c] = p[r * tile_w + c];
    for (int ch = 0; ch < C; ++ch) {
      const float4 k0 = wt[ch * 3], k1 = wt[ch * 3 + 1], k2 = wt[ch * 3 + 2];
      const float k[9] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w, k2.x};
      float part = 0.0f;
#pragma unroll
      for (int r = 0; r < kStripY; ++r)
#pragma unroll
        for (int q = 0; q < kStripX; ++q) {
          float o[2][2];
#pragma unroll
          for (int dy = 0; dy < 2; ++dy)
#pragma unroll
            for (int dx = 0; dx < 2; ++dx) {
              float a = k2.y;  // the bias, then the taps in (kh, kw) order
#pragma unroll
              for (int kh = 0; kh < 3; ++kh)
#pragma unroll
                for (int kw = 0; kw < 3; ++kw)
                  a = fmaf(k[kh * 3 + kw], in[2 * r + dy + kh][2 * q + dx + kw], a);
              o[dy][dx] = a;
            }
          const float mx = fmaxf(fmaxf(o[0][0], o[0][1]), fmaxf(o[1][0], o[1][1]));
          const float v = fmaxf(Dtype<T>::round(mx), 0.0f);
          part += (live >> (r * kStripX + q)) & 1u ? v : 0.0f;
        }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      if ((ch & 31) == lane) {
        if (ch < 32) sum_lo += part; else sum_hi += part;
      }
    }
  }
  if (lane < C) red[warp * C + lane] = sum_lo;
  if (lane + 32 < C) red[warp * C + lane + 32] = sum_hi;
  __syncthreads();
  if (threadIdx.x < C) {
    float s = 0.0f;
    for (int i = 0; i < kWarps; ++i) s += red[i * C + threadIdx.x];
    Dtype<T>::store(out + (size_t)map * C + threadIdx.x, s * inv_count);
  }
}

cudaError_t max_smem(int* bytes) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

template <typename T>
int launch(const float* x, const void* w, const void* b, void* out, int M, int J, int H, int W,
           int C, long long sM, long long sJ, long long sH, long long sW, cudaStream_t stream) {
  const Launch l = weightnet_launch(H, W, C);
  int most = 0;
  cudaError_t e = max_smem(&most);
  if (e != cudaSuccess) return (int)e;
  if (l.smem > (size_t)most) return kErrSharedMemory;
  if (l.smem > 48 * 1024) {
    e = cudaFuncSetAttribute(weightnet_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)l.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const float inv_count = 1.0f / (float)((H / 2) * (W / 2));
  weightnet_kernel<T><<<(unsigned)(M * J), kThreads, l.smem, stream>>>(
      x, static_cast<const T*>(w), static_cast<const T*>(b), static_cast<T*>(out), J, H, W, C,
      sM, sJ, sH, sW, l.groups_x, l.groups_y, l.tile_w, l.tile_h, inv_count);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// feats x (M, J, H, W) float32 at element strides sM, sJ, sH, sW; folded
// weight w (C, 1, 3, 3) and bias b (C,) in the compute dtype, contiguous;
// out (M * J, C) in the compute dtype, contiguous.  bf16 = 1 for
// __nv_bfloat16, 0 for float32.  H and W even, 1 <= C <= 64 (the wrapper
// checks).  Returns kErrSharedMemory (-1) when H and W need more shared
// memory than a block may have, else the launch's CUDA error.  Safe to call
// while the stream is captured into a CUDA graph (PoseService captures the
// served forward): cudaGetDevice, cudaDeviceGetAttribute and
// cudaFuncSetAttribute are no stream work, and the kernel reads the weights
// through their pointers, so a refold into the same buffers reaches a
// captured graph.
int fvp_weightnet(const float* x, const void* w, const void* b, void* out, int M, int J, int H,
                  int W, int C, long long sM, long long sJ, long long sH, long long sW, int bf16,
                  void* stream) {
  if (M <= 0 || J <= 0 || C <= 0 || C > kMaxChannels) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16) return launch<__nv_bfloat16>(x, w, b, out, M, J, H, W, C, sM, sJ, sH, sW, st);
  return launch<float>(x, w, b, out, M, J, H, W, C, sM, sJ, sH, sW, st);
}

}  // extern "C"
