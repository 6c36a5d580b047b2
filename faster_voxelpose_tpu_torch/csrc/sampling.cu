// Multi-view bilinear heatmap sampling for Hopper (sm_90a).
//
// Two kernels with a plain C interface, loaded with ctypes by
// faster_voxelpose_tpu_torch/ops/sampling_kernels.py, which also holds
// their plain PyTorch versions, their launch counters and the notes on
// what bounds them.
//
//   fvp_sample_whole  replaces the JAX package's sample_tiles in cube mode
//                     (ops/pallas_sampling.py:947), called by
//                     project_whole_pallas (models/projection.py:340)
//   fvp_sample_crop   the crop sampler of project_individual_planes_pallas
//                     (models/projection.py:459-571) in its four modes:
//                     pixels projected in the kernel or read from coords,
//                     times three max planes or the masked cube.  It
//                     replaces sample_tiles_fused (:1010) and sample_tiles
//                     (:947) with emit_planes=True, and both in their
//                     masked cube mode.
//
// Both compute, per voxel and joint, the mean over V views of
// grid_sample(align_corners=True, padding_mode='zeros') on pixel
// coordinates, clamped to [0, 1].  A direct four-corner gather with a
// bounds test is exact for any coordinate, including behind-camera and
// near-camera bins, so there is no slow path.  Heatmaps are channels-last
// (V, H, W, J) float32: the J values of one corner are contiguous, and
// threads are laid out (voxel, joint) so that the lanes of one voxel read
// neighbouring joints.  Each launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Constants of the in-kernel voxel -> pixel projection (the counterpart
// of the JAX package's FusedProj, ops/pallas_sampling.py:455).
struct CropConsts {
  float origin[3];  // world position of fine-grid index 0, mm
  float step[3];    // fine-grid pitch, mm
  float t[6];       // 2x3 original-image -> network-input affine, row-major
  float clip_hi;    // max(original image w, h): post-projection clamp
  float hm_w, inv_img_w, hm_h, inv_img_h;  // input -> heatmap rescale
  float inv_wm1, inv_hm1;  // float32 1 / (heatmap w - 1), 1 / (h - 1)
  float wm1, hm1;          // heatmap w - 1, h - 1
};

int lane_shift_for(int J) {
  int s = 0;
  while ((1 << s) < J) ++s;
  return s;
}

// Bilinear sample of joint j at pixel (x, y) of one view; corners outside
// the image weigh zero (zeros padding).  Summed (x0,y0), (x1,y0), (x0,y1),
// (x1,y1), as the plain version sums.
__device__ __forceinline__ float bilinear(const float* __restrict__ hm, int H,
                                          int W, int J, int j, float x,
                                          float y) {
  const float x0 = floorf(x), y0 = floorf(y);
  const float x1 = x0 + 1.0f, y1 = y0 + 1.0f;
  const float wx1 = x - x0, wx0 = 1.0f - wx1;
  const float wy1 = y - y0, wy0 = 1.0f - wy1;
  const float wmax = (float)(W - 1), hmax = (float)(H - 1);
  const bool inx0 = x0 >= 0.0f && x0 <= wmax, inx1 = x1 >= 0.0f && x1 <= wmax;
  const bool iny0 = y0 >= 0.0f && y0 <= hmax, iny1 = y1 >= 0.0f && y1 <= hmax;
  const int ix0 = inx0 ? (int)x0 : 0, ix1 = inx1 ? (int)x1 : 0;
  const int iy0 = iny0 ? (int)y0 : 0, iy1 = iny1 ? (int)y1 : 0;
  const float v00 = (inx0 && iny0) ? __ldg(hm + ((size_t)iy0 * W + ix0) * J + j) : 0.0f;
  const float v01 = (inx1 && iny0) ? __ldg(hm + ((size_t)iy0 * W + ix1) * J + j) : 0.0f;
  const float v10 = (inx0 && iny1) ? __ldg(hm + ((size_t)iy1 * W + ix0) * J + j) : 0.0f;
  const float v11 = (inx1 && iny1) ? __ldg(hm + ((size_t)iy1 * W + ix1) * J + j) : 0.0f;
  const float w00 = (inx0 && iny0) ? wx0 * wy0 : 0.0f;
  const float w01 = (inx1 && iny0) ? wx1 * wy0 : 0.0f;
  const float w10 = (inx0 && iny1) ? wx0 * wy1 : 0.0f;
  const float w11 = (inx1 && iny1) ? wx1 * wy1 : 0.0f;
  return v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11;
}

__device__ __forceinline__ float clamp01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

// Round-to-nearest arithmetic that nvcc never contracts into an FMA: the
// projection below rounds after every step, as the plain version's
// separate tensor ops do.  Near a camera the perspective divide magnifies
// one ulp of a contracted multiply-add past the 1e-5 sample tolerance.
#define MUL __fmul_rn
#define ADD __fadd_rn
#define SUB __fsub_rn
#define DIV __fdiv_rn

// World point -> heatmap pixel for one packed camera c[21], op for op as
// project_points + project_to_norm_coords + norm_to_pixel
// (geometry/cameras.py, geometry/grids.py).
__device__ __forceinline__ void project_pixel(const float* c, float wx,
                                              float wy, float wz,
                                              const CropConsts& k, float& px,
                                              float& py) {
  const float xt0 = SUB(wx, c[9]), xt1 = SUB(wy, c[10]), xt2 = SUB(wz, c[11]);
  const float xc0 = ADD(ADD(MUL(xt0, c[0]), MUL(xt1, c[1])), MUL(xt2, c[2]));
  const float xc1 = ADD(ADD(MUL(xt0, c[3]), MUL(xt1, c[4])), MUL(xt2, c[5]));
  const float xc2 = ADD(ADD(MUL(xt0, c[6]), MUL(xt1, c[7])), MUL(xt2, c[8]));
  const float den = ADD(xc2, 1e-5f);
  const float y0 = DIV(xc0, den), y1 = DIV(xc1, den);
  const float r2 = ADD(MUL(y0, y0), MUL(y1, y1));
  const float d = ADD(ADD(ADD(1.0f, MUL(c[16], r2)), MUL(MUL(c[17], r2), r2)),
                      MUL(MUL(MUL(c[18], r2), r2), r2));
  const float u = ADD(ADD(MUL(y0, d), MUL(MUL(MUL(2.0f, c[19]), y0), y1)),
                      MUL(c[20], ADD(r2, MUL(MUL(2.0f, y0), y0))));
  const float v = ADD(ADD(MUL(y1, d), MUL(MUL(MUL(2.0f, c[20]), y0), y1)),
                      MUL(c[19], ADD(r2, MUL(MUL(2.0f, y1), y1))));
  const float ox = fminf(fmaxf(ADD(MUL(u, c[12]), c[14]), -1.0f), k.clip_hi);
  const float oy = fminf(fmaxf(ADD(MUL(v, c[13]), c[15]), -1.0f), k.clip_hi);
  float qx = ADD(ADD(MUL(ox, k.t[0]), MUL(oy, k.t[1])), k.t[2]);
  float qy = ADD(ADD(MUL(ox, k.t[3]), MUL(oy, k.t[4])), k.t[5]);
  qx = MUL(MUL(qx, k.hm_w), k.inv_img_w);
  qy = MUL(MUL(qy, k.hm_h), k.inv_img_h);
  const float nx = fminf(fmaxf(SUB(MUL(MUL(qx, k.inv_wm1), 2.0f), 1.0f), -1.1f), 1.1f);
  const float ny = fminf(fmaxf(SUB(MUL(MUL(qy, k.inv_hm1), 2.0f), 1.0f), -1.1f), 1.1f);
  px = MUL(MUL(ADD(nx, 1.0f), 0.5f), k.wm1);
  py = MUL(MUL(ADD(ny, 1.0f), 0.5f), k.hm1);
}

// One thread per (voxel, joint lane); lanes per voxel = 1 << lane_shift.
__global__ void __launch_bounds__(kThreads)
sample_whole_kernel(const float* __restrict__ hm, const float* __restrict__ pix,
                    float* __restrict__ out, int V, int H, int W, int J, int N,
                    int lane_shift) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = (int)(t & ((1 << lane_shift) - 1));
  const long long n = t >> lane_shift;
  if (n >= N || lane >= J) return;
  const size_t view = (size_t)H * W * J;
  const float2* p2 = reinterpret_cast<const float2*>(pix);
  float acc = 0.0f;
  for (int v = 0; v < V; ++v) {
    const float2 p = p2[(size_t)v * N + n];
    acc += bilinear(hm + v * view, H, W, J, lane, p.x, p.y);
  }
  out[(size_t)n * J + lane] = clamp01(acc / (float)V);
}

// One block per (x slab, slot), lanes over joints; the block walks the
// slab's (y, z) voxels.  Two template switches share this body:
//
//   kCoords  false: each voxel's pixel in each view is projected here from
//                   the rig and the crop origin (project_pixel);
//            true:  it is read from precomputed coords pix (K, V, N, 2),
//                   N = vx * vy * vz voxels in (x, y, z) order.  Dead
//                   slots, masked slabs and masked voxels read no coords.
//   kCube    false: xy (max over z) and xz (max over y) reduce in shared
//                   memory, yz (max over x) across blocks with atomicMax
//                   into the zero-initialised output.  Every value is >= 0
//                   after the clamp and the mask, so the int order of the
//                   float bits is the float order; +0.0f turns a -0.0 into
//                   +0.0 before the compare.  Dead slots, masked slabs and
//                   masked voxels write nothing: their planes stay 0,
//                   which is what the max of masked (zero) values gives.
//            true:  the bbox-masked cube (K, vx, vy, vz, J) is written
//                   whole, zeros for dead slots, masked slabs and masked
//                   voxels, so the output needs no zero fill.
template <bool kCoords, bool kCube>
__global__ void __launch_bounds__(kThreads)
crop_kernel(const float* __restrict__ hm, const float* __restrict__ cams,
            const int* __restrict__ tl, const float* __restrict__ pix,
            const uint8_t* __restrict__ mx, const uint8_t* __restrict__ my,
            const uint8_t* __restrict__ mz, const uint8_t* __restrict__ valid,
            CropConsts kc, float* __restrict__ out_xy,
            float* __restrict__ out_xz, float* __restrict__ out_yz,
            float* __restrict__ out_cube, int V, int H, int W, int J, int vx,
            int vy, int vz, int lane_shift) {
  const int x = blockIdx.x, k = blockIdx.y;
  const size_t slab = (size_t)vy * vz;  // voxels of one x slab
  float* cube = kCube ? out_cube + ((size_t)k * vx + x) * slab * J : nullptr;
  if (!valid[k] || !mx[(size_t)k * vx + x]) {
    if (kCube)
      for (size_t i = threadIdx.x; i < slab * J; i += blockDim.x) cube[i] = 0.0f;
    return;
  }

  extern __shared__ float smem[];
  float* s_cams = smem;                               // V * 21 (projection)
  int* s_xy = reinterpret_cast<int*>(smem + V * 21);  // vy * J (planes)
  int* s_xz = s_xy + vy * J;                          // vz * J (planes)
  if (!kCoords)
    for (int i = threadIdx.x; i < V * 21; i += blockDim.x) s_cams[i] = cams[i];
  if (!kCube)
    for (int i = threadIdx.x; i < (vy + vz) * J; i += blockDim.x) s_xy[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & ((1 << lane_shift) - 1);
  const int per_iter = blockDim.x >> lane_shift;
  const uint8_t* myk = my + (size_t)k * vy;
  const uint8_t* mzk = mz + (size_t)k * vz;
  const size_t view = (size_t)H * W * J;
  const size_t n_vox = (size_t)vx * slab;
  const float2* pk = kCoords ? reinterpret_cast<const float2*>(pix) +
                                   (size_t)k * V * n_vox + (size_t)x * slab
                             : nullptr;
  const float wx = kCoords ? 0.0f : ADD(kc.origin[0], MUL((float)(tl[3 * k] + x), kc.step[0]));
  const int tly = kCoords ? 0 : tl[3 * k + 1], tlz = kCoords ? 0 : tl[3 * k + 2];

  for (int i = threadIdx.x >> lane_shift; i < (int)slab; i += per_iter) {
    const int y = i / vz, z = i - y * vz;
    if (lane >= J) continue;
    if (!myk[y] || !mzk[z]) {
      if (kCube) cube[(size_t)i * J + lane] = 0.0f;
      continue;
    }
    float wy = 0.0f, wz = 0.0f;
    if (!kCoords) {
      wy = ADD(kc.origin[1], MUL((float)(tly + y), kc.step[1]));
      wz = ADD(kc.origin[2], MUL((float)(tlz + z), kc.step[2]));
    }
    float acc = 0.0f;
    for (int v = 0; v < V; ++v) {
      float px, py;
      if (kCoords) {
        const float2 p = pk[(size_t)v * n_vox + i];
        px = p.x;
        py = p.y;
      } else {
        project_pixel(s_cams + 21 * v, wx, wy, wz, kc, px, py);
      }
      acc += bilinear(hm + v * view, H, W, J, lane, px, py);
    }
    const float r = clamp01(acc / (float)V) + 0.0f;
    if (kCube) {
      cube[(size_t)i * J + lane] = r;
    } else if (r > 0.0f) {
      const int bits = __float_as_int(r);
      atomicMax(&s_xy[y * J + lane], bits);
      atomicMax(&s_xz[z * J + lane], bits);
      atomicMax(reinterpret_cast<int*>(out_yz) +
                    (((size_t)k * vy + y) * vz + z) * J + lane,
                bits);
    }
  }
  if (kCube) return;
  __syncthreads();

  float* oxy = out_xy + ((size_t)k * vx + x) * vy * J;
  float* oxz = out_xz + ((size_t)k * vx + x) * vz * J;
  for (int i = threadIdx.x; i < vy * J; i += blockDim.x) oxy[i] = __int_as_float(s_xy[i]);
  for (int i = threadIdx.x; i < vz * J; i += blockDim.x) oxz[i] = __int_as_float(s_xz[i]);
}

}  // namespace

extern "C" {

// heatmaps (V, H, W, J), pix (V, N, 2) -> out (N, J).
int fvp_sample_whole(const float* hm, const float* pix, float* out, int V,
                     int H, int W, int J, int N, void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  const int shift = lane_shift_for(J);
  const long long threads = (long long)N << shift;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  sample_whole_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      hm, pix, out, V, H, W, J, N, shift);
  return (int)cudaGetLastError();
}

// The crop sampler in its four modes.  heatmaps (V, H, W, J); mx (K, vx),
// my (K, vy), mz (K, vz), valid (K,) uint8.  from_coords = 0: cams (V, 21),
// tl (K, 3) int32 and consts (21 host floats in CropConsts order) give the
// pixels; from_coords = 1: pix (K, V, vx*vy*vz, 2) gives them.  cube = 0:
// outputs (K, vx, vy, J), (K, vx, vz, J), (K, vy, vz, J), zero-filled;
// cube = 1: output (K, vx, vy, vz, J), any contents.  Unused pointers may
// be null.
int fvp_sample_crop(const float* hm, const float* cams, const int* tl,
                    const float* pix, const uint8_t* mx, const uint8_t* my,
                    const uint8_t* mz, const uint8_t* valid,
                    const float* consts, float* out_xy, float* out_xz,
                    float* out_yz, float* out_cube, int V, int H, int W, int J,
                    int K, int vx, int vy, int vz, int from_coords, int cube,
                    void* stream) {
  if (K <= 0) return (int)cudaGetLastError();
  CropConsts kc;
  float* dst = reinterpret_cast<float*>(&kc);
  for (int i = 0; i < (int)(sizeof(CropConsts) / sizeof(float)); ++i)
    dst[i] = from_coords ? 0.0f : consts[i];
  const int shift = lane_shift_for(J);
  const size_t smem =
      sizeof(float) * ((size_t)V * 21 + (cube ? 0 : (size_t)(vy + vz) * J));
  const dim3 grid((unsigned)vx, (unsigned)K);
  const cudaStream_t st = (cudaStream_t)stream;
#define FVP_CROP(C, Q)                                                     \
  crop_kernel<C, Q><<<grid, kThreads, smem, st>>>(                         \
      hm, cams, tl, pix, mx, my, mz, valid, kc, out_xy, out_xz, out_yz,    \
      out_cube, V, H, W, J, vx, vy, vz, shift)
  if (from_coords) {
    if (cube) FVP_CROP(true, true); else FVP_CROP(true, false);
  } else {
    if (cube) FVP_CROP(false, true); else FVP_CROP(false, false);
  }
#undef FVP_CROP
  return (int)cudaGetLastError();
}

}  // extern "C"
