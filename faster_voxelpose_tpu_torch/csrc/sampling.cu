// Multi-view bilinear heatmap sampling for Hopper (sm_90a).
//
// Three kernels with a plain C interface, loaded with ctypes by
// faster_voxelpose_tpu_torch/ops/sampling_kernels.py, which also holds
// their plain PyTorch versions, their launch counters and the notes on
// what bounds them.
//
//   fvp_sample_whole_projected
//                     the whole-space sampler of a batch from heatmaps and
//                     cameras: the grid is projected in the kernel.  It
//                     replaces project_whole_batch_pallas
//                     (models/projection.py:384 of the JAX package), which
//                     vmaps sample_tiles in cube mode
//                     (ops/pallas_sampling.py:947) over the batch; its
//                     design is described above whole_kernel
//   fvp_sample_whole  the same sampler of one sample on precomputed pixel
//                     coords: sample_tiles in cube mode as the TPU kernel
//                     computes it, called by project_whole_pallas
//                     (models/projection.py:340)
//   fvp_sample_crop   the crop sampler of project_individual_planes_pallas
//                     (models/projection.py:459-571) in its four modes:
//                     pixels projected in the kernel or read from coords,
//                     times three max planes or the masked cube.  It
//                     replaces sample_tiles_fused (:1010) and sample_tiles
//                     (:947) with emit_planes=True, and both in their
//                     masked cube mode.
//
// The whole-space sampler and the crop sampler's projected cube mode also
// have a bounded mode (template switch kBounded), VoxelPose's ProjectLayer:
// the sum over the views in whose original image the voxel's projected
// point lies, over their count plus 1e-6, clamped to [0, 1]; in it the crop
// sampler takes each slot's crop about a float world centre (the PRN's
// cubes) in place of an integer origin on the fine grid.  The instantiations
// of Faster VoxelPose's modes are unchanged.
//
// All compute, per voxel and joint, the mean over V views of
// grid_sample(align_corners=True, padding_mode='zeros') on pixel
// coordinates, clamped to [0, 1].  A direct four-corner gather with a
// bounds test is exact for any coordinate, including behind-camera and
// near-camera bins, so there is no slow path.  Heatmaps are channels-last
// (V, H, W, J) float32: the J values of one corner are contiguous, and
// threads are laid out (voxel, joint) so that the lanes of one voxel read
// neighbouring joints.  The projecting kernels work out each (voxel,
// view)'s pixel and corner taps once, in one thread, and hand them to the
// voxel's joint lanes through shared memory; the crop sampler's tiles and
// plane reductions are described above crop_kernel.  Each launch returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "projection.cuh"

namespace {

// The block shapes below may be set by -D at build time (the block-shape
// sweeps, tools/sweep_planes.py and tools/sweep_whole.py, build each
// variant into a library of its own); the production build passes no
// define and takes these values.
#ifndef FVP_THREADS
#define FVP_THREADS 256
#endif
#ifndef FVP_CROP_TX
#define FVP_CROP_TX 4
#endif
#ifndef FVP_CROP_TY
#define FVP_CROP_TY 4
#endif
#ifndef FVP_CROP_TZ
#define FVP_CROP_TZ 32
#endif
#ifndef FVP_WHOLE_VOXELS
#define FVP_WHOLE_VOXELS 256
#endif

constexpr int kThreads = FVP_THREADS;
constexpr int kWarps = kThreads / 32;
static_assert(kThreads % 32 == 0 && kThreads >= 32 && kThreads <= 1024,
              "FVP_THREADS: a multiple of 32 up to 1024");
// The crop sampler's block tile: kTX x kTY columns (x, y) of kTZ voxels
// along z, one column chunk per warp at a time (kTZ = 32: one voxel per
// lane when the taps are made).  Small tiles give many short blocks, which
// balance across the SMs when the bbox masks cut tiles at their edges, and
// keep shared memory small, which leaves L1 to the heatmap gathers; the
// price is more global atomics per live voxel on the xz and yz planes.
constexpr int kTX = FVP_CROP_TX, kTY = FVP_CROP_TY, kTZ = FVP_CROP_TZ;
static_assert(kTX > 0 && kTY > 0 && kTZ > 0 && kTZ <= 32,
              "FVP_CROP_TZ: a column chunk is at most one voxel per lane");
constexpr int kTS = kTX + kTY + kTZ;  // projection products per (view, row)
// Views whose corner loads a joint lane issues before it sums any: all of
// them for rigs of up to 8 cameras.  The gathers hit L2, so the time of a
// voxel is a few L2 round trips, not one per view.
constexpr int kViews = 8;
// fvp_sample_crop's and fvp_sample_whole_projected's return when the
// shapes need more dynamic shared memory than a block of the device may
// have (no CUDA error is -1)
constexpr int kErrSharedMemory = -1;

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
  float ori_w, ori_h;      // original image w, h: the bounded mode's bounds
};

// Bit 4 of a tap's corner mask (make_tap): in the bounded mode, the voxel's
// point lies inside that view's original image.  A tap outside it keeps no
// corner, so it adds 0 to the sum, and the bits count the views averaged.
constexpr int kInBounds = 16;

int lane_shift_for(int J) {
  int s = 0;
  while ((1 << s) < J) ++s;
  return s;
}

// The bilinear taps of pixel (x, y) in an H x W image: the flat pixel
// index of corner (x0, y0), which corners lie inside the image (bits 0-3:
// (x0,y0), (x1,y0), (x0,y1), (x1,y1)) and the weights of x1 and y1 as
// float bits.  The index matters only where a corner is inside, so the
// corner is clamped before the conversion and no coordinate overflows.
__device__ __forceinline__ int4 make_tap(float x, float y, int H, int W) {
  const float x0 = floorf(x), y0 = floorf(y);
  const float x1 = x0 + 1.0f, y1 = y0 + 1.0f;
  const float wmax = (float)(W - 1), hmax = (float)(H - 1);
  const bool inx0 = x0 >= 0.0f && x0 <= wmax, inx1 = x1 >= 0.0f && x1 <= wmax;
  const bool iny0 = y0 >= 0.0f && y0 <= hmax, iny1 = y1 >= 0.0f && y1 <= hmax;
  const int ix0 = (int)fminf(fmaxf(x0, -1.0f), wmax);
  const int iy0 = (int)fminf(fmaxf(y0, -1.0f), hmax);
  const int in = (int)(inx0 && iny0) | (int)(inx1 && iny0) << 1 |
                 (int)(inx0 && iny1) << 2 | (int)(inx1 && iny1) << 3;
  return make_int4(iy0 * W + ix0, in, __float_as_int(x - x0), __float_as_int(y - y0));
}

// Joint j of one view at a tap, in two steps so that a caller can have
// the loads of several views in flight before it sums any: the four
// corners' values (zero outside the image: zeros padding), then their sum
// (x0,y0), (x1,y0), (x0,y1), (x1,y1) with the bilinear weights, as the
// plain version sums.
__device__ __forceinline__ float4 tap_load(const float* __restrict__ hm, int W,
                                           int J, int j, int4 tap) {
  const ptrdiff_t i00 = (ptrdiff_t)tap.x * J + j, row = (ptrdiff_t)W * J;
  return make_float4((tap.y & 1) ? __ldg(hm + i00) : 0.0f,
                     (tap.y & 2) ? __ldg(hm + i00 + J) : 0.0f,
                     (tap.y & 4) ? __ldg(hm + i00 + row) : 0.0f,
                     (tap.y & 8) ? __ldg(hm + i00 + row + J) : 0.0f);
}

__device__ __forceinline__ float tap_sum(int4 tap, float4 c) {
  const float wx1 = __int_as_float(tap.z), wx0 = 1.0f - wx1;
  const float wy1 = __int_as_float(tap.w), wy0 = 1.0f - wy1;
  const float w00 = (tap.y & 1) ? wx0 * wy0 : 0.0f;
  const float w01 = (tap.y & 2) ? wx1 * wy0 : 0.0f;
  const float w10 = (tap.y & 4) ? wx0 * wy1 : 0.0f;
  const float w11 = (tap.y & 8) ? wx1 * wy1 : 0.0f;
  return c.x * w00 + c.y * w01 + c.z * w10 + c.w * w11;
}

__device__ __forceinline__ float clamp01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

// Camera-frame point (xc0, xc1, xc2) of one packed camera c[21] -> heatmap
// pixel, op for op as the rest of project_points + project_to_norm_coords
// + norm_to_pixel (geometry/cameras.py, geometry/grids.py): the network-
// input pixel of camera_to_input (projection.cuh, where the arithmetic
// rounds after every operation), then the heatmap frame.  Where inb is
// given, whether the projected point, before its clamp, lies inside the
// original image ([0, ori_w) x [0, ori_h): VoxelPose's `bounding`).
__device__ __forceinline__ void camera_to_pixel(const float* c, float xc0,
                                                float xc1, float xc2,
                                                const CropConsts& k, float& px,
                                                float& py, bool* inb = nullptr) {
  float qx, qy;
  camera_to_input(c, xc0, xc1, xc2, k.t, k.clip_hi, k.ori_w, k.ori_h, qx, qy, inb);
  qx = MUL(MUL(qx, k.hm_w), k.inv_img_w);
  qy = MUL(MUL(qy, k.hm_h), k.inv_img_h);
  const float nx = fminf(fmaxf(SUB(MUL(MUL(qx, k.inv_wm1), 2.0f), 1.0f), -1.1f), 1.1f);
  const float ny = fminf(fmaxf(SUB(MUL(MUL(qy, k.inv_hm1), 2.0f), 1.0f), -1.1f), 1.1f);
  px = MUL(MUL(ADD(nx, 1.0f), 0.5f), k.wm1);
  py = MUL(MUL(ADD(ny, 1.0f), 0.5f), k.hm1);
}

// Heatmap pixel of one voxel in one view from that view's axis products:
// row r of axis a's index i at pr[r * stride + off_a + i], ix, iy, iz the
// voxel's offsets into them.  The camera-frame coordinates are their sums
// in project_points' order, so the pixel is bit for bit the unfactored one.
__device__ __forceinline__ void voxel_pixel(const float* pr, int stride, int ix, int iy,
                                            int iz, const float* c, const CropConsts& k,
                                            float& px, float& py, bool* inb = nullptr) {
  const float xc0 = ADD(ADD(pr[ix], pr[iy]), pr[iz]);
  pr += stride;
  const float xc1 = ADD(ADD(pr[ix], pr[iy]), pr[iz]);
  pr += stride;
  const float xc2 = ADD(ADD(pr[ix], pr[iy]), pr[iz]);
  camera_to_pixel(c, xc0, xc1, xc2, k, px, py, inb);
}

// The taps of pixel (px, py); in the bounded mode none outside the original
// image (inb false), and kInBounds set inside it.
template <bool kBounded>
__device__ __forceinline__ int4 bounded_tap(float px, float py, bool inb, int H, int W) {
  int4 tap = make_tap(px, py, H, W);
  if (kBounded) tap.y = inb ? tap.y | kInBounds : 0;
  return tap;
}

// The bounded mode's divisor: the views a voxel's taps lie inside, plus
// 1e-6, as VoxelPose divides (sum(bounding) + 1e-6).
__device__ __forceinline__ float bounded_count(int count) {
  return (float)count + 1e-6f;
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
    const int4 tap = make_tap(p.x, p.y, H, W);
    acc += tap_sum(tap, tap_load(hm + v * view, W, J, lane, tap));
  }
  out[(size_t)n * J + lane] = clamp01(acc / (float)V);
}

// The whole-space sampler of a batch, from heatmaps and cameras.
//
// The function is sample_whole_kernel's on the pixels that whole_pixels
// (models/projection.py) computes: grid point (x, y, z) is (gx[x], gy[y],
// gz[z]), the linspaces of compute_grid_np as the float32 grid holds
// them, so each camera-frame coordinate is (p_r0[x] + p_r1[y]) + p_r2[z]
// (axis_product, voxel_pixel).  A block computes its sample's products
// once, V * 3 * (X + Y + Z) floats in shared memory; then each thread
// projects one voxel into every view (divide, distortion, affine, as the
// crop sampler does) and leaves its taps in shared memory.  The (V, N, 2)
// coords tensor that fvp_sample_whole reads is never written, and the
// tensor ops that would build it, about 87 launches per sample, are not
// issued.  One launch covers the batch: grid (tiles, B), heatmaps and
// cameras strided per sample.  Bound on an H100: bytes, the heatmaps in
// and the cube out (16.9 MB at the Panoptic profile and B = 1).
//
// Lanes.  A block holds kWholeVoxels = 256 voxels, one per thread while
// projecting: 256 voxels consecutive in the cube's flat (x, y, z) order,
// so a block's output is one contiguous run of 256 J floats and the store
// is coalesced.  Its 256 J (voxel, joint) pairs are then spread over the
// 256 threads flat, pair e = i * 256 + t for i < J, so each thread has
// exactly J pairs whatever J is: every lane works at J = 15 and at J = 17
// (the coords mode gives a voxel 16 or 32 lanes, 17 of 32 busy at J = 17),
// but in a grid's last, ragged tile.  A warp's 32 pairs are two or three
// voxels' joints, so a corner load reads two or three runs of J floats.
// A thread keeps its J sums in registers across the views, views
// outermost, so one view's 4 J corner loads are in flight together and
// each sum adds the views in order, as fvp_sample_whole does.
//
// Taps.  The corners are gathered from L2, which holds a sample's
// heatmaps (9.2 MB at the Panoptic profile) after their first read.  A
// second design was measured against this one and dropped: tiles of 8 x
// 8 x 4 voxels, each view's footprint copied into shared memory by
// cp.async.bulk (two 32 KB slots, the next view's copy in flight), the
// corners read from there.  The gather won at every shape measured: on an
// H100 80GB HBM3 at 700 W, device time 0.0466 ms against 0.0747 at the
// Panoptic profile and B = 1 (the staged design 1.6x slower), 0.3312
// against 0.6207 at the Shelf shapes and B = 8 (1.9x), 0.2152 against
// 0.3740 at the Campus shapes and B = 8 (1.7x).  The whole grid's voxels
// lie a few heatmap pixels apart, so a footprint holds about as many
// pixels per voxel as the four corners a voxel gathers, and staging adds
// the copies' latency and halves the blocks per SM (97 KB of shared
// memory a block against 32 KB).
//
// Bounded mode (kBounded): a tap outside the view's original image keeps
// no corner and carries kInBounds inside it; each (voxel, joint) sum is
// divided by the count of its voxel's in-bound taps plus 1e-6, read back
// from shared memory after the sums.
constexpr int kWholeVoxels = FVP_WHOLE_VOXELS;  // voxels and threads per block of the whole-space sampler
constexpr int kMaxJoints = 32;
static_assert(kWholeVoxels % 32 == 0 && kWholeVoxels >= kMaxJoints && kWholeVoxels <= 1024,
              "FVP_WHOLE_VOXELS: a multiple of 32 from 32 to 1024");
// 1024 threads per SM (at most 64 registers a thread): at 256 voxels, four
// blocks, and a Panoptic sample's 500 blocks run in one wave on 132 SMs.
constexpr int kWholeBlocksPerSM = 1024 / kWholeVoxels;

template <bool kBounded>
__global__ void __launch_bounds__(kWholeVoxels, kWholeBlocksPerSM)
whole_kernel(const float* __restrict__ hm, const float* __restrict__ cams,
             const float* __restrict__ gx, const float* __restrict__ gy,
             const float* __restrict__ gz, CropConsts kc, float* __restrict__ out, int V,
             int H, int W, int J, int X, int Y, int Z) {
  const int b = blockIdx.y, t = threadIdx.x, tile = blockIdx.x, S = X + Y + Z;
  const long long N = (long long)X * Y * Z;
  extern __shared__ __align__(16) int4 smem_w[];
  int4* s_tap = smem_w;                                              // V * 256
  float* s_cam = reinterpret_cast<float*>(s_tap + V * kWholeVoxels);  // V * 21
  float* s_prod = s_cam + V * 21;                                     // V * 3 * S

  const size_t view = (size_t)H * W * J;
  const float* hb = hm + (size_t)b * V * view;
  const float* cb = cams + (size_t)b * V * 21;
  for (int i = t; i < V * 21; i += kWholeVoxels) s_cam[i] = cb[i];
  for (int s = t; s < S; s += kWholeVoxels) {  // axis index s of x, then y, then z
    const int a = s < X ? 0 : s < X + Y ? 1 : 2;
    const float g = a == 0 ? gx[s] : a == 1 ? gy[s - X] : gz[s - X - Y];
    for (int v = 0; v < V; ++v)
      for (int r = 0; r < 3; ++r) s_prod[(v * 3 + r) * S + s] = axis_product(cb + 21 * v, r, a, g);
  }
  __syncthreads();

  // this thread's voxel: its taps in every view
  const long long n = (long long)tile * kWholeVoxels + t;
  const int z = (int)(n % Z), y = (int)(n / Z % Y), x = (int)(n / Z / Y);
  for (int v = 0; v < V; ++v) {
    int4 tap = make_int4(0, 0, 0, 0);  // no corner inside: adds 0
    if (n < N) {
      float px, py;
      bool inb = true;
      voxel_pixel(s_prod + v * 3 * S, S, x, X + y, X + Y + z, s_cam + 21 * v, kc, px, py,
                  kBounded ? &inb : nullptr);
      tap = bounded_tap<kBounded>(px, py, inb, H, W);
    }
    s_tap[v * kWholeVoxels + t] = tap;
  }
  __syncthreads();

  // (voxel, joint) pairs t, t + 256, ...: pair e is voxel e / J, joint e % J
  float acc[kMaxJoints];
#pragma unroll
  for (int i = 0; i < kMaxJoints; ++i) acc[i] = 0.0f;
  const int l0 = t / J, j0 = t - l0 * J, dl = kWholeVoxels / J, dj = kWholeVoxels - dl * J;
  for (int v = 0; v < V; ++v) {
    const float* hv = hb + v * view;
    const int4* tv = s_tap + v * kWholeVoxels;
    int l = l0, j = j0;
#pragma unroll
    for (int i = 0; i < kMaxJoints; ++i) {
      if (i < J) {
        const int4 tap = tv[l];
        acc[i] += tap_sum(tap, tap_load(hv, W, J, j, tap));
        l += dl;
        j += dj;
        if (j >= J) {
          j -= J;
          ++l;
        }
      }
    }
  }

  // the view means, clamped: the block writes one contiguous run
  float* ob = out + (size_t)b * N * J + (size_t)tile * kWholeVoxels * J;
  const long long live = (N - (long long)tile * kWholeVoxels) * J;  // pairs in the grid
  if (kBounded) {
    int l = l0, j = j0;
#pragma unroll
    for (int i = 0; i < kMaxJoints; ++i) {
      if (i < J) {
        if ((long long)i * kWholeVoxels + t < live) {
          int count = 0;
          for (int v = 0; v < V; ++v) count += (s_tap[v * kWholeVoxels + l].y & kInBounds) != 0;
          ob[i * kWholeVoxels + t] = clamp01(acc[i] / bounded_count(count));
        }
        l += dl;
        j += dj;
        if (j >= J) {
          j -= J;
          ++l;
        }
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kMaxJoints; ++i)
    if (i < J && (long long)i * kWholeVoxels + t < live)
      ob[i * kWholeVoxels + t] = clamp01(acc[i] / (float)V);
}

// The crop sampler.  One block per (tile, slot): a tile is kTX x kTY
// columns (x, y) by kTZ voxels along z, blockIdx.x = (tile x * nty +
// tile y) * nzc + z chunk.  A dead slot, or a tile whose x, y or z masks
// keep nothing, returns at once (in cube mode after writing its zeros).
// Each warp walks the tile's columns; in a column it compacts the voxels
// that the masks keep (a ballot), each of their lanes makes the voxel's
// taps in every view into shared memory, and then the joint lanes (1 <<
// lane_shift per voxel, 32 >> lane_shift voxels at a time) sample,
// average and clamp.  Masked columns and voxels cost no iteration, and
// any uint8 masks work, intervals or not.  Two template switches:
//
//   kCoords  false: the pixel is projected here.  xc_r = (p_r0[x] +
//                   p_r1[y]) + p_r2[z] with p_ra[i] = (origin_a + (tl_a +
//                   i) * step_a - cam_a) * R[r][a]: each product depends on
//                   one axis index only, so the block computes them once
//                   (s_prod, axis_product) and each voxel adds them in
//                   project_points' order (voxel_pixel), bit for bit the
//                   unfactored pixel; the divide, distortion and affine run
//                   once per (voxel, view).
//            true:  it is read from pix (K, V, N, 2), N = vx * vy * vz
//                   voxels in (x, y, z) order; masked voxels read nothing.
//   kCube    false: xy (max over z) is taken in registers over a column
//                   chunk and leaves with one atomicMax per (column,
//                   chunk, joint); xz (max over y) and yz (max over x)
//                   reduce over the tile in shared memory and leave with
//                   one atomicMax per (tile, cell, joint) holding a value
//                   > 0, into the zero-filled output.  Every value is >= 0
//                   after the clamp and the mask, so the int order of the
//                   float bits is the float order; +0.0f turns a -0.0 into
//                   +0.0.  Max is order-free: the planes are deterministic.
//            true:  the bbox-masked cube (K, vx, vy, vz, J) is written
//                   whole, zeros for dead slots and masked tiles, columns
//                   and voxels, so the output needs no zero fill.
//   kBounded true:  (projected cube mode only) VoxelPose's crops: tl holds
//                   each slot's float world centre (K, 3) mm, and index i
//                   of axis a lies at (origin_a + i * step_a) + centre_a, a
//                   linspace about the centre; each sum is over the views
//                   whose original image holds the voxel's point, divided
//                   by their count plus 1e-6 (the bounded mode).
template <bool kCoords, bool kCube, bool kBounded = false>
__global__ void __launch_bounds__(kThreads)
crop_kernel(const float* __restrict__ hm, const float* __restrict__ cams,
            const int* __restrict__ tl, const float* __restrict__ pix,
            const uint8_t* __restrict__ mx, const uint8_t* __restrict__ my,
            const uint8_t* __restrict__ mz, const uint8_t* __restrict__ valid,
            CropConsts kc, float* __restrict__ out_xy,
            float* __restrict__ out_xz, float* __restrict__ out_yz,
            float* __restrict__ out_cube, int V, int H, int W, int J, int vx,
            int vy, int vz, int nty, int nzc, int lane_shift) {
  const int k = blockIdx.y, t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int tile = blockIdx.x / nzc;
  const int x0 = tile / nty * kTX, y0 = tile % nty * kTY, z0 = blockIdx.x % nzc * kTZ;
  const int nx = min(kTX, vx - x0), ny = min(kTY, vy - y0), nz = min(kTZ, vz - z0);
  const uint8_t* mxk = mx + (size_t)k * vx;
  const uint8_t* myk = my + (size_t)k * vy;
  const uint8_t* mzk = mz + (size_t)k * vz;
  // the cube chunk (nz, J) of tile column c, contiguous
  auto column = [&](int c) {
    return out_cube + ((((size_t)k * vx + x0 + c / kTY) * vy + y0 + c % kTY) * vz + z0) * J;
  };

  // valid[k] is the same for the whole block, and so is each vote
  const bool live = valid[k] && __syncthreads_or(t < nx && mxk[x0 + t]) &&
                    __syncthreads_or(t < ny && myk[y0 + t]) &&
                    __syncthreads_or(t < nz && mzk[z0 + t]);
  if (!live) {
    if (kCube)
      for (int c = warp; c < kTX * kTY; c += kWarps) {
        if (c / kTY >= nx || c % kTY >= ny) continue;
        float* col = column(c);
        for (int e = lane; e < nz * J; e += 32) col[e] = 0.0f;
      }
    return;
  }

  extern __shared__ int4 smem[];
  int4* s_tap = smem;                                          // kWarps * V * 32
  int* s_z = reinterpret_cast<int*>(s_tap + kWarps * V * 32);  // kWarps * 32
  float* s_cam = reinterpret_cast<float*>(s_z + kWarps * 32);  // V * 21 (projection)
  float* s_prod = s_cam + (kCoords ? 0 : V * 21);              // V * 3 * kTS (projection)
  int* s_xz = reinterpret_cast<int*>(s_prod + (kCoords ? 0 : V * 3 * kTS));  // kTX * kTZ * J
  int* s_yz = s_xz + kTX * kTZ * J;                                          // kTY * kTZ * J
  if (!kCoords) {
    for (int i = t; i < V * 21; i += kThreads) s_cam[i] = cams[i];
    for (int i = t; i < V * 3 * kTS; i += kThreads) {
      const int v = i / (3 * kTS), r = i / kTS % 3, s = i % kTS;
      const int a = s < kTX ? 0 : s < kTX + kTY ? 1 : 2;
      const int loc = a == 0 ? x0 + s : a == 1 ? y0 + s - kTX : z0 + s - kTX - kTY;
      float w;
      if (kBounded)
        w = ADD(ADD(kc.origin[a], MUL((float)loc, kc.step[a])),
                reinterpret_cast<const float*>(tl)[3 * k + a]);
      else
        w = ADD(kc.origin[a], MUL((float)(tl[3 * k + a] + loc), kc.step[a]));
      s_prod[i] = axis_product(cams + 21 * v, r, a, w);
    }
  }
  if (!kCube)
    for (int i = t; i < (kTX + kTY) * kTZ * J; i += kThreads) s_xz[i] = 0;
  __syncthreads();

  const int lanes = 1 << lane_shift, per_step = 32 >> lane_shift;
  const int j = lane & (lanes - 1), g = lane >> lane_shift;
  int4* tap = s_tap + warp * V * 32;
  int* zof = s_z + warp * 32;
  const size_t view = (size_t)H * W * J, n_vox = (size_t)vx * vy * vz;
  const unsigned chunk = nz == 32 ? ~0u : (1u << nz) - 1u;

  for (int c = warp; c < kTX * kTY; c += kWarps) {
    const int xl = c / kTY, yl = c % kTY;
    if (xl >= nx || yl >= ny) continue;
    const int x = x0 + xl, y = y0 + yl;
    const bool in = lane < nz && mxk[x] && myk[y] && mzk[z0 + lane];
    const unsigned kept = __ballot_sync(~0u, in);
    float* col = kCube ? column(c) : nullptr;
    if (kCube) {  // zeros for the chunk's masked voxels
      if (!kept)
        for (int e = lane; e < nz * J; e += 32) col[e] = 0.0f;
      else
        for (unsigned dead = chunk & ~kept; dead; dead &= dead - 1u)
          if (lane < J) col[(__ffs(dead) - 1) * J + lane] = 0.0f;
    }
    if (!kept) continue;

    if (in) {  // this lane's voxel: its taps in every view
      const int q = __popc(kept & ((1u << lane) - 1u));
      zof[q] = lane;
      for (int v = 0; v < V; ++v) {
        float px, py;
        bool inb = true;
        if (kCoords) {
          const float2 p = reinterpret_cast<const float2*>(pix)
              [((size_t)k * V + v) * n_vox + ((size_t)x * vy + y) * vz + z0 + lane];
          px = p.x;
          py = p.y;
        } else {
          voxel_pixel(s_prod + v * 3 * kTS, kTS, xl, kTX + yl, kTX + kTY + lane, s_cam + 21 * v,
                      kc, px, py, kBounded ? &inb : nullptr);
        }
        tap[v * 32 + q] = bounded_tap<kBounded>(px, py, inb, H, W);
      }
    }
    __syncwarp();

    float m_xy = 0.0f;  // this lane's max over its voxels of the chunk
    if (j < J) {
      const int n = __popc(kept);
      for (int s = g; s < n; s += per_step) {
        float acc = 0.0f;
        int count = 0;  // the bounded mode's views
        for (int v0 = 0; v0 < V; v0 += kViews) {  // kViews views' loads in flight
          float4 c[kViews];
#pragma unroll
          for (int u = 0; u < kViews; ++u)
            if (v0 + u < V) c[u] = tap_load(hm + (v0 + u) * view, W, J, j, tap[(v0 + u) * 32 + s]);
#pragma unroll
          for (int u = 0; u < kViews; ++u)
            if (v0 + u < V) {
              const int4 tp = tap[(v0 + u) * 32 + s];
              acc += tap_sum(tp, c[u]);
              if (kBounded) count += (tp.y & kInBounds) != 0;
            }
        }
        const float r = clamp01(acc / (kBounded ? bounded_count(count) : (float)V)) + 0.0f;
        const int zl = zof[s];
        if (kCube) {
          col[zl * J + j] = r;
        } else if (r > 0.0f) {
          m_xy = fmaxf(m_xy, r);
          atomicMax(&s_xz[(xl * kTZ + zl) * J + j], __float_as_int(r));
          atomicMax(&s_yz[(yl * kTZ + zl) * J + j], __float_as_int(r));
        }
      }
    }
    if (!kCube) {
      for (int o = lanes; o < 32; o <<= 1) m_xy = fmaxf(m_xy, __shfl_xor_sync(~0u, m_xy, o));
      if (g == 0 && j < J && m_xy > 0.0f)
        atomicMax(reinterpret_cast<int*>(out_xy) + (((size_t)k * vx + x) * vy + y) * J + j,
                  __float_as_int(m_xy));
    }
    __syncwarp();  // the next column's taps overwrite this one's
  }
  if (kCube) return;
  __syncthreads();

  // xz rows (xl, zl), then yz rows (yl, zl): one atomicMax per cell and
  // joint that holds a value
  for (int row = warp; row < (kTX + kTY) * kTZ; row += kWarps) {
    const bool xz = row < kTX * kTZ;
    const int a = (xz ? row : row - kTX * kTZ) / kTZ, zl = row % kTZ;
    if (a >= (xz ? nx : ny) || zl >= nz || lane >= J) continue;
    const int bits = s_xz[row * J + lane];
    if (bits <= 0) continue;
    int* dst = xz ? reinterpret_cast<int*>(out_xz) + (((size_t)k * vx + x0 + a) * vz + z0 + zl) * J
                  : reinterpret_cast<int*>(out_yz) + (((size_t)k * vy + y0 + a) * vz + z0 + zl) * J;
    atomicMax(dst + lane, bits);
  }
}

// Launch geometry of the crop sampler: grid (tiles, K), threads, dynamic
// shared memory in bytes.
struct CropLaunch {
  unsigned tiles, nty, nzc;
  size_t smem;
};

CropLaunch crop_launch(int V, int J, int vx, int vy, int vz, int from_coords, int cube) {
  const unsigned ntx = (vx + kTX - 1) / kTX, nty = (vy + kTY - 1) / kTY,
                 nzc = (vz + kTZ - 1) / kTZ;
  size_t smem = 16 * (size_t)kWarps * V * 32 + 4 * (size_t)kWarps * 32;
  if (!from_coords) smem += 4 * ((size_t)V * 21 + (size_t)V * 3 * kTS);
  if (!cube) smem += 4 * (size_t)(kTX + kTY) * kTZ * J;
  return {ntx * nty * nzc, nty, nzc, smem};
}

// Launch geometry of the whole-space sampler: tiles along x (the batch
// along y) and dynamic shared memory in bytes.
struct WholeLaunch {
  unsigned tiles;
  size_t smem;
};

WholeLaunch whole_launch(int V, int X, int Y, int Z) {
  const long long n = (long long)X * Y * Z;
  return {(unsigned)((n + kWholeVoxels - 1) / kWholeVoxels),
          16 * (size_t)V * kWholeVoxels + 4 * ((size_t)V * 21 + (size_t)V * 3 * (X + Y + Z))};
}

// The most dynamic shared memory a block of the current device may have
// (its opt-in limit).
cudaError_t max_smem(int* bytes) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
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

// The whole-space sampler's launch: out[0] blocks along x, out[1] = B
// along y, out[2] threads per block, out[3] dynamic shared memory in
// bytes, out[4] the most a block of the current device may have, out[5]
// voxels per block.  Returns the CUDA error of reading the device.
int fvp_whole_launch_geometry(int V, int X, int Y, int Z, int B, long long* out) {
  const WholeLaunch l = whole_launch(V, X, Y, Z);
  int most = 0;
  const cudaError_t e = max_smem(&most);
  const long long geometry[6] = {l.tiles, B, kWholeVoxels, (long long)l.smem, most, kWholeVoxels};
  for (int i = 0; i < 6; ++i) out[i] = geometry[i];
  return (int)e;
}

// The whole-space cube of a batch.  heatmaps (B, V, H, W, J), cams
// (B, V, 21), the grid's axes gx (X), gy (Y), gz (Z), consts the 23 host
// floats of CropConsts (origin and step unused) -> out (B, X, Y, Z, J);
// bounded = 1: the bounded view mean (VoxelPose), else the mean over V.
// V <= 8, J <= 32.  Returns kErrSharedMemory (-1) when V and the grid's
// axes need more shared memory than a block may have, else the launch's
// CUDA error.  Safe to call while the stream is captured into a CUDA graph
// (PoseService captures the served forward): cudaGetDevice,
// cudaDeviceGetAttribute and cudaFuncSetAttribute are no stream work and
// are allowed during a capture, and the constants are copied by value into
// the kernel's parameters, which the graph keeps.
int fvp_sample_whole_projected(const float* hm, const float* cams, const float* gx,
                               const float* gy, const float* gz, const float* consts,
                               float* out, int B, int V, int H, int W, int J, int X, int Y,
                               int Z, int bounded, void* stream) {
  if (B <= 0 || (long long)X * Y * Z <= 0) return (int)cudaGetLastError();
  const WholeLaunch l = whole_launch(V, X, Y, Z);
  int most = 0;
  cudaError_t e = max_smem(&most);
  if (e != cudaSuccess) return (int)e;
  if (l.smem > (size_t)most) return kErrSharedMemory;
  CropConsts kc;
  float* dst = reinterpret_cast<float*>(&kc);
  for (int i = 0; i < (int)(sizeof(CropConsts) / sizeof(float)); ++i) dst[i] = consts[i];
  const dim3 grid(l.tiles, (unsigned)B);
#define FVP_WHOLE(Q)                                                                       \
  do {                                                                                     \
    if (l.smem > 48 * 1024) {                                                              \
      e = cudaFuncSetAttribute(whole_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                               (int)l.smem);                                               \
      if (e != cudaSuccess) return (int)e;                                                 \
    }                                                                                      \
    whole_kernel<Q><<<grid, kWholeVoxels, l.smem, (cudaStream_t)stream>>>(                 \
        hm, cams, gx, gy, gz, kc, out, V, H, W, J, X, Y, Z);                               \
  } while (0)
  if (bounded) FVP_WHOLE(true); else FVP_WHOLE(false);
#undef FVP_WHOLE
  return (int)cudaGetLastError();
}

// The crop sampler's launch: out[0] blocks along x, out[1] = K along y,
// out[2] threads per block, out[3] dynamic shared memory in bytes, out[4]
// the most a block of the current device may have, out[5..7] the tile
// (kTX, kTY, kTZ).  Returns the CUDA error of reading the device.
int fvp_crop_launch_geometry(int V, int J, int K, int vx, int vy, int vz,
                             int from_coords, int cube, long long* out) {
  const CropLaunch l = crop_launch(V, J, vx, vy, vz, from_coords, cube);
  int most = 0;
  const cudaError_t e = max_smem(&most);
  const long long geometry[8] = {l.tiles, K, kThreads, (long long)l.smem,
                                 most, kTX, kTY, kTZ};
  for (int i = 0; i < 8; ++i) out[i] = geometry[i];
  return (int)e;
}

// The crop sampler in its four modes.  heatmaps (V, H, W, J); mx (K, vx),
// my (K, vy), mz (K, vz), valid (K,) uint8.  from_coords = 0: cams (V, 21),
// tl (K, 3) int32 and consts (23 host floats in CropConsts order) give the
// pixels; from_coords = 1: pix (K, V, vx*vy*vz, 2) gives them.  cube = 0:
// outputs (K, vx, vy, J), (K, vx, vz, J), (K, vy, vz, J), zero-filled;
// cube = 1: output (K, vx, vy, vz, J), any contents.  bounded = 1 (with
// from_coords = 0 and cube = 1 only): tl holds float world centres (K, 3)
// and the view mean is the bounded one (kBounded).  Unused pointers may
// be null.  Returns kErrSharedMemory (-1) when V and J need more shared
// memory than a block may have, else the launch's CUDA error.  Safe to
// call during a CUDA graph capture, as fvp_sample_whole_projected is.
int fvp_sample_crop(const float* hm, const float* cams, const int* tl,
                    const float* pix, const uint8_t* mx, const uint8_t* my,
                    const uint8_t* mz, const uint8_t* valid,
                    const float* consts, float* out_xy, float* out_xz,
                    float* out_yz, float* out_cube, int V, int H, int W, int J,
                    int K, int vx, int vy, int vz, int from_coords, int cube,
                    int bounded, void* stream) {
  if (K <= 0) return (int)cudaGetLastError();
  if (bounded && (from_coords || !cube)) return (int)cudaErrorInvalidValue;
  const CropLaunch l = crop_launch(V, J, vx, vy, vz, from_coords, cube);
  int most = 0;
  const cudaError_t e = max_smem(&most);
  if (e != cudaSuccess) return (int)e;
  if (l.smem > (size_t)most) return kErrSharedMemory;
  CropConsts kc;
  float* dst = reinterpret_cast<float*>(&kc);
  for (int i = 0; i < (int)(sizeof(CropConsts) / sizeof(float)); ++i)
    dst[i] = from_coords ? 0.0f : consts[i];
  const int shift = lane_shift_for(J);
  const dim3 grid(l.tiles, (unsigned)K);
  const cudaStream_t st = (cudaStream_t)stream;
#define FVP_CROP(C, Q, B)                                                       \
  do {                                                                          \
    if (l.smem > 48 * 1024) {                                                   \
      const cudaError_t a = cudaFuncSetAttribute(                               \
          crop_kernel<C, Q, B>, cudaFuncAttributeMaxDynamicSharedMemorySize,    \
          (int)l.smem);                                                         \
      if (a != cudaSuccess) return (int)a;                                      \
    }                                                                           \
    crop_kernel<C, Q, B><<<grid, kThreads, l.smem, st>>>(                       \
        hm, cams, tl, pix, mx, my, mz, valid, kc, out_xy, out_xz, out_yz,       \
        out_cube, V, H, W, J, vx, vy, vz, (int)l.nty, (int)l.nzc, shift);       \
  } while (0)
  if (bounded) {
    FVP_CROP(false, true, true);
  } else if (from_coords) {
    if (cube) FVP_CROP(true, true, false); else FVP_CROP(true, false, false);
  } else {
    if (cube) FVP_CROP(false, true, false); else FVP_CROP(false, false, false);
  }
#undef FVP_CROP
  return (int)cudaGetLastError();
}

}  // extern "C"
