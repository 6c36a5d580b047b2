// The in-kernel camera projection that the port's kernels share: world
// point -> camera frame -> original-image pixel -> network-input pixel, op
// for op as geometry/cameras.py:project_points and the resize affine of
// geometry/grids.py:project_to_norm_coords compute it.
//
// Included by csrc/sampling.cu (its samplers go on to the heatmap frame,
// camera_to_pixel there) and csrc/projattn.cu (MvP's projective attention
// stops at the network input).  Everything here rounds after every
// operation (the *_rn intrinsics, which nvcc never contracts into an FMA),
// as the plain versions' separate tensor ops do: near a camera the
// perspective divide magnifies one ulp of a contracted multiply-add past
// the samplers' 1e-5 tolerance.

#pragma once

#include <cuda_runtime.h>

#define MUL __fmul_rn
#define ADD __fadd_rn
#define SUB __fsub_rn
#define DIV __fdiv_rn

// One of the nine products of a point against camera c[21] (R row-major
// world -> camera at c[0..8], the camera centre T at c[9..11]): world
// coordinate g on axis a, row r of the rotation, as project_points forms
// it: (g - T[a]) * R[r][a].  A separable grid needs them per axis index,
// not per voxel.
__device__ __forceinline__ float axis_product(const float* c, int r, int a, float g) {
  return MUL(SUB(g, c[9 + a]), c[3 * r + a]);
}

// Camera-frame coordinate r of world point (x, y, z): the three products
// summed in project_points' order.
__device__ __forceinline__ float world_to_camera(const float* c, int r, float x, float y,
                                                 float z) {
  return ADD(ADD(axis_product(c, r, 0, x), axis_product(c, r, 1, y)), axis_product(c, r, 2, z));
}

// Camera-frame point (xc0, xc1, xc2) of camera c[21] -> network-input pixel
// (qx, qy): the perspective divide (depth + 1e-5), the radial and
// tangential distortion, the intrinsics (original-image pixel), its clamp
// to [-1, clip_hi] and the 2x3 original-image -> network-input affine t
// (row-major).  Where inb is given, whether the original-image pixel,
// before its clamp, lies inside [0, ori_w) x [0, ori_h) (VoxelPose's
// `bounding`).
__device__ __forceinline__ void camera_to_input(const float* c, float xc0, float xc1, float xc2,
                                                const float* t, float clip_hi, float ori_w,
                                                float ori_h, float& qx, float& qy,
                                                bool* inb = nullptr) {
  const float den = ADD(xc2, 1e-5f);
  const float y0 = DIV(xc0, den), y1 = DIV(xc1, den);
  const float r2 = ADD(MUL(y0, y0), MUL(y1, y1));
  const float d = ADD(ADD(ADD(1.0f, MUL(c[16], r2)), MUL(MUL(c[17], r2), r2)),
                      MUL(MUL(MUL(c[18], r2), r2), r2));
  const float u = ADD(ADD(MUL(y0, d), MUL(MUL(MUL(2.0f, c[19]), y0), y1)),
                      MUL(c[20], ADD(r2, MUL(MUL(2.0f, y0), y0))));
  const float v = ADD(ADD(MUL(y1, d), MUL(MUL(MUL(2.0f, c[20]), y0), y1)),
                      MUL(c[19], ADD(r2, MUL(MUL(2.0f, y1), y1))));
  const float rx = ADD(MUL(u, c[12]), c[14]), ry = ADD(MUL(v, c[13]), c[15]);
  if (inb) *inb = rx >= 0.0f && ry >= 0.0f && rx < ori_w && ry < ori_h;
  const float ox = fminf(fmaxf(rx, -1.0f), clip_hi);
  const float oy = fminf(fmaxf(ry, -1.0f), clip_hi);
  qx = ADD(ADD(MUL(ox, t[0]), MUL(oy, t[1])), t[2]);
  qy = ADD(ADD(MUL(ox, t[3]), MUL(oy, t[4])), t[5]);
}
