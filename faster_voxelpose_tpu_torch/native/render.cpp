// Host-side Gaussian heatmap renderer of the port (a copy of
// faster_voxelpose_tpu/native/render.cpp; the same arithmetic, so that it
// renders the JAX package's heatmaps bit for bit).
//
// The data pipeline's CPU hot path: rendering per-joint Gaussian patches
// into (H, W, J) heatmaps for the 'gt' and 'pred' heatmap sources
// (datasets/base.py: render_heatmap, the reference's
// JointsDataset.generate_input_heatmap, JointsDataset.py:271-338).
// Python keeps the RNG and per-joint parameter computation (so the
// augmentation draws follow the JAX package's order); this code does the
// windowed exp + occlusion + max-accumulate work.  The plain version of
// the same math is `_render_joints_numpy` in datasets/base.py.
//
// Built by native/build.py with g++ into build/native/, bound via ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>

extern "C" {

// Render M joint instances into out (H, W, J), channels-last, max-combine.
//
// Per instance m:
//   mu[m*2+0], mu[m*2+1]: integer heatmap-frame center (x, y)
//   joint_id[m]: output channel
//   sigma[m]: gaussian sigma (heatmap pixels)
//   tmp_size[m]: window half-extent (3 * sigma, float; window is
//                [mu - tmp, mu + tmp + 1) as in the Python path)
//   scale[m]: magnitude multiplier (augmentation; 1.0 when off)
//   occl[m*4..]: occlusion rectangle [y0, y1, x0, x1) in the *local*
//                window frame (quirk preserved from the reference); pass
//                y0 == y1 for none.
// Final clip to [0, 1] is applied by the caller once per person-loop
// iteration in the Python path; equivalent to clipping here at the end.
void render_joints(
    float* out, int H, int W, int J,
    int M,
    const int32_t* mu,
    const int32_t* joint_id,
    const float* sigma,
    const float* tmp_size,
    const float* scale,
    const int32_t* occl) {
  for (int m = 0; m < M; ++m) {
    const int mu_x = mu[m * 2 + 0];
    const int mu_y = mu[m * 2 + 1];
    const float tmp = tmp_size[m];
    const int ul_x = (int)(mu_x - tmp);
    const int ul_y = (int)(mu_y - tmp);
    const int br_x = (int)(mu_x + tmp + 1.0f);
    const int br_y = (int)(mu_y + tmp + 1.0f);
    if (ul_x >= W || ul_y >= H || br_x < 0 || br_y < 0) continue;

    const int j = joint_id[m];
    const float s = scale[m];
    const float inv = 1.0f / (2.0f * sigma[m] * sigma[m]);
    // local gaussian window: size = 2*tmp + 1, center size // 2
    const int size = (int)(2.0f * tmp + 1.0f);
    const int c = size / 2;

    const int oy0 = occl[m * 4 + 0], oy1 = occl[m * 4 + 1];
    const int ox0 = occl[m * 4 + 2], ox1 = occl[m * 4 + 3];

    const int gx0 = std::max(0, -ul_x);
    const int gx1 = std::min(br_x, W) - ul_x;
    const int gy0 = std::max(0, -ul_y);
    const int gy1 = std::min(br_y, H) - ul_y;

    for (int gy = gy0; gy < gy1; ++gy) {
      const int iy = ul_y + gy;
      float* row = out + ((size_t)iy * W) * J;
      const float dy = (float)(gy - c);
      const float dy2 = dy * dy;
      const bool in_oy = (gy >= oy0 && gy < oy1);
      for (int gx = gx0; gx < gx1; ++gx) {
        float g;
        if (in_oy && gx >= ox0 && gx < ox1) {
          g = 0.0f;
        } else {
          const float dx = (float)(gx - c);
          g = std::exp(-(dx * dx + dy2) * inv) * s;
        }
        const int ix = ul_x + gx;
        float* cell = row + (size_t)ix * J + j;
        if (g > *cell) *cell = g;
      }
    }
  }
  // clip to [0, 1]
  const size_t n = (size_t)H * W * J;
  for (size_t i = 0; i < n; ++i) {
    if (out[i] > 1.0f) out[i] = 1.0f;
    else if (out[i] < 0.0f) out[i] = 0.0f;
  }
}

}  // extern "C"
