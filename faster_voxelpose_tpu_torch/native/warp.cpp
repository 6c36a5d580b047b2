// Host-side image preprocessing of the port: fused affine warp + normalize
// (a copy of faster_voxelpose_tpu/native/warp.cpp, with one repair).
//
// The 'image' heatmap source's CPU path (datasets/images.py; the
// reference's per-worker resize + ToTensor + Normalize chain, reference
// run/train.py:60-66 and preprocess.py).  One pass: an inverse-mapped
// bilinear sample straight from the decoded uint8 frame into ImageNet-
// normalized float32, with the channel swap folded into the output
// index.  Zero border (cv2 BORDER_CONSTANT default) outside the source.
//
// The repair: the JAX copy forms its tap pointers from unclamped row and
// column indices (src + y0 * w_in * 3 and r0 + x0 * 3 for an x0 or y0
// outside the image), which is undefined behaviour in C++ even where the
// pointer is never read.  Here every pointer is formed from indices
// clamped into the image; a tap outside it is still never read, so the
// output is that of the JAX copy.
//
// Built by native/build.py with g++ into build/native/, bound via ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

inline int clamp_index(int i, int n) { return std::min(std::max(i, 0), n - 1); }

// Bilinear sample of one output pixel with zero border (cv2
// BORDER_CONSTANT semantics), normalized write through the channel
// permutation.  (x0, y0) is the top-left tap; taps outside the
// h_in x w_in source are not read.
inline void sample_border(
    float* out, const uint8_t* src, int h_in, int w_in,
    int x0, int y0, float ax, float ay,
    const int* perm, const float* cs, const float* co) {
  const float w00 = (1.0f - ax) * (1.0f - ay);
  const float w01 = ax * (1.0f - ay);
  const float w10 = (1.0f - ax) * ay;
  const float w11 = ax * ay;
  const bool row0_in = (unsigned)y0 < (unsigned)h_in;
  const bool row1_in = (unsigned)(y0 + 1) < (unsigned)h_in;
  const bool c0_in = (unsigned)x0 < (unsigned)w_in;
  const bool c1_in = (unsigned)(x0 + 1) < (unsigned)w_in;
  const size_t r0 = (size_t)clamp_index(y0, h_in) * w_in;
  const size_t r1 = (size_t)clamp_index(y0 + 1, h_in) * w_in;
  const size_t c0 = (size_t)clamp_index(x0, w_in);
  const size_t c1 = (size_t)clamp_index(x0 + 1, w_in);
  const uint8_t* p00 = src + (r0 + c0) * 3;
  const uint8_t* p01 = src + (r0 + c1) * 3;
  const uint8_t* p10 = src + (r1 + c0) * 3;
  const uint8_t* p11 = src + (r1 + c1) * 3;
  for (int c = 0; c < 3; ++c) {
    float v = 0.0f;
    if (row0_in && c0_in) v += w00 * (float)p00[c];
    if (row0_in && c1_in) v += w01 * (float)p01[c];
    if (row1_in && c0_in) v += w10 * (float)p10[c];
    if (row1_in && c1_in) v += w11 * (float)p11[c];
    out[perm[c]] = v * cs[c] - co[c];
  }
}

}  // namespace

extern "C" {

// Fused warp + normalize of one uint8 HWC image.
//
//   src:      (h_in, w_in, 3) uint8, C-contiguous
//   dst:      (h_out, w_out, 3) float32, C-contiguous (overwritten)
//   inv:      2x3 row-major dst->src affine (x_src = inv[0]*x + inv[1]*y
//             + inv[2]; y_src = inv[3]*x + inv[4]*y + inv[5])
//   mean/std: per-OUTPUT-channel normalization of v/255
//   swap_rb:  1 to emit channels reversed (BGR source -> RGB output)
void warp_normalize(
    const uint8_t* src, int h_in, int w_in,
    float* dst, int h_out, int w_out,
    const float* inv,
    const float* mean, const float* stdv,
    int swap_rb) {
  const float inv_scale = 1.0f / 255.0f;
  float inv_std[3], off[3];
  for (int c = 0; c < 3; ++c) {
    inv_std[c] = 1.0f / stdv[c];
    off[c] = mean[c] * inv_std[c];
  }
  // output-channel scale/offset indexed by SOURCE channel so the inner
  // loops write out[perm[c]] with no per-pixel branch
  int perm[3];
  float cs[3], co[3];
  for (int c = 0; c < 3; ++c) {
    perm[c] = swap_rb ? 2 - c : c;
    cs[c] = inv_scale * inv_std[perm[c]];
    co[c] = off[perm[c]];
  }

  const bool axis_aligned = (inv[1] == 0.0f && inv[3] == 0.0f);
  if (axis_aligned) {
    // separable fast path (the resize case): x source coords depend only
    // on x, y coords only on y; the column tables are computed once
    int* xs0 = new int[w_out];
    float* axs = new float[w_out];
    for (int x = 0; x < w_out; ++x) {
      const float sx = inv[0] * (float)x + inv[2];
      xs0[x] = (int)std::floor(sx);
      axs[x] = sx - (float)xs0[x];
    }
    for (int y = 0; y < h_out; ++y) {
      float* row = dst + (size_t)y * w_out * 3;
      const float sy = inv[4] * (float)y + inv[5];
      const int y0 = (int)std::floor(sy);
      const float ay = sy - (float)y0;
      const bool rows_in = (unsigned)y0 < (unsigned)h_in &&
                           (unsigned)(y0 + 1) < (unsigned)h_in;
      if (rows_in) {
        const uint8_t* r0 = src + (size_t)y0 * w_in * 3;
        const uint8_t* r1 = r0 + (size_t)w_in * 3;
        int x = 0;
        // left border: columns until both taps are in bounds
        for (; x < w_out; ++x) {
          const int x0 = xs0[x];
          if ((unsigned)x0 < (unsigned)(w_in - 1)) break;
          sample_border(row + (size_t)x * 3, src, h_in, w_in, x0, y0, axs[x], ay,
                        perm, cs, co);
        }
        // branch-free interior: both columns in bounds
        for (; x < w_out; ++x) {
          const int x0 = xs0[x];
          if ((unsigned)x0 >= (unsigned)(w_in - 1)) break;
          const float ax = axs[x];
          const float w00 = (1.0f - ax) * (1.0f - ay);
          const float w01 = ax * (1.0f - ay);
          const float w10 = (1.0f - ax) * ay;
          const float w11 = ax * ay;
          const uint8_t* p00 = r0 + (size_t)x0 * 3;
          const uint8_t* p10 = r1 + (size_t)x0 * 3;
          float* out = row + (size_t)x * 3;
          for (int c = 0; c < 3; ++c) {
            const float v = w00 * (float)p00[c] + w01 * (float)p00[c + 3] +
                            w10 * (float)p10[c] + w11 * (float)p10[c + 3];
            out[perm[c]] = v * cs[c] - co[c];
          }
        }
        for (; x < w_out; ++x)
          sample_border(row + (size_t)x * 3, src, h_in, w_in, xs0[x], y0, axs[x], ay,
                        perm, cs, co);
      } else {
        for (int x = 0; x < w_out; ++x)
          sample_border(row + (size_t)x * 3, src, h_in, w_in, xs0[x], y0, axs[x], ay,
                        perm, cs, co);
      }
    }
    delete[] xs0;
    delete[] axs;
    return;
  }

  for (int y = 0; y < h_out; ++y) {
    float* row = dst + (size_t)y * w_out * 3;
    const float fy = (float)y;
    for (int x = 0; x < w_out; ++x) {
      const float fx = (float)x;
      const float sx = inv[0] * fx + inv[1] * fy + inv[2];
      const float sy = inv[3] * fx + inv[4] * fy + inv[5];
      const int x0 = (int)std::floor(sx);
      const int y0 = (int)std::floor(sy);
      sample_border(row + (size_t)x * 3, src, h_in, w_in, x0, y0,
                    sx - (float)x0, sy - (float)y0, perm, cs, co);
    }
  }
}

// Fused normalize (no warp) of one uint8 HWC image already at network
// size: v/255 -> (v - mean)/std, optional channel reversal.
void normalize_u8(
    const uint8_t* src, int h, int w,
    float* dst,
    const float* mean, const float* stdv,
    int swap_rb) {
  const float inv_scale = 1.0f / 255.0f;
  float inv_std[3], off[3];
  for (int c = 0; c < 3; ++c) {
    inv_std[c] = 1.0f / stdv[c];
    off[c] = mean[c] * inv_std[c];
  }
  const size_t n = (size_t)h * w;
  for (size_t i = 0; i < n; ++i) {
    const uint8_t* p = src + i * 3;
    float* out = dst + i * 3;
    for (int c = 0; c < 3; ++c) {
      const int oc = swap_rb ? 2 - c : c;
      out[oc] = (float)p[c] * inv_scale * inv_std[oc] - off[oc];
    }
  }
}

}  // extern "C"
