// The fused warp of the --fast-aug reader (data/fast_aug.py,
// FastLIPDataset in data/lip.py): the port's own copy of
// native/npp_native.cpp.
//
// The reference's scale -> rotate -> crop -> flip chain (three full-image
// resamples) composed into ONE inverse affine map and applied in one pass:
//  * image: bilinear sampling with a 128-grey border, and the ImageNet
//    normalisation fused in (float32 out), or rounded to uint8 for the
//    device-normalising loader;
//  * labels: nearest sampling with a 255 (ignore) border, then the
//    left/right class swap through a 256-entry table when flipped.
// Exposed as a C ABI for ctypes. Built into the reader's one host library
// beside imgproc.cpp (data/imgproc.py), but with native/Makefile's flags,
// -O3 -march=native and GCC's default FMA contraction (no -ffast-math):
// the contraction moves a bilinear value by up to a grey level and a
// nearest label across a rounding tie, so the port rounds as npp_tpu's
// build does. The batched entry point and its thread pool are left out:
// nothing binds them, and the loader's threads run samples in parallel.

#include <cmath>
#include <cstdint>

namespace {

struct Affine {
  // Maps output pixel (x, y) to source pixel: xs = a*x + b*y + c, ...
  float a, b, c, d, e, f;
};

// Compose the reference augmentation chain into a single output->source
// affine. Forward chain (source -> output):
//   p1 = s * p                                  (scale)
//   p2 = R(p1) + t_rot                          (canvas-expanding rotate)
//   p3 = p2 - crop_start + store_start          (crop translate)
//   p4 = flip ? (W-1-x, y) : p3                 (horizontal flip)
// We build the forward 2x3 then invert it.
Affine build_inverse_affine(float scale, float rot_deg, int src_h, int src_w,
                            float crop_dx, float crop_dy, int out_w,
                            int flip) {
  const float r = rot_deg * 3.14159265358979323846f / 180.0f;
  const float cs = std::cos(r), sn = std::sin(r);
  // Scaled size.
  const float sw = src_w * scale, sh = src_h * scale;
  // cv2.getRotationMatrix2D(center=(sw/2, sh/2), angle, 1) rotates about
  // the scaled center; the canvas grows to fit (data_augmentation.py:48-70)
  // adding translation tx, ty.
  const float new_w = std::fabs(sn) * sh + std::fabs(cs) * sw;
  const float new_h = std::fabs(sn) * sw + std::fabs(cs) * sh;
  const float cx = sw / 2.0f, cy = sh / 2.0f;
  // cv2 rotation matrix (angle positive = counter-clockwise in image
  // coords): [cs, sn, (1-cs)*cx - sn*cy; -sn, cs, sn*cx + (1-cs)*cy]
  float m00 = cs, m01 = sn;
  float m10 = -sn, m11 = cs;
  float m02 = (1 - cs) * cx - sn * cy + (new_w - sw) / 2.0f;
  float m12 = sn * cx + (1 - cs) * cy + (new_h - sh) / 2.0f;
  // Prepend scale: p2 = M_rot * (s * p).
  m00 *= scale; m01 *= scale; m10 *= scale; m11 *= scale;
  // Crop translate: out = p2 - crop_start + store_start = p2 + (dx, dy)
  // where dx = store_start_x - crop_start_x (joint_transformation.py:29-40).
  m02 += crop_dx;
  m12 += crop_dy;
  // Optional flip: x' = out_w - 1 - x.
  if (flip) {
    m00 = -m00; m01 = -m01; m02 = (out_w - 1) - m02;
  }
  // Invert the forward 2x3.
  const float det = m00 * m11 - m01 * m10;
  const float inv_det = det != 0.0f ? 1.0f / det : 0.0f;
  Affine inv;
  inv.a = m11 * inv_det;
  inv.b = -m01 * inv_det;
  inv.d = -m10 * inv_det;
  inv.e = m00 * inv_det;
  inv.c = -(inv.a * m02 + inv.b * m12);
  inv.f = -(inv.d * m02 + inv.e * m12);
  return inv;
}

void warp_image(const uint8_t* src, int sh, int sw, const Affine& t,
                float* dst, int oh, int ow, const float* mean,
                const float* stdv) {
  // Bilinear sample with 128-gray border (data_augmentation padding),
  // fused /255 + normalize.
  for (int y = 0; y < oh; ++y) {
    for (int x = 0; x < ow; ++x) {
      const float xs = t.a * x + t.b * y + t.c;
      const float ys = t.d * x + t.e * y + t.f;
      float rgb[3];
      if (xs < -1.0f || ys < -1.0f || xs > sw || ys > sh) {
        rgb[0] = rgb[1] = rgb[2] = 128.0f;
      } else {
        const int x0 = (int)std::floor(xs), y0 = (int)std::floor(ys);
        const float fx = xs - x0, fy = ys - y0;
        for (int c = 0; c < 3; ++c) {
          auto at = [&](int yy, int xx) -> float {
            if (xx < 0 || yy < 0 || xx >= sw || yy >= sh) return 128.0f;
            return (float)src[(yy * sw + xx) * 3 + c];
          };
          const float v0 = at(y0, x0) * (1 - fx) + at(y0, x0 + 1) * fx;
          const float v1 = at(y0 + 1, x0) * (1 - fx) + at(y0 + 1, x0 + 1) * fx;
          rgb[c] = v0 * (1 - fy) + v1 * fy;
        }
      }
      float* out = dst + (y * ow + x) * 3;
      for (int c = 0; c < 3; ++c)
        out[c] = (rgb[c] / 255.0f - mean[c]) / stdv[c];
    }
  }
}

void warp_image_u8(const uint8_t* src, int sh, int sw, const Affine& t,
                   uint8_t* dst, int oh, int ow) {
  // Bilinear sample with 128-gray border, kept as uint8 (the ImageNet
  // normalization runs on DEVICE in the loader renderer — 4x fewer
  // host->device bytes than the float path above).
  for (int y = 0; y < oh; ++y) {
    for (int x = 0; x < ow; ++x) {
      const float xs = t.a * x + t.b * y + t.c;
      const float ys = t.d * x + t.e * y + t.f;
      float rgb[3];
      if (xs < -1.0f || ys < -1.0f || xs > sw || ys > sh) {
        rgb[0] = rgb[1] = rgb[2] = 128.0f;
      } else {
        const int x0 = (int)std::floor(xs), y0 = (int)std::floor(ys);
        const float fx = xs - x0, fy = ys - y0;
        for (int c = 0; c < 3; ++c) {
          auto at = [&](int yy, int xx) -> float {
            if (xx < 0 || yy < 0 || xx >= sw || yy >= sh) return 128.0f;
            return (float)src[(yy * sw + xx) * 3 + c];
          };
          const float v0 = at(y0, x0) * (1 - fx) + at(y0, x0 + 1) * fx;
          const float v1 = at(y0 + 1, x0) * (1 - fx) + at(y0 + 1, x0 + 1) * fx;
          rgb[c] = v0 * (1 - fy) + v1 * fy;
        }
      }
      uint8_t* out = dst + (y * ow + x) * 3;
      for (int c = 0; c < 3; ++c) {
        float v = rgb[c] + 0.5f;
        out[c] = (uint8_t)(v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v));
      }
    }
  }
}

void warp_label(const uint8_t* src, int sh, int sw, const Affine& t,
                uint8_t* dst, int oh, int ow, const uint8_t* swap_lut) {
  // Nearest sample with 255 (ignore) border + class LUT (flip swap).
  for (int y = 0; y < oh; ++y) {
    for (int x = 0; x < ow; ++x) {
      const int xs = (int)std::lround(t.a * x + t.b * y + t.c);
      const int ys = (int)std::lround(t.d * x + t.e * y + t.f);
      uint8_t v = 255;
      if (xs >= 0 && ys >= 0 && xs < sw && ys < sh) v = src[ys * sw + xs];
      dst[y * ow + x] = swap_lut ? swap_lut[v] : v;
    }
  }
}

}  // namespace

extern "C" {

// Single-sample fused augmentation.
// image: src_h x src_w x 3 uint8 RGB; label: src_h x src_w uint8 (or null).
// Outputs: out_img (out_h*out_w*3 float32), out_label (out_h*out_w uint8).
// crop_dx/crop_dy = store_start - crop_start per axis. swap_lut: 256-byte
// class remap applied after flip (or null).
void npp_fused_augment(const uint8_t* image, const uint8_t* label,
                       int src_h, int src_w, float scale, float rot_deg,
                       float crop_dx, float crop_dy, int flip,
                       int out_h, int out_w, const float* mean,
                       const float* stdv, const uint8_t* swap_lut,
                       float* out_img, uint8_t* out_label) {
  const Affine t = build_inverse_affine(scale, rot_deg, src_h, src_w,
                                        crop_dx, crop_dy, out_w, flip);
  warp_image(image, src_h, src_w, t, out_img, out_h, out_w, mean, stdv);
  if (label && out_label)
    warp_label(label, src_h, src_w, t, out_label, out_h, out_w,
               flip ? swap_lut : nullptr);
}

// uint8-output variant: same warp, no normalization (device-normalize
// pipelines; see data/fast_aug.py fused_augment(..., as_uint8=True)).
void npp_fused_augment_u8(const uint8_t* image, const uint8_t* label,
                          int src_h, int src_w, float scale, float rot_deg,
                          float crop_dx, float crop_dy, int flip,
                          int out_h, int out_w, const uint8_t* swap_lut,
                          uint8_t* out_img, uint8_t* out_label) {
  const Affine t = build_inverse_affine(scale, rot_deg, src_h, src_w,
                                        crop_dx, crop_dy, out_w, flip);
  warp_image_u8(image, src_h, src_w, t, out_img, out_h, out_w);
  if (label && out_label)
    warp_label(label, src_h, src_w, t, out_label, out_h, out_w,
               flip ? swap_lut : nullptr);
}

// Map joint coordinates through the same forward chain (so targets match
// the warped image). joints: n x 2 (x, y) float32, transformed in place.
void npp_transform_joints(float* joints, int n_joints, int src_h, int src_w,
                          float scale, float rot_deg, float crop_dx,
                          float crop_dy, int flip, int out_w) {
  const Affine inv = build_inverse_affine(scale, rot_deg, src_h, src_w,
                                          crop_dx, crop_dy, out_w, flip);
  // Invert the inverse to get the forward map.
  const float det = inv.a * inv.e - inv.b * inv.d;
  const float k = det != 0.0f ? 1.0f / det : 0.0f;
  const float a = inv.e * k, b = -inv.b * k;
  const float d = -inv.d * k, e = inv.a * k;
  const float c = -(a * inv.c + b * inv.f);
  const float f = -(d * inv.c + e * inv.f);
  for (int i = 0; i < n_joints; ++i) {
    const float x = joints[i * 2], y = joints[i * 2 + 1];
    joints[i * 2] = a * x + b * y + c;
    joints[i * 2 + 1] = d * x + e * y + f;
  }
}

int npp_native_version() { return 2; }

}  // extern "C"
