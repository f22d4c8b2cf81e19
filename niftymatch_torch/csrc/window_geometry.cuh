// Keypoint windows in the zero-padded gradient planes, shared by K2
// (windows.cu) and K3 (descriptors.cu).
//
// The gradient planes are one zero-padded (S, Hp, Wp) stack per channel
// (magnitude, angle), S = images x octaves x levels, with R pixels of zero
// on every side of each slab, so a window never needs a bounds test.  A
// keypoint names its slab by (image, octave, level).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float TWO_PI_F = 6.283185307179586f;

__device__ __forceinline__ float floor_mod(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.0f && ((b < 0.0f) != (r < 0.0f))) r += b;
  return r;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct Geometry {
  const float* planes_mag;
  const float* planes_ang;
  int num_images, num_octaves, num_levels;
  int hp, wp, pad;   // slab height/width with padding, padding R
};

// Octave coordinates of keypoint k and the pointer offset of its integer
// centre pixel inside its padded slab (ops/orientation.py::octave_coords,
// kernels/windows.py::_window_params).
struct Centre {
  float xo, yo, so;
  int xi, yi;
  size_t offset;
};

__device__ Centre keypoint_centre(const Geometry& g, float x, float y,
                                  float sigma, int octave, int level,
                                  int image) {
  Centre c;
  octave = clampi(octave, 0, g.num_octaves - 1);
  level = clampi(level, 0, g.num_levels - 1);
  image = clampi(image, 0, g.num_images - 1);
  float xper = exp2f((float)octave);
  c.xo = x / xper;
  c.yo = y / xper;
  c.so = sigma / xper;
  c.xi = clampi((int)floorf(c.xo + 0.5f), 0, g.wp - 2 * g.pad - 1);
  c.yi = clampi((int)floorf(c.yo + 0.5f), 0, g.hp - 2 * g.pad - 1);
  size_t slab = ((size_t)image * g.num_octaves + octave) * g.num_levels + level;
  c.offset = (slab * g.hp + (size_t)(g.pad + c.yi)) * g.wp + (g.pad + c.xi);
  return c;
}

Geometry make_geometry(const void* mag, const void* ang, int num_images,
                       int num_octaves, int num_levels, int hp, int wp,
                       int pad) {
  Geometry g;
  g.planes_mag = static_cast<const float*>(mag);
  g.planes_ang = static_cast<const float*>(ang);
  g.num_images = num_images;
  g.num_octaves = num_octaves;
  g.num_levels = num_levels;
  g.hp = hp;
  g.wp = wp;
  g.pad = pad;
  return g;
}

}  // namespace
