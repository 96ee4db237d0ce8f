// Shared device code of the bounce and refill kernels (bounce.cu,
// refill.cu): status codes, the four static scatter laws of
// altair_tpu/core/trace_pallas.py::_scatter_dir, the two random-number
// streams and the exit flight to the world box.
//
// Both kernels are built with -fmad=false (core/_build.py), so every
// function here rounds where its plain PyTorch counterpart in
// core/trace_cuda.py rounds.  core/_build.py hashes this header into each
// library's name, so an edit here rebuilds both kernels.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int RUNNING = 0;
constexpr int EXITED = 1;
constexpr int ABSORBED = 2;
constexpr int SUSPENDED = 3;

constexpr int LAMBERTIAN = 0;
constexpr int SPECULAR = 1;
constexpr int MIXED_BRDF = 2;
constexpr int COS_N_LOBE = 3;

constexpr int COS_N_ROUNDS = 12;
constexpr float TWO_PI = 6.2831853071795864f;
constexpr float INV24 = 5.9604644775390625e-08f;  // 2^-24

template <int MODEL>
struct Law;
template <> struct Law<LAMBERTIAN> { static constexpr int n_draws = 3; };
template <> struct Law<SPECULAR> { static constexpr int n_draws = 4; };
template <> struct Law<MIXED_BRDF> { static constexpr int n_draws = 7; };
template <> struct Law<COS_N_LOBE> {
  static constexpr int n_draws = 1 + 3 * COS_N_ROUNDS;
};

// The 11 per-ray output planes of TraceResult: status, last point, segment
// start, direction, bounce count.
struct Outputs {
  int* status;
  float* lastx;
  float* lasty;
  float* lastz;
  float* segx;
  float* segy;
  float* segz;
  float* dirx;
  float* diry;
  float* dirz;
  int* bounces;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float unit(uint32_t bits) {
  return static_cast<float>(bits >> 8) * INV24;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The ND uniforms of loop iteration `it` for lane `lane`:
//  * hash   — the Pallas kernels' _sw_uniform (trace_pallas.py:82-94):
//             lane_h = fmix32(lane ^ (seed0 ^ seed1)), draw i is
//             fmix32(lane_h + (it * ND + i) * 0x9E3779B9) >> 8, times 2^-24;
//  * philox — Philox4x32-10 keyed by (seed0, seed1), counter (lane low
//             word, lane high word, it, draw group).
template <int MODEL, bool HASH>
__device__ __forceinline__ void draw_uniforms(float* u, long long lane,
                                              uint32_t lane_h, int it,
                                              uint32_t seed0,
                                              uint32_t seed1) {
  constexpr int ND = Law<MODEL>::n_draws;
  if constexpr (HASH) {
    const uint32_t c0 = static_cast<uint32_t>(it) * ND;
#pragma unroll
    for (int i = 0; i < ND; ++i)
      u[i] = unit(fmix32(lane_h + (c0 + i) * 0x9E3779B9u));
  } else {
#pragma unroll
    for (int g = 0; g < (ND + 3) / 4; ++g) {
      const uint4 r = philox4x32_10(
          make_uint4(static_cast<uint32_t>(lane),
                     static_cast<uint32_t>(lane >> 32),
                     static_cast<uint32_t>(it), g),
          seed0, seed1);
      const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * g + j < ND) u[4 * g + j] = unit(w[j]);
    }
  }
}

// Unit direction at polar (st, ct), azimuth ph about unit axis a: the
// branchless Duff basis.  The sign is a comparison, not copysignf, which
// differs at -0.0.
__device__ __forceinline__ void from_local(float ax, float ay, float az,
                                           float st, float ct, float ph,
                                           float& ox, float& oy, float& oz) {
  const float sign = az >= 0.f ? 1.f : -1.f;
  const float a = -1.f / (sign + az);
  const float bb = ax * ay * a;
  const float t1x = 1.f + sign * ax * ax * a;
  const float t1y = sign * bb;
  const float t1z = -sign * ax;
  const float t2x = bb;
  const float t2y = sign + ay * ay * a;
  const float t2z = -ay;
  const float cp = cosf(ph);
  const float sp = sinf(ph);
  ox = st * (cp * t1x + sp * t2x) + ct * ax;
  oy = st * (cp * t1y + sp * t2y) + ct * ay;
  oz = st * (cp * t1z + sp * t2z) + ct * az;
  const float inv = rsqrtf(ox * ox + oy * oy + oz * oz);
  ox *= inv;
  oy *= inv;
  oz *= inv;
}

// standard normal via Box-Muller (log(1 - u) is safe: u < 1)
__device__ __forceinline__ float gauss(float ua, float ub) {
  return sqrtf(-2.f * logf(1.f - ua)) * cosf(TWO_PI * ub);
}

// The scatter laws of trace_pallas.py::_scatter_dir.  u[0] is the survival
// roulette (consumed by the caller); the law consumes u[1:].
template <int MODEL>
__device__ __forceinline__ void scatter(const float* u, float m0, float m1,
                                        float nx, float ny, float nz,
                                        float& dx, float& dy, float& dz) {
  if constexpr (MODEL == LAMBERTIAN) {
    const float ct = sqrtf(u[1]);
    const float st = sqrtf(fmaxf(1.f - u[1], 0.f));
    from_local(nx, ny, nz, st, ct, TWO_PI * u[2], dx, dy, dz);
  } else if constexpr (MODEL == SPECULAR) {
    // mirror about a Gaussian-roughened normal (m0 = sigma), flipped back
    // above the horizon
    const float tilt = m0 * gauss(u[1], u[2]);
    float nrx, nry, nrz;
    from_local(nx, ny, nz, sinf(tilt), cosf(tilt), TWO_PI * u[3], nrx, nry,
               nrz);
    const float dn = dx * nrx + dy * nry + dz * nrz;
    const float ndx = dx - 2.f * dn * nrx;
    const float ndy = dy - 2.f * dn * nry;
    const float ndz = dz - 2.f * dn * nrz;
    const float below = ndx * nx + ndy * ny + ndz * nz;
    const float flip = below < 0.f ? 2.f * below : 0.f;
    dx = ndx - flip * nx;
    dy = ndy - flip * ny;
    dz = ndz - flip * nz;
  } else if constexpr (MODEL == MIXED_BRDF) {
    // Bernoulli(m0) choice of an additively tilted specular bounce (tilt
    // sigma m1) or a cosine-weighted diffuse one
    if (u[1] < m0) {
      const float dn = dx * nx + dy * ny + dz * nz;
      const float rx = dx - 2.f * dn * nx;
      const float ry = dy - 2.f * dn * ny;
      const float rz = dz - 2.f * dn * nz;
      const float theta = m1 * gauss(u[2], u[3]);
      // the additive tilt of r by sin(theta), renormalised: cos part 1
      from_local(rx, ry, rz, sinf(theta), 1.f, TWO_PI * u[6], dx, dy, dz);
    } else {
      const float ct = sqrtf(u[4]);
      const float st = sqrtf(fmaxf(1.f - u[4], 0.f));
      from_local(nx, ny, nz, st, ct, TWO_PI * u[5], dx, dy, dz);
    }
  } else {
    // COS_N_LOBE: theta ~ U(0, m1) accepted with |cos theta|^m0; the first
    // accepted proposal wins, stragglers keep the last proposal
    float theta = 0.f;
    float phi = 0.f;
    bool accepted = false;
#pragma unroll
    for (int i = 0; i < COS_N_ROUNDS; ++i) {
      if (!accepted) {
        theta = m1 * u[1 + 3 * i];
        phi = TWO_PI * u[2 + 3 * i];
        const float p = expf(m0 * logf(fmaxf(fabsf(cosf(theta)), 1e-30f)));
        accepted = u[3 + 3 * i] <= p;
      }
    }
    float ox, oy, oz;
    from_local(nx, ny, nz, sinf(theta), cosf(theta), phi, ox, oy, oz);
    const float sgn = (ox * nx + oy * ny + oz * nz < 0.f) ? -1.f : 1.f;
    dx = ox * sgn;
    dy = oy * sgn;
    dz = oz * sgn;
  }
}

// Fly from (px, py, pz) along (dx, dy, dz) to the world box of half-width
// world_half (trace_pallas.py::_box_flight).
__device__ __forceinline__ void box_flight(float world_half, float dx,
                                           float dy, float dz, float& px,
                                           float& py, float& pz) {
  const float ax = dx == 0.f ? CUDART_INF_F
                             : ((dx >= 0.f ? world_half : -world_half) - px) / dx;
  const float ay = dy == 0.f ? CUDART_INF_F
                             : ((dy >= 0.f ? world_half : -world_half) - py) / dy;
  const float az = dz == 0.f ? CUDART_INF_F
                             : ((dz >= 0.f ? world_half : -world_half) - pz) / dz;
  const float tb = fminf(ax, fminf(ay, az));
  px += dx * tb;
  py += dy * tb;
  pz += dz * tb;
}

}  // namespace
