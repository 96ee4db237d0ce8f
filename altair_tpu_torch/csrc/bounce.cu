// Bounce kernel for NVIDIA Hopper (sm_90a): one thread traces one ray from
// the source until it exits through the port, is absorbed by the roulette,
// or reaches max_bounces.
//
// Replaces: altair_tpu/core/trace_pallas.py::_bounce_kernel (the Pallas TPU
// kernel launched by trace_rays_pallas).  Same physics, step for step: the
// shell hit t = -b + sqrt(b^2 - c) re-projected onto r, the port-cap test
// qz < r cos(theta_max), the survival roulette, then one of the four static
// scatter laws (LAMBERTIAN 3 draws per bounce, SPECULAR 4, MIXED_BRDF 7,
// COS_N_LOBE 1 + 3*12); exits fly on to the world box once, in the epilogue.
// The TPU kernel's (128, 128) lane blocks, its block-multiple rule on N and
// the wrapper's pad-and-truncate are gone: any N, with a bounds check.
//
// Random numbers, two modes (template flag HASH):
//  * hash   — bit for bit the Pallas kernel's software generator
//             _sw_uniform (trace_pallas.py:72-94): lane_h = fmix32(lane ^
//             (seed0 ^ seed1)), draw i of iteration it is fmix32(lane_h +
//             (it * n_draws + i) * 0x9E3779B9) >> 8, times 2^-24.  The
//             Pallas lane id row*128 + col + block*16384 is the flat ray
//             index, and a ray is active on a prefix of iterations, so this
//             thread's own iteration count gives the same counters as the
//             block-global one.  Used to hold the kernel against the Pallas
//             kernel in interpret mode and against the plain PyTorch
//             version.
//  * philox — Philox4x32-10 keyed by (seed0, seed1) with counter (ray index
//             low word, high word, iteration, draw group): the production
//             stream.
//
// What bounds it on this card: per-ray arithmetic — a sqrt, an rsqrt, a
// sin/cos pair and (for the non-Lambertian laws) log and more trig per
// bounce — and warp divergence in the bounce-count tail: a warp runs until
// its longest ray dies (a mean of ~57 bounces against a warp maximum of
// ~200 in the production scene), so most lanes idle for most iterations.
// It writes 44 bytes per ray and reads nothing per bounce, so device memory
// is not the limit.  What later work does about it: the refill kernel
// (trace_pallas.py::_refill_kernel, still to port), where a lane whose ray
// died starts the next one, and warp-level compaction of the live lanes.
//
// Built by altair_tpu_torch/core/_build.py with nvcc -O3 for sm_90a, without
// --use_fast_math (sqrtf, rsqrtf, sinf, cosf, logf and expf are the
// full-precision library functions) and with -fmad=false, so the kernel
// rounds where its plain PyTorch version (core/trace_cuda.py::bounce_plain)
// rounds and the two agree per lane on the card (contraction would save
// 3-4% of the time on an H100 at 700 W, 16% for SPECULAR).

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

// scene: [inner_radius, cos_cap, reflectance, world_half, exit_port_z,
//         max_bounces, m0, m1]  (trace_pallas.py::_kernel_operands)
// src:   [x, y, z, dx, dy, dz, 0, 0]  (direction normalised)
template <int MODEL, bool HASH>
__global__ void __launch_bounds__(256)
    bounce_kernel(const float* __restrict__ scene,
                  const float* __restrict__ src, uint32_t seed0,
                  uint32_t seed1, int max_bounces, long long n, Outputs out) {
  const long long lane =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  constexpr int ND = Law<MODEL>::n_draws;

  const float radius = scene[0];
  const float cos_cap = scene[1];
  const float reflectance = scene[2];
  const float world_half = scene[3];
  const float m0 = scene[6];
  const float m1 = scene[7];
  const float inv_r = 1.f / radius;

  float px = src[0], py = src[1], pz = src[2];
  float dx = src[3], dy = src[4], dz = src[5];
  float prevx = px, prevy = py, prevz = pz;
  int status = RUNNING;
  int bounces = 0;
  const uint32_t lane_h =
      fmix32(static_cast<uint32_t>(lane) ^ (seed0 ^ seed1));

  for (int it = 0; it < max_bounces; ++it) {
    const float b = px * dx + py * dy + pz * dz;
    const float c = px * px + py * py + pz * pz - radius * radius;
    const float disc = fmaxf(b * b - c, 0.f);
    const float t = fmaxf(-b + sqrtf(disc), 0.f);
    float qx = px + dx * t;
    float qy = py + dy * t;
    float qz = pz + dz * t;
    const float rn = radius * rsqrtf(qx * qx + qy * qy + qz * qz);
    qx *= rn;
    qy *= rn;
    qz *= rn;
    prevx = px;
    prevy = py;
    prevz = pz;
    px = qx;
    py = qy;
    pz = qz;
    if (qz < cos_cap) {  // escaped through the port cap
      status = EXITED;
      break;
    }
    ++bounces;

    float u[ND];
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
    if (!(u[0] < reflectance)) {  // killed by the roulette
      status = ABSORBED;
      break;
    }
    scatter<MODEL>(u, m0, m1, -qx * inv_r, -qy * inv_r, -qz * inv_r, dx, dy,
                   dz);
  }

  if (status == EXITED) {  // fly on from the cap crossing to the world box
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
  } else if (status == RUNNING) {
    status = SUSPENDED;
  }

  out.status[lane] = status;
  out.lastx[lane] = px;
  out.lasty[lane] = py;
  out.lastz[lane] = pz;
  out.segx[lane] = prevx;
  out.segy[lane] = prevy;
  out.segz[lane] = prevz;
  out.dirx[lane] = dx;
  out.diry[lane] = dy;
  out.dirz[lane] = dz;
  out.bounces[lane] = bounces;
}

template <int MODEL>
void launch(bool hash, dim3 grid, dim3 block, cudaStream_t stream,
            const float* scene, const float* src, uint32_t seed0,
            uint32_t seed1, int max_bounces, long long n, Outputs out) {
  if (hash)
    bounce_kernel<MODEL, true><<<grid, block, 0, stream>>>(
        scene, src, seed0, seed1, max_bounces, n, out);
  else
    bounce_kernel<MODEL, false><<<grid, block, 0, stream>>>(
        scene, src, seed0, seed1, max_bounces, n, out);
}

}  // namespace

// Plain C entry, bound with ctypes.  Every pointer is device memory except
// `stream` (a cudaStream_t).  Returns cudaGetLastError() after the launch;
// cudaErrorInvalidValue for an unknown model or n < 1.
extern "C" int altair_bounce(const float* scene, const float* src,
                             unsigned int seed0, unsigned int seed1,
                             int max_bounces, int model, int hash_rng,
                             long long n, int* status, float* lastx,
                             float* lasty, float* lastz, float* segx,
                             float* segy, float* segz, float* dirx,
                             float* diry, float* dirz, int* bounces,
                             void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Outputs out{status, lastx, lasty, lastz, segx, segy,
                    segz,   dirx,  diry,  dirz,  bounces};
  const dim3 block(256);
  const dim3 grid(static_cast<unsigned int>((n + 255) / 256));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool hash = hash_rng != 0;
  switch (model) {
    case LAMBERTIAN:
      launch<LAMBERTIAN>(hash, grid, block, s, scene, src, seed0, seed1,
                         max_bounces, n, out);
      break;
    case SPECULAR:
      launch<SPECULAR>(hash, grid, block, s, scene, src, seed0, seed1,
                       max_bounces, n, out);
      break;
    case MIXED_BRDF:
      launch<MIXED_BRDF>(hash, grid, block, s, scene, src, seed0, seed1,
                         max_bounces, n, out);
      break;
    case COS_N_LOBE:
      launch<COS_N_LOBE>(hash, grid, block, s, scene, src, seed0, seed1,
                         max_bounces, n, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
