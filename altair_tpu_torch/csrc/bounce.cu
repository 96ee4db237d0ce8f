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
// is not the limit.  The refill kernel (refill.cu), where a lane whose ray
// died starts the next one, takes batches of 2^20 rays and more.
//
// The laws, the two random streams and the box flight live in
// tracer_common.cuh, shared with refill.cu.
//
// Built by altair_tpu_torch/core/_build.py with nvcc -O3 for sm_90a, without
// --use_fast_math (sqrtf, rsqrtf, sinf, cosf, logf and expf are the
// full-precision library functions) and with -fmad=false, so the kernel
// rounds where its plain PyTorch version (core/trace_cuda.py::bounce_plain)
// rounds and the two agree per lane on the card (contraction would save
// 3-4% of the time on an H100 at 700 W, 16% for SPECULAR).

#include "tracer_common.cuh"

namespace {

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
    draw_uniforms<MODEL, HASH>(u, lane, lane_h, it, seed0, seed1);
    if (!(u[0] < reflectance)) {  // killed by the roulette
      status = ABSORBED;
      break;
    }
    scatter<MODEL>(u, m0, m1, -qx * inv_r, -qy * inv_r, -qz * inv_r, dx, dy,
                   dz);
  }

  if (status == EXITED) {  // fly on from the cap crossing to the world box
    box_flight(world_half, dx, dy, dz, px, py, pz);
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
