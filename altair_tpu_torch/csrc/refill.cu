// Refill kernel for NVIDIA Hopper (sm_90a): one thread is one lane, and it
// traces `budget` rays back to back, respawning at the source the moment
// its ray exits, is absorbed or reaches max_bounces.
//
// Replaces: altair_tpu/core/trace_pallas.py::_refill_kernel (the Pallas TPU
// kernel launched by trace_rays_refill).  Same physics and the same finish
// rules (trace_pallas.py:508-535): a ray is done on an exit (qz < cos_cap),
// on the roulette, or when it survives with rbounces + 1 >= max_bounces;
// a done ray's slot gets its status, the crossing q as the segment start,
// the direction before the scatter, rbounces (exit) or rbounces + 1
// (otherwise), and for an exit the flight from q to the world box as the
// last point.  The TPU kernel keeps all budget x 8 slot planes of a block in
// VMEM until its epilogue; here a thread writes a slot to device memory
// when its ray finishes, and once more at the end for the slots it never
// reached (zeros: status RUNNING).
//
// Output layout.  The handoff unit is the thread block of LANES threads.
// Slot j of lane l in block b sits at flat index b*budget*LANES + j*LANES
// + l: the Pallas layout with LANES in place of its 16384-lane block.  N
// must be a multiple of LANES * budget.
//
// Random numbers (template flag HASH), as in bounce.cu, with `it` the
// block's loop iteration and the lane id the global thread index
// b*LANES + l, which is the Pallas lane id program_id*16384 + row*128 + col
// whatever LANES is: hash is bit for bit _sw_uniform
// (trace_pallas.py:439-446,497-499); philox has counter (lane low word,
// lane high word, it, draw group).
//
// Tail handoff (thresh > 0).  Every INNER_ITERS iterations, and only then,
// the block sums remaining = sum(budget - ray_idx) over its lanes in shared
// memory, and leaves the loop when it >= max_bounces * budget or
// remaining <= thresh: the Pallas while-cond (trace_pallas.py:538-548) with
// its 64-iteration cadence.  Every thread reaches every reduction (no early
// return), and the exit is uniform across the block.  With thresh > 0 the
// kernel also writes the loop-exit carry of each lane to 8 live planes
// (position, direction, ray_idx, rbounces; trace_pallas.py:555-568) for
// the host-side straggler finish.
//
// What bounds it on this card: the same per-bounce arithmetic as the
// bounce kernel (sqrt, rsqrt, trig, logs for the non-Lambertian laws).
// The warp tail, which bounds the bounce kernel (a warp runs until its
// longest ray dies, ~4x the mean at 32 lanes), is paid once per `budget`
// rays, and the handoff cuts the block's last stretch where few lanes are
// live.  Each finished ray writes 44 bytes; nothing is read per bounce.
//
// Built by core/_build.py like bounce.cu: nvcc -O3, sm_90a, -fmad=false,
// no fast math, so the kernel agrees per slot with its plain PyTorch
// version core/trace_cuda.py::refill_plain on the card.

#include "tracer_common.cuh"

namespace {

constexpr int LANES = 256;        // threads per block: the handoff unit
constexpr int INNER_ITERS = 64;   // iterations between handoff checks

// per-lane loop-exit carry, written when thresh > 0
struct Live {
  float* px;
  float* py;
  float* pz;
  float* dx;
  float* dy;
  float* dz;
  int* ray_idx;
  int* bounces;
};

// Sum of v over the block; every thread of the block must call it.
__device__ __forceinline__ int block_sum(int v, int* warp_sums) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < LANES / 32; ++w) total += warp_sums[w];
  __syncthreads();  // the next call overwrites warp_sums
  return total;
}

// scene: [inner_radius, cos_cap, reflectance, world_half, exit_port_z,
//         max_bounces, m0, m1]  (trace_pallas.py::_kernel_operands)
// src:   [x, y, z, dx, dy, dz, 0, 0]  (direction normalised)
template <int MODEL, bool HASH>
__global__ void __launch_bounds__(LANES)
    refill_kernel(const float* __restrict__ scene,
                  const float* __restrict__ src, uint32_t seed0,
                  uint32_t seed1, int max_bounces, int budget, int thresh,
                  Outputs out, Live live) {
  __shared__ int warp_sums[LANES / 32];
  constexpr int ND = Law<MODEL>::n_draws;
  const long long lane =
      static_cast<long long>(blockIdx.x) * LANES + threadIdx.x;
  // flat index of this lane's slot 0; slot j is LANES further per slot
  const long long base =
      static_cast<long long>(blockIdx.x) * budget * LANES + threadIdx.x;

  const float radius = scene[0];
  const float cos_cap = scene[1];
  const float reflectance = scene[2];
  const float world_half = scene[3];
  const float m0 = scene[6];
  const float m1 = scene[7];
  const float inv_r = 1.f / radius;
  const float sx0 = src[0], sy0 = src[1], sz0 = src[2];
  const float dx0 = src[3], dy0 = src[4], dz0 = src[5];

  float px = sx0, py = sy0, pz = sz0;
  float dx = dx0, dy = dy0, dz = dz0;
  int ray_idx = 0;
  int rbounces = 0;
  const uint32_t lane_h =
      fmix32(static_cast<uint32_t>(lane) ^ (seed0 ^ seed1));
  const long long it_cap = static_cast<long long>(max_bounces) * budget;

  int it = 0;
  while (true) {
    const int remaining = block_sum(budget - ray_idx, warp_sums);
    if (!(it < it_cap && remaining > thresh)) break;
    for (int k = 0; k < INNER_ITERS; ++k, ++it) {
      if (ray_idx >= budget) continue;
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

      int status = RUNNING;
      if (qz < cos_cap) {  // escaped through the port cap
        status = EXITED;
      } else {
        float u[ND];
        draw_uniforms<MODEL, HASH>(u, lane, lane_h, it, seed0, seed1);
        if (!(u[0] < reflectance)) {
          status = ABSORBED;
        } else if (rbounces + 1 >= max_bounces) {
          status = SUSPENDED;
        } else {  // a wall bounce: the ray goes on
          scatter<MODEL>(u, m0, m1, -qx * inv_r, -qy * inv_r, -qz * inv_r,
                         dx, dy, dz);
          px = qx;
          py = qy;
          pz = qz;
          ++rbounces;
        }
      }
      if (status != RUNNING) {  // the ray is done: its slot, then respawn
        const long long o = base + static_cast<long long>(ray_idx) * LANES;
        float lx = qx, ly = qy, lz = qz;
        if (status == EXITED) box_flight(world_half, dx, dy, dz, lx, ly, lz);
        out.status[o] = status;
        out.lastx[o] = lx;
        out.lasty[o] = ly;
        out.lastz[o] = lz;
        out.segx[o] = qx;
        out.segy[o] = qy;
        out.segz[o] = qz;
        out.dirx[o] = dx;
        out.diry[o] = dy;
        out.dirz[o] = dz;
        out.bounces[o] = status == EXITED ? rbounces : rbounces + 1;
        px = sx0;
        py = sy0;
        pz = sz0;
        dx = dx0;
        dy = dy0;
        dz = dz0;
        rbounces = 0;
        ++ray_idx;
      }
    }
  }

  // slots never reached: RUNNING with zero fields (the handoff's pending
  // marker, and SUSPENDED after the wrapper's final pass)
  for (int j = ray_idx; j < budget; ++j) {
    const long long o = base + static_cast<long long>(j) * LANES;
    out.status[o] = RUNNING;
    out.lastx[o] = 0.f;
    out.lasty[o] = 0.f;
    out.lastz[o] = 0.f;
    out.segx[o] = 0.f;
    out.segy[o] = 0.f;
    out.segz[o] = 0.f;
    out.dirx[o] = 0.f;
    out.diry[o] = 0.f;
    out.dirz[o] = 0.f;
    out.bounces[o] = 0;
  }
  if (thresh > 0) {
    live.px[lane] = px;
    live.py[lane] = py;
    live.pz[lane] = pz;
    live.dx[lane] = dx;
    live.dy[lane] = dy;
    live.dz[lane] = dz;
    live.ray_idx[lane] = ray_idx;
    live.bounces[lane] = rbounces;
  }
}

template <int MODEL>
void launch(bool hash, dim3 grid, cudaStream_t stream, const float* scene,
            const float* src, uint32_t seed0, uint32_t seed1, int max_bounces,
            int budget, int thresh, Outputs out, Live live) {
  if (hash)
    refill_kernel<MODEL, true><<<grid, LANES, 0, stream>>>(
        scene, src, seed0, seed1, max_bounces, budget, thresh, out, live);
  else
    refill_kernel<MODEL, false><<<grid, LANES, 0, stream>>>(
        scene, src, seed0, seed1, max_bounces, budget, thresh, out, live);
}

}  // namespace

// The lanes of one thread block (the handoff unit); the wrapper checks it
// against its own constant.
extern "C" int altair_refill_lanes() { return LANES; }

// Plain C entry, bound with ctypes.  Every pointer is device memory except
// `stream` (a cudaStream_t); the 8 live pointers are read only when
// thresh > 0.  Returns cudaGetLastError() after the launch;
// cudaErrorInvalidValue for an unknown model, budget < 1, thresh < 0, or
// n not a positive multiple of LANES * budget.
extern "C" int altair_refill(const float* scene, const float* src,
                             unsigned int seed0, unsigned int seed1,
                             int max_bounces, int model, int hash_rng,
                             long long n, int budget, int thresh, int* status,
                             float* lastx, float* lasty, float* lastz,
                             float* segx, float* segy, float* segz,
                             float* dirx, float* diry, float* dirz,
                             int* bounces, float* live_px, float* live_py,
                             float* live_pz, float* live_dx, float* live_dy,
                             float* live_dz, int* live_ray_idx,
                             int* live_bounces, void* stream) {
  if (budget < 1 || thresh < 0 || n < 1 ||
      n % (static_cast<long long>(LANES) * budget) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (thresh > 0 && (live_px == nullptr || live_py == nullptr ||
                     live_pz == nullptr || live_dx == nullptr ||
                     live_dy == nullptr || live_dz == nullptr ||
                     live_ray_idx == nullptr || live_bounces == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Outputs out{status, lastx, lasty, lastz, segx, segy,
                    segz,   dirx,  diry,  dirz,  bounces};
  const Live live{live_px, live_py, live_pz, live_dx,
                  live_dy, live_dz, live_ray_idx, live_bounces};
  const dim3 grid(
      static_cast<unsigned int>(n / (static_cast<long long>(LANES) * budget)));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool hash = hash_rng != 0;
  switch (model) {
    case LAMBERTIAN:
      launch<LAMBERTIAN>(hash, grid, s, scene, src, seed0, seed1, max_bounces,
                         budget, thresh, out, live);
      break;
    case SPECULAR:
      launch<SPECULAR>(hash, grid, s, scene, src, seed0, seed1, max_bounces,
                       budget, thresh, out, live);
      break;
    case MIXED_BRDF:
      launch<MIXED_BRDF>(hash, grid, s, scene, src, seed0, seed1, max_bounces,
                         budget, thresh, out, live);
      break;
    case COS_N_LOBE:
      launch<COS_N_LOBE>(hash, grid, s, scene, src, seed0, seed1, max_bounces,
                         budget, thresh, out, live);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
