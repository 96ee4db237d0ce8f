// Refill kernel for NVIDIA Hopper (sm_90a): one warp owns a pool of LANES
// lanes (the handoff unit) and its 32 threads trace them.  A thread takes
// the pool's next lane the step after its lane is spent and runs that
// lane's `budget` rays back to back, respawning at the source the moment a
// ray exits, is absorbed or reaches max_bounces.
//
// Replaces: altair_tpu/core/trace_pallas.py::_refill_kernel (the Pallas TPU
// kernel launched by trace_rays_refill).  Same physics and the same finish
// rules (trace_pallas.py:508-535): a ray is done on an exit (qz < cos_cap),
// on the roulette, or when it survives with rbounces + 1 >= max_bounces;
// a done ray's slot gets its status, the crossing q as the segment start,
// the direction before the scatter, rbounces (exit) or rbounces + 1
// (otherwise), and for an exit the flight from q to the world box as the
// last point.  A thread writes a slot to device memory when its ray
// finishes; slots never reached are written once at the end (zeros:
// status RUNNING).
//
// Why not the TPU's schedule.  On the TPU a lane is a vector lane in
// lockstep with its block, so each lane kept a fixed list of `budget` rays
// and idled once they were spent, until the block's slowest lane ended
// (duty ~30-40% at budget 4, trace_pallas.py:423-425).  Carried over as
// one thread per lane, a warp ran for the longest of its 32 lanes: ~470-500
// steps for a mean of ~232 at budget 4 in the production scene.  A Hopper
// thread branches on its own and a warp can hand out work with a ballot,
// so here no thread idles while its warp's pool has lanes: the warp tail
// is paid once per LANES / 32 lanes a thread, not once per lane, and only
// the last lane of each thread can run alone.  Warps never wait for each
// other: no __syncthreads, no shared memory; a block is one warp.
//
// Output layout.  Slot j of pool lane l in unit u sits at flat index
// u*budget*LANES + j*LANES + l: the Pallas layout with LANES in place of
// its 16384-lane block.  N must be a multiple of LANES * budget.
//
// Random numbers (template flag HASH), as in bounce.cu, keyed by the lane
// and the lane's own step counter k (0 when a thread takes the lane, +1 a
// bounce): the lane id is the global u*LANES + l, which is the Pallas lane
// id program_id*16384 + row*128 + col whatever LANES is, and the Pallas
// kernel also steps a lane at every iteration until it is spent, with its
// counter at the lane's k.  So hash is bit for bit _sw_uniform
// (trace_pallas.py:439-446,497-499), philox has counter (lane low word,
// lane high word, k, draw group), and without the handoff every slot is
// the one the lane-static schedule gives, whatever LANES or the refill
// order.
//
// Tail handoff (thresh > 0).  Every INNER_ITERS warp steps, and only then,
// the warp sums the rays left in its unit (budget - ray_idx over the lanes
// in flight, budget for each lane not yet taken) and leaves when the sum
// is <= thresh, or at a step cap that cannot bind for max_bounces >= 1 (a
// thread takes at most LANES - 31 lanes, each done within budget *
// max_bounces steps).  A warp whose pool is spent and whose threads are all
// done leaves at once: its remaining sum is 0.  The refill order depends
// only on the unit's inputs, so the straggler set does too, and
// core/trace_cuda.py::refill_plain computes the same one.  With thresh > 0
// the kernel also writes 8 live planes per lane (position, direction,
// ray_idx, rbounces; trace_pallas.py:555-568): a lane in flight its
// state, a lane never taken the source ray with ray_idx 0, a spent lane
// the source ray with ray_idx == budget.
//
// What bounds it on this card: the per-bounce arithmetic (sphere hit,
// sqrt and rsqrt, the law's trig and, for philox, 10 Philox rounds per 4
// draws), with no memory read per bounce and 44 bytes written per ray.
// The Lambertian, philox step runs 119 FP32 and 31 IMAD instructions
// besides register moves (the IMAD pipe takes both; FP32 also the other
// FMA pipe), 65 ALU and 12 MUFU/conversions: the two FMA pipes bind, at
// 1.17 SM clocks a thread step, 1.08 ms for the 240M steps of 4,194,304
// rays on an H100 SXM at 1980 MHz.  The step also issues 41 branches, 32
// register moves, 12 uniform instructions and the pool's 3 vote and lane
// counts: 315 in all, 2.46 issue clocks a step (2.26 ms), so as compiled
// the kernel cannot reach half its bound.  altair_tpu_torch/
// profile_refill.py counts them from cuobjdump's SASS, and chip_smoke.py
// computes each run's bound from the arithmetic (PERF.md section 6).
//
// LANES was picked by one measured call over 64/128/256 lanes
// (profile_refill.py, PERF.md): 128 lanes a unit (4 lanes a thread; at 4M
// rays 8192 warps) beat 256 at 2^20 and the retrace chunk's 1,600,000
// rays and trailed it slightly at 4M; 64 lanes lost at every size (a
// thread's last lane runs alone for a larger share of the warp).  A block
// is one warp: the warps share nothing.  ptxas gives the eight
// instantiations 64-72 registers; two of them spill 8-12 bytes.
//
// Built by core/_build.py like bounce.cu: nvcc -O3, sm_90a, -fmad=false,
// no fast math, so the kernel agrees per slot with its plain PyTorch
// version core/trace_cuda.py::refill_plain on the card.  LANES can be set
// with -DALTAIR_REFILL_LANES (the profile script builds variants that
// way); the wrapper checks it.

#include "tracer_common.cuh"

#ifndef ALTAIR_REFILL_LANES
#define ALTAIR_REFILL_LANES 128
#endif

namespace {

constexpr int LANES = ALTAIR_REFILL_LANES;  // lanes of one unit: a warp's pool
constexpr int INNER_ITERS = 64;             // warp steps between handoff checks
constexpr unsigned FULL = 0xffffffffu;
static_assert(LANES >= 32 && (LANES & (LANES - 1)) == 0,
              "LANES must be a power of two of at least one warp");

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

__device__ __forceinline__ void write_slot(const Outputs& out, long long o,
                                           int status, float lx, float ly,
                                           float lz, float sx, float sy,
                                           float sz, float dx, float dy,
                                           float dz, int bounces) {
  out.status[o] = status;
  out.lastx[o] = lx;
  out.lasty[o] = ly;
  out.lastz[o] = lz;
  out.segx[o] = sx;
  out.segy[o] = sy;
  out.segz[o] = sz;
  out.dirx[o] = dx;
  out.diry[o] = dy;
  out.dirz[o] = dz;
  out.bounces[o] = bounces;
}

__device__ __forceinline__ void write_empty_slot(const Outputs& out,
                                                 long long o) {
  write_slot(out, o, RUNNING, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f,
             0);
}

// scene: [inner_radius, cos_cap, reflectance, world_half, exit_port_z,
//         max_bounces, m0, m1]  (trace_pallas.py::_kernel_operands)
// src:   [x, y, z, dx, dy, dz, 0, 0]  (direction normalised)
template <int MODEL, bool HASH>
__global__ void __launch_bounds__(32)
    refill_kernel(const float* __restrict__ scene,
                  const float* __restrict__ src, uint32_t seed0,
                  uint32_t seed1, int max_bounces, int budget, int thresh,
                  Outputs out, Live live) {
  const long long unit = blockIdx.x;  // a block is one warp, one unit
  constexpr int ND = Law<MODEL>::n_draws;
  const int t = threadIdx.x;
  const unsigned below = (1u << t) - 1u;  // the threads before this one
  const long long lane0 = unit * LANES;   // global id of pool lane 0
  const long long slot0 = unit * budget * LANES;  // flat index of its slot 0

  const float radius = scene[0];
  const float cos_cap = scene[1];
  const float reflectance = scene[2];
  const float world_half = scene[3];
  const float m0 = scene[6];
  const float m1 = scene[7];
  const float inv_r = 1.f / radius;
  const float sx0 = src[0], sy0 = src[1], sz0 = src[2];
  const float dx0 = src[3], dy0 = src[4], dz0 = src[5];

  // this thread's lane: its pool index p, global id, hash key and step
  // counter; ray_idx == budget means "no lane in flight" (none taken yet,
  // or the one held is spent)
  int p = 0;
  long long lane = 0;
  uint32_t lane_h = 0;
  int k = 0;
  float px = sx0, py = sy0, pz = sz0;
  float dx = dx0, dy = dy0, dz = dz0;
  int ray_idx = budget;
  int rbounces = 0;
  int next = 0;  // lanes of the pool handed out; the same in every thread
  const long long step_cap =
      static_cast<long long>(LANES - 31) * budget * max_bounces;

  bool spent = false;  // the pool is empty and every thread is done
  for (long long step = 0; !spent; step += INNER_ITERS) {
    const int remaining =
        __reduce_add_sync(FULL, budget - ray_idx) + budget * (LANES - next);
    if (step >= step_cap || remaining <= thresh) break;
    for (int s = 0; s < INNER_ITERS; ++s) {
      const bool need = ray_idx >= budget;
      const unsigned mask = __ballot_sync(FULL, need);
      if (next >= LANES && mask == FULL) {
        spent = true;
        break;
      }
      if (need) {  // take the pool's next lane, in thread order
        const int q = next + __popc(mask & below);
        if (q < LANES) {
          p = q;
          lane = lane0 + q;
          lane_h = fmix32(static_cast<uint32_t>(lane) ^ (seed0 ^ seed1));
          k = 0;
          ray_idx = 0;
        }
      }
      next = min(next + __popc(mask), LANES);
      if (ray_idx >= budget) continue;  // nothing left for this thread

      const float b = px * dx + py * dy + pz * dz;
      const float c = px * px + py * py + pz * pz - radius * radius;
      const float disc = fmaxf(b * b - c, 0.f);
      const float tt = fmaxf(-b + sqrtf(disc), 0.f);
      float qx = px + dx * tt;
      float qy = py + dy * tt;
      float qz = pz + dz * tt;
      const float rn = radius * rsqrtf(qx * qx + qy * qy + qz * qz);
      qx *= rn;
      qy *= rn;
      qz *= rn;

      int status = RUNNING;
      if (qz < cos_cap) {  // escaped through the port cap
        status = EXITED;
      } else {
        float u[ND];
        draw_uniforms<MODEL, HASH>(u, lane, lane_h, k, seed0, seed1);
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
      ++k;
      if (status != RUNNING) {  // the ray is done: its slot, then respawn
        float lx = qx, ly = qy, lz = qz;
        if (status == EXITED) box_flight(world_half, dx, dy, dz, lx, ly, lz);
        write_slot(out, slot0 + static_cast<long long>(ray_idx) * LANES + p,
                   status, lx, ly, lz, qx, qy, qz, dx, dy, dz,
                   status == EXITED ? rbounces : rbounces + 1);
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
  // marker, and SUSPENDED after the wrapper's final pass) -- the rest of
  // the lane in flight, and every slot of the lanes never taken
  for (int j = ray_idx; j < budget; ++j)
    write_empty_slot(out, slot0 + static_cast<long long>(j) * LANES + p);
  for (int q = next + t; q < LANES; q += 32)
    for (int j = 0; j < budget; ++j)
      write_empty_slot(out, slot0 + static_cast<long long>(j) * LANES + q);
  if (thresh > 0) {
    // every lane as the source ray (spent or never taken), then the lanes
    // in flight over them
    for (int q = t; q < LANES; q += 32) {
      live.px[lane0 + q] = sx0;
      live.py[lane0 + q] = sy0;
      live.pz[lane0 + q] = sz0;
      live.dx[lane0 + q] = dx0;
      live.dy[lane0 + q] = dy0;
      live.dz[lane0 + q] = dz0;
      live.ray_idx[lane0 + q] = q < next ? budget : 0;
      live.bounces[lane0 + q] = 0;
    }
    __syncwarp();
    if (ray_idx < budget) {
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
}

template <int MODEL>
void launch(bool hash, unsigned int blocks, cudaStream_t stream,
            const float* scene, const float* src, uint32_t seed0,
            uint32_t seed1, int max_bounces, int budget, int thresh,
            Outputs out, Live live) {
  if (hash)
    refill_kernel<MODEL, true><<<blocks, 32, 0, stream>>>(
        scene, src, seed0, seed1, max_bounces, budget, thresh, out, live);
  else
    refill_kernel<MODEL, false><<<blocks, 32, 0, stream>>>(
        scene, src, seed0, seed1, max_bounces, budget, thresh, out, live);
}

}  // namespace

// The lanes of one unit (a warp's pool, the handoff unit); the wrapper
// checks it against its own constant.
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
  if (budget < 1 || thresh < 0 || max_bounces < 0 || n < 1 ||
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
  const unsigned int blocks =  // one warp a unit
      static_cast<unsigned int>(n / (static_cast<long long>(LANES) * budget));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool hash = hash_rng != 0;
  switch (model) {
    case LAMBERTIAN:
      launch<LAMBERTIAN>(hash, blocks, s, scene, src, seed0, seed1,
                         max_bounces, budget, thresh, out, live);
      break;
    case SPECULAR:
      launch<SPECULAR>(hash, blocks, s, scene, src, seed0, seed1,
                       max_bounces, budget, thresh, out, live);
      break;
    case MIXED_BRDF:
      launch<MIXED_BRDF>(hash, blocks, s, scene, src, seed0, seed1,
                         max_bounces, budget, thresh, out, live);
      break;
    case COS_N_LOBE:
      launch<COS_N_LOBE>(hash, blocks, s, scene, src, seed0, seed1,
                         max_bounces, budget, thresh, out, live);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
