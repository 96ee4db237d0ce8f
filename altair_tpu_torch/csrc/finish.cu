// Finish kernel for NVIDIA Hopper (sm_90a): runs each ray of a buffer of
// mid-flight rays from its state to its death (exit, roulette, a stuck gap
// flight or the iteration cap), in one launch.  A thread runs one ray at a
// time and, where the buffer is wider than the card's resident threads,
// takes the next untraced ray of the buffer the step after its own dies.
//
// Replaces no Pallas kernel.  It takes the place of the eager PyTorch step
// loops that finish a buffer of rays already in flight: the deferred rim
// post-pass's continuation (core/trace.py::_rim_continuation, the eager
// loop and the waves tracer), the tail of its hybrid continuation and the
// refill kernel's straggler finish (core/trace_cuda.py::
// _refill_handoff_continue).  Those loops launch a hundred or more small
// ATen kernels a step over a buffer that is mostly dead lanes, and wait on
// the host for each; the JAX package ran them as one XLA while loop.  It
// also traces a thick-rim scene from the source (core/trace_cuda.py::
// trace_rays_finish), where the JAX package runs its in-loop exact-rim
// trace_rays.
//
// Input: the bounce-step carry of core/trace.py::make_bounce_step —
// position, direction, previous point, status, bounce count and the
// in-gap flag, one plane each, of width n.  A lane that is not RUNNING at
// entry writes its state back as it is.
//
// Physics, step for step that of make_bounce_step (template flag EXACT):
//  * simple: the shell hit re-projected onto r, the port-cap test, the
//    survival roulette and the law's scatter; an exit flies from the
//    segment's start to the world box.
//  * exact rim: an interior flight that escapes through the cap is
//    clip-tested against the rim cone (the cone's face normal serves its
//    bounce); a lane in the gap between the shell radii goes to the
//    nearest of the cone, the inner sphere (re-entry) and the outer
//    sphere (exit), and is suspended when it meets none.
// Both: the exit convention of the eager step — the previous point is the
// last wall or rim point, the last point the box point flown to from it —
// and at most max_iters steps from the entry state, then SUSPENDED.  The
// four laws, the Philox stream and the box flight are tracer_common.cuh's.
//
// Random numbers: Philox4x32-10 keyed by (seed0, seed1), counter (lane low
// word, lane high word, step from the lane's entry, draw group), where the
// lane is the ray's index in the buffer, not the thread's: one draw set a
// step (survival, then the law's draws) serves whichever surface the lane
// hit.  A lane draws only on the steps it bounces; the counter makes its
// draws independent of the others', of the launch's shape and of which
// thread runs it when, so every lane's result is the same whatever the
// schedule.  Each lane's outputs go to its own index.
//
// What bounds it on this card.  A lane's steps depend on each other, so a
// thread runs one step of one lane at a time, at a step's latency (~0.66
// us, ~1,300 SM clocks, for one thread alone, PERF.md); the arithmetic
// and the 57 bytes a lane reads and 44 it writes are far below that.  At
// reflectance near 1 a ray's chain is about geometric, so the longest of
// 32 or 256 lanes runs several times the mean.  Two kinds of buffer:
//  * the state entries (the rim buffer's clipped survivors, the refill
//    handoff's stragglers) hold few live lanes, and those first (the
//    compactions keep order): every live lane gets a thread at once and
//    the kernel's time is its longest lane's chain; warps of dead lanes
//    retire at once.
//  * the source entry (the in-sphere sweep's chunks) starts every lane
//    live, several times the resident threads.  With one lane a thread a
//    block lived as long as its longest lane and kept ~20% of its threads
//    stepping; the rest of the card waited on the longest chains.
// So the launch is a pool of depth d = ceil(n / slots), where slots is the
// card's resident threads for the pooled instantiation (occupancy times
// the SMs; core/trace_cuda.py::finish_lanes_per_thread).  At d = 1 it is
// the grid of one lane a thread (template flag POOL off: the lane-static
// loop and nothing else).  At d > 1 the grid is the resident grid: thread
// g starts on lane g and, the step after its lane stops, takes the next
// lane by a warp ballot (the threads that want one get the next lanes in
// thread order, and step them in the same iteration).  No thread idles
// while its warp has lanes to hand out; once they are all out, each
// thread finishes the lane it holds in the lane-static loop, whose step
// carries no hand-out code (a step with it in the loop ran slower: 3.07
// against 2.93 ms for the 800,000-ray chunk, PERF.md).  The next lanes
// come from a warp-owned pool, as csrc/refill.cu's units: warp w owns,
// after its first 32 lanes, the 32-lane rows w*32 + r*threads (r < d),
// handed out by a count the warp keeps in registers.  The rows are
// strided by the grid, so that a state buffer, whose live lanes come
// first, spreads them over the threads; and a warp first writes back its
// last rows that hold no RUNNING lane, so that such a buffer's warps skip
// the pooled loop (the 262,144-lane rim buffer of a 4M trace, 2 lanes a
// thread: 0.5751 against the parent's 0.5790 ms; without it as slow as
// 0.61 ms, PERF.md).  A grid-wide counter (one
// atomicAdd a warp a hand-out, lanes in buffer order) measured about 2%
// slower at both pooled shapes (PERF.md section 6).
//
// Built with -fmad=false like the other kernels (core/_build.py), so it
// rounds where core/trace_cuda.py::finish_plain rounds and the two agree
// per lane on the card.

#include "tracer_common.cuh"

namespace {

constexpr float INF = 1e30f;
constexpr int THREADS = 256;  // a block
constexpr unsigned FULL = 0xffffffffu;

// The mid-flight ray state, one plane per field.
struct State {
  const float* px;
  const float* py;
  const float* pz;
  const float* dx;
  const float* dy;
  const float* dz;
  const float* prevx;
  const float* prevy;
  const float* prevz;
  const int* status;
  const int* bounces;
  const unsigned char* in_gap;
};

// Smallest positive crossing of the port-rim cone (polar angle theta_max,
// z < 0 nappe) with radius in [r_lo, r_hi]; INF where none
// (core/geometry.py::cone_crossing_t, operation for operation).
__device__ __forceinline__ float cone_crossing_t(float px, float py, float pz,
                                                 float dx, float dy, float dz,
                                                 float c2, float r_lo_eps,
                                                 float r_hi_eps) {
  const float dd = dx * dx + dy * dy + dz * dz;
  const float A = dz * dz - c2 * dd;
  const float pd = px * dx + py * dy + pz * dz;
  const float B = 2.f * (pz * dz - c2 * pd);
  const float pp = px * px + py * py + pz * pz;
  const float C = pz * pz - c2 * pp;
  const bool small_a = fabsf(A) < 1e-20f;
  const float safe_A = small_a ? 1.f : A;
  const float disc = B * B - 4.f * A * C;
  const float sq = sqrtf(fmaxf(disc, 0.f));
  const float s_lin = fabsf(B) > 0.f ? -C / B : INF;
  const float roots[2] = {small_a ? s_lin : (-B - sq) / (2.f * safe_A),
                          small_a ? INF : (-B + sq) / (2.f * safe_A)};
  float best = INF;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float s = roots[i];
    const float qx = px + dx * s;
    const float qy = py + dy * s;
    const float qz = pz + dz * s;
    const float r = sqrtf(qx * qx + qy * qy + qz * qz);
    const bool ok = s > 1e-6f && disc >= 0.f && qz < 0.f && r >= r_lo_eps &&
                    r <= r_hi_eps;
    if (ok && s < best) best = s;
  }
  return best;
}

// Smallest positive crossing of |q| = radius from anywhere; INF where none
// (core/geometry.py::sphere_crossing_t).
__device__ __forceinline__ float sphere_crossing_t(float px, float py,
                                                   float pz, float dx,
                                                   float dy, float dz,
                                                   float radius) {
  const float b = px * dx + py * dy + pz * dz;
  const float c = px * px + py * py + pz * pz - radius * radius;
  const float disc = b * b - c;
  const float sq = sqrtf(fmaxf(disc, 0.f));
  const float s1 = -b - sq;
  const float s2 = -b + sq;
  if (disc >= 0.f && s1 > 1e-6f) return s1;
  if (disc >= 0.f && s2 > 1e-6f) return s2;
  return INF;
}

// Unit normal of the rim cone's face at p, pointing into the hole side
// (core/geometry.py::cone_face_normal).
__device__ __forceinline__ void cone_face_normal(float px, float py, float pz,
                                                 float& nx, float& ny,
                                                 float& nz) {
  const float r = sqrtf(px * px + py * py + pz * pz);
  const float rho = sqrtf(px * px + py * py);
  if (rho < 1e-12f) {
    nx = 1.f;
    ny = 0.f;
    nz = 0.f;
    return;
  }
  nx = pz / r * px / rho;
  ny = pz / r * py / rho;
  nz = -rho / r;
}

// The kernel's scene constants.
struct Consts {
  float radius, cos_cap, reflectance, world_half, m0, m1, inv_r;
  float c2, r_lo_eps, r_hi_eps, r_out;
};

// scene: [inner_radius, cos_cap, reflectance, world_half, exit_port_z,
//         max_bounces, m0, m1]  (core/trace_cuda.py::kernel_operands)
// rim:   [cos_theta_max, outer_radius]  (core/trace_cuda.py::rim_operand)
__device__ __forceinline__ Consts consts(const float* __restrict__ scene,
                                         const float* __restrict__ rim) {
  Consts k;
  k.radius = scene[0];
  k.cos_cap = scene[1];
  k.reflectance = scene[2];
  k.world_half = scene[3];
  k.m0 = scene[6];
  k.m1 = scene[7];
  k.inv_r = 1.f / k.radius;
  const float cos_tm = rim[0];
  k.r_out = rim[1];
  k.c2 = cos_tm * cos_tm;
  k.r_lo_eps = k.radius - 1e-6f;
  k.r_hi_eps = k.r_out + 1e-6f;
  return k;
}

// One lane's carry: the bounce-step state and its step count from entry.
struct Carry {
  float px, py, pz, dx, dy, dz, prevx, prevy, prevz;
  int status, bounces, it;
  bool in_gap;
};

// A stopped lane's outputs, at its own index.
__device__ __forceinline__ void store(const Outputs& out, long long lane,
                                      const Carry& c) {
  out.status[lane] = c.status;
  out.lastx[lane] = c.px;
  out.lasty[lane] = c.py;
  out.lastz[lane] = c.pz;
  out.segx[lane] = c.prevx;
  out.segy[lane] = c.prevy;
  out.segz[lane] = c.prevz;
  out.dirx[lane] = c.dx;
  out.diry[lane] = c.dy;
  out.dirz[lane] = c.dz;
  out.bounces[lane] = c.bounces;
}

// Read lane `lane`'s entry state.  Returns whether it takes a step; a lane
// that takes none (not RUNNING, or a cap of 0 steps: then SUSPENDED) is
// written back here.
template <bool EXACT>
__device__ __forceinline__ bool enter(const State& in, const Outputs& out,
                                      long long lane, int max_iters,
                                      Carry& c) {
  c.px = in.px[lane];
  c.py = in.py[lane];
  c.pz = in.pz[lane];
  c.dx = in.dx[lane];
  c.dy = in.dy[lane];
  c.dz = in.dz[lane];
  c.prevx = in.prevx[lane];
  c.prevy = in.prevy[lane];
  c.prevz = in.prevz[lane];
  c.status = in.status[lane];
  c.bounces = in.bounces[lane];
  c.in_gap = EXACT && in.in_gap[lane] != 0;
  c.it = 0;
  if (c.status == RUNNING && max_iters > 0) return true;
  if (c.status == RUNNING) c.status = SUSPENDED;
  store(out, lane, c);
  return false;
}

// Step c.it of lane `lane`'s physics; a lane that stops here gets its final
// status.
template <int MODEL, bool EXACT>
__device__ __forceinline__ void physics(const Consts& k, uint32_t seed0,
                                        uint32_t seed1, long long lane,
                                        Carry& c) {
  constexpr int ND = Law<MODEL>::n_draws;
  // the bounce surface this step, if any: 0 none, 1 wall, 2 rim face
  int hit = 0;
  float hx = 0.f, hy = 0.f, hz = 0.f, nx = 0.f, ny = 0.f, nz = 0.f;
  if (!c.in_gap) {
    const float b = c.px * c.dx + c.py * c.dy + c.pz * c.dz;
    const float cc = c.px * c.px + c.py * c.py + c.pz * c.pz -
                     k.radius * k.radius;
    const float disc = fmaxf(b * b - cc, 0.f);
    const float t = fmaxf(-b + sqrtf(disc), 0.f);
    float qx = c.px + c.dx * t;
    float qy = c.py + c.dy * t;
    float qz = c.pz + c.dz * t;
    const float rn = k.radius * rsqrtf(qx * qx + qy * qy + qz * qz);
    qx *= rn;
    qy *= rn;
    qz *= rn;
    if (!(qz < k.cos_cap)) {
      hit = 1;
      hx = qx;
      hy = qy;
      hz = qz;
      nx = -qx * k.inv_r;
      ny = -qy * k.inv_r;
      nz = -qz * k.inv_r;
    } else if (EXACT) {
      const float s = cone_crossing_t(qx, qy, qz, c.dx, c.dy, c.dz, k.c2,
                                      k.r_lo_eps, k.r_hi_eps);
      if (s < INF) {  // the escape flight meets the rim face
        hit = 2;
        hx = qx + c.dx * s;
        hy = qy + c.dy * s;
        hz = qz + c.dz * s;
      }
    }
  } else {
    const float s_rim = cone_crossing_t(c.px, c.py, c.pz, c.dx, c.dy, c.dz,
                                        k.c2, k.r_lo_eps, k.r_hi_eps);
    const float s_in =
        sphere_crossing_t(c.px, c.py, c.pz, c.dx, c.dy, c.dz, k.radius);
    const float s_out =
        sphere_crossing_t(c.px, c.py, c.pz, c.dx, c.dy, c.dz, k.r_out);
    if (s_rim < s_in && s_rim < s_out) {
      hit = 2;
      hx = c.px + c.dx * s_rim;
      hy = c.py + c.dy * s_rim;
      hz = c.pz + c.dz * s_rim;
    } else if (s_in < s_out) {  // re-enters the sphere
      float ex = c.px + c.dx * s_in;
      float ey = c.py + c.dy * s_in;
      float ez = c.pz + c.dz * s_in;
      const float rn = k.radius * rsqrtf(ex * ex + ey * ey + ez * ez);
      c.prevx = c.px;
      c.prevy = c.py;
      c.prevz = c.pz;
      c.px = ex * rn;
      c.py = ey * rn;
      c.pz = ez * rn;
      c.in_gap = false;
      return;
    } else if (!(s_out < INF)) {  // meets no surface: stuck
      c.status = SUSPENDED;
      return;
    }
  }

  c.prevx = c.px;
  c.prevy = c.py;
  c.prevz = c.pz;
  if (hit == 0) {  // exits: fly on from the segment's start to the box
    box_flight(k.world_half, c.dx, c.dy, c.dz, c.px, c.py, c.pz);
    c.status = EXITED;
    return;
  }
  c.px = hx;
  c.py = hy;
  c.pz = hz;
  ++c.bounces;
  float u[ND];
  draw_uniforms<MODEL, false>(u, lane, 0u, c.it, seed0, seed1);
  if (!(u[0] < k.reflectance)) {  // killed by the roulette
    c.status = ABSORBED;
    return;
  }
  if (hit == 2) cone_face_normal(hx, hy, hz, nx, ny, nz);
  scatter<MODEL>(u, k.m0, k.m1, nx, ny, nz, c.dx, c.dy, c.dz);
  c.in_gap = hit == 2;
}

// One step of lane `lane`, the lane-static loop's body.  Returns whether
// the lane stops here, with its final status (SUSPENDED at the cap).
template <int MODEL, bool EXACT>
__device__ __forceinline__ bool stops(const Consts& k, uint32_t seed0,
                                      uint32_t seed1, int max_iters,
                                      long long lane, Carry& c) {
  physics<MODEL, EXACT>(k, seed0, seed1, lane, c);
  ++c.it;
  if (c.status != RUNNING) return true;
  if (c.it < max_iters) return false;
  c.status = SUSPENDED;
  return true;
}

// gridDim.x * THREADS threads over n lanes.  POOL (threads < n): the
// resident grid, whose threads take the lanes past the grid's first
// until their warp's pool is spent, then finish the lane they hold;
// without it one lane a thread, the lane-static loop.
template <int MODEL, bool EXACT, bool POOL>
__global__ void __launch_bounds__(THREADS)
    finish_kernel(const float* __restrict__ scene,
                  const float* __restrict__ rim, uint32_t seed0,
                  uint32_t seed1, int max_iters, long long n, State in,
                  Outputs out) {
  const Consts k = consts(scene, rim);
  const long long threads = static_cast<long long>(gridDim.x) * THREADS;
  const long long tid =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;

  Carry c;
  long long lane = tid;
  bool busy = lane < n && enter<EXACT>(in, out, lane, max_iters, c);
  if constexpr (POOL) {
    // the warp's pool: its lanes in rows of 32, row r at warp0 + r *
    // threads; `next` (the same in every thread) the pool index of the
    // next lane to hand out
    const int t = threadIdx.x & 31;
    const unsigned below = (1u << t) - 1u;  // the warp's threads before t
    const long long warp0 = tid - t;
    // a state buffer keeps its live lanes first: the warp's last rows that
    // hold no RUNNING lane pass through here, and leave the pool
    int rows = static_cast<int>((n + threads - 1) / threads);
    for (; rows > 1; --rows) {
      const long long l = (rows - 1) * threads + warp0 + t;
      const bool live = l < n && in.status[l] == RUNNING && max_iters > 0;
      if (__any_sync(FULL, live)) break;
      Carry dead;
      if (l < n) enter<EXACT>(in, out, l, max_iters, dead);
    }
    const int pool = 32 * rows;
    for (int next = 32; next < pool;) {
      const unsigned want = __ballot_sync(FULL, !busy);
      if (!busy) {  // take the pool's next lane, in thread order
        const int p = next + __popc(want & below);
        lane = static_cast<long long>(p >> 5) * threads + warp0 + (p & 31);
        busy = p < pool && lane < n &&
               enter<EXACT>(in, out, lane, max_iters, c);
      }
      next += __popc(want);
      if (busy && stops<MODEL, EXACT>(k, seed0, seed1, max_iters, lane, c)) {
        store(out, lane, c);
        busy = false;
      }
    }
  }
  while (busy) {  // the lane-static loop (the last lane of a pooled thread)
    if (stops<MODEL, EXACT>(k, seed0, seed1, max_iters, lane, c)) {
      store(out, lane, c);
      busy = false;
    }
  }
}

template <int MODEL, bool EXACT>
void launch(bool pool, unsigned int blocks, cudaStream_t stream,
            const float* scene, const float* rim, uint32_t seed0,
            uint32_t seed1, int max_iters, long long n, const State& in,
            const Outputs& out) {
  if (pool)
    finish_kernel<MODEL, EXACT, true><<<blocks, THREADS, 0, stream>>>(
        scene, rim, seed0, seed1, max_iters, n, in, out);
  else
    finish_kernel<MODEL, EXACT, false><<<blocks, THREADS, 0, stream>>>(
        scene, rim, seed0, seed1, max_iters, n, in, out);
}

template <int MODEL>
void launch(bool exact, bool pool, unsigned int blocks, cudaStream_t stream,
            const float* scene, const float* rim, uint32_t seed0,
            uint32_t seed1, int max_iters, long long n, const State& in,
            const Outputs& out) {
  if (exact)
    launch<MODEL, true>(pool, blocks, stream, scene, rim, seed0, seed1,
                        max_iters, n, in, out);
  else
    launch<MODEL, false>(pool, blocks, stream, scene, rim, seed0, seed1,
                         max_iters, n, in, out);
}

// The pooled instantiation's resident blocks a multiprocessor.
template <int MODEL>
cudaError_t resident_blocks(bool exact, int* blocks) {
  return exact ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     blocks, finish_kernel<MODEL, true, true>, THREADS, 0)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     blocks, finish_kernel<MODEL, false, true>, THREADS, 0);
}

}  // namespace

// The threads of one block.
extern "C" int altair_finish_threads() { return THREADS; }

// The threads the current device keeps resident at once for the
// instantiation (model, exact_rim): blocks a multiprocessor times the
// multiprocessors times THREADS, into *slots.  Returns the CUDA error;
// cudaErrorInvalidValue for an unknown model.
extern "C" int altair_finish_slots(int model, int exact_rim,
                                   long long* slots) {
  int dev = 0, sms = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool exact = exact_rim != 0;
  switch (model) {
    case LAMBERTIAN:
      err = resident_blocks<LAMBERTIAN>(exact, &blocks);
      break;
    case SPECULAR:
      err = resident_blocks<SPECULAR>(exact, &blocks);
      break;
    case MIXED_BRDF:
      err = resident_blocks<MIXED_BRDF>(exact, &blocks);
      break;
    case COS_N_LOBE:
      err = resident_blocks<COS_N_LOBE>(exact, &blocks);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  *slots = static_cast<long long>(blocks) * sms * THREADS;
  return static_cast<int>(err);
}

// Plain C entry, bound with ctypes.  Every pointer is device memory except
// `stream` (a cudaStream_t); the input planes are read, the output planes
// written, and the two may not overlap.  `threads` is the grid (a positive
// multiple of THREADS; threads >= n is one lane a thread, fewer the
// pool).  Returns cudaGetLastError() after the launch;
// cudaErrorInvalidValue for an unknown model, n < 1 or a bad grid.
extern "C" int altair_finish(
    const float* scene, const float* rim, unsigned int seed0,
    unsigned int seed1, int max_iters, int model, int exact_rim, long long n,
    long long threads, const float* px, const float* py, const float* pz,
    const float* dx, const float* dy, const float* dz, const float* prevx,
    const float* prevy, const float* prevz, const int* status_in,
    const int* bounces_in, const unsigned char* in_gap, int* status,
    float* lastx, float* lasty, float* lastz, float* segx, float* segy,
    float* segz, float* dirx, float* diry, float* dirz, int* bounces,
    void* stream) {
  if (n < 1 || threads < THREADS || threads % THREADS != 0 ||
      threads / THREADS > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const State in{px,    py,    pz,        dx,         dy,    dz,
                 prevx, prevy, prevz, status_in, bounces_in, in_gap};
  const Outputs out{status, lastx, lasty, lastz, segx, segy,
                    segz,   dirx,  diry,  dirz,  bounces};
  const unsigned int blocks = static_cast<unsigned int>(threads / THREADS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool exact = exact_rim != 0;
  const bool pool = threads < n;
  switch (model) {
    case LAMBERTIAN:
      launch<LAMBERTIAN>(exact, pool, blocks, s, scene, rim, seed0, seed1,
                         max_iters, n, in, out);
      break;
    case SPECULAR:
      launch<SPECULAR>(exact, pool, blocks, s, scene, rim, seed0, seed1,
                       max_iters, n, in, out);
      break;
    case MIXED_BRDF:
      launch<MIXED_BRDF>(exact, pool, blocks, s, scene, rim, seed0, seed1,
                         max_iters, n, in, out);
      break;
    case COS_N_LOBE:
      launch<COS_N_LOBE>(exact, pool, blocks, s, scene, rim, seed0, seed1,
                         max_iters, n, in, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
