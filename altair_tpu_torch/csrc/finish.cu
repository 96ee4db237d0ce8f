// Finish kernel for NVIDIA Hopper (sm_90a): one thread runs one ray of a
// mid-flight buffer from its state to its death (exit, roulette, a stuck
// gap flight or the iteration cap), in one launch.
//
// Replaces no Pallas kernel.  It takes the place of the eager PyTorch step
// loops that finish a buffer of rays already in flight: the deferred rim
// post-pass's continuation (core/trace.py::_rim_continuation, the eager
// loop and the waves tracer), the tail of its hybrid continuation and the
// refill kernel's straggler finish (core/trace_cuda.py::
// _refill_handoff_continue).  Those loops launch a hundred or more small
// ATen kernels a step over a buffer that is mostly dead lanes, and wait on
// the host for each; the JAX package ran them as one XLA while loop.
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
// word, lane high word, step from entry, draw group): one draw set a step
// (survival, then the law's draws) serves whichever surface the lane hit.
// A lane draws only on the steps it bounces; the counter makes its draws
// independent of the others' and of the launch's shape.
//
// What bounds it on this card: the serial chain of its longest lane.  The
// buffers hold few live lanes (the rim buffer's clipped survivors, the
// refill handoff's stragglers) and a lane's steps depend on each other,
// so the kernel's time is the longest lane's steps times one step's
// latency; the arithmetic and the 57 bytes a lane read and 44 written are
// far below it.  The buffers come with their valid lanes first (the
// compactions keep order), so warps of dead lanes retire at once.
//
// Built with -fmad=false like the other kernels (core/_build.py), so it
// rounds where core/trace_cuda.py::finish_plain rounds and the two agree
// per lane on the card.

#include "tracer_common.cuh"

namespace {

constexpr float INF = 1e30f;

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

// scene: [inner_radius, cos_cap, reflectance, world_half, exit_port_z,
//         max_bounces, m0, m1]  (core/trace_cuda.py::kernel_operands)
// rim:   [cos_theta_max, outer_radius]  (core/trace_cuda.py::rim_operand)
template <int MODEL, bool EXACT>
__global__ void __launch_bounds__(256)
    finish_kernel(const float* __restrict__ scene,
                  const float* __restrict__ rim, uint32_t seed0,
                  uint32_t seed1, int max_iters, long long n, State in,
                  Outputs out) {
  const long long lane =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  constexpr int ND = Law<MODEL>::n_draws;

  float px = in.px[lane], py = in.py[lane], pz = in.pz[lane];
  float dx = in.dx[lane], dy = in.dy[lane], dz = in.dz[lane];
  float prevx = in.prevx[lane], prevy = in.prevy[lane], prevz = in.prevz[lane];
  int status = in.status[lane];
  int bounces = in.bounces[lane];

  if (status == RUNNING) {
    const float radius = scene[0];
    const float cos_cap = scene[1];
    const float reflectance = scene[2];
    const float world_half = scene[3];
    const float m0 = scene[6];
    const float m1 = scene[7];
    const float inv_r = 1.f / radius;
    const float cos_tm = rim[0];
    const float r_out = rim[1];
    const float c2 = cos_tm * cos_tm;
    const float r_lo_eps = radius - 1e-6f;
    const float r_hi_eps = r_out + 1e-6f;
    bool in_gap = EXACT && in.in_gap[lane] != 0;

    for (int it = 0; it < max_iters; ++it) {
      // the bounce surface this step, if any: 0 none, 1 wall, 2 rim face
      int hit = 0;
      float hx = 0.f, hy = 0.f, hz = 0.f, nx = 0.f, ny = 0.f, nz = 0.f;
      if (!in_gap) {
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
        if (!(qz < cos_cap)) {
          hit = 1;
          hx = qx;
          hy = qy;
          hz = qz;
          nx = -qx * inv_r;
          ny = -qy * inv_r;
          nz = -qz * inv_r;
        } else if (EXACT) {
          const float s = cone_crossing_t(qx, qy, qz, dx, dy, dz, c2, r_lo_eps,
                                          r_hi_eps);
          if (s < INF) {  // the escape flight meets the rim face
            hit = 2;
            hx = qx + dx * s;
            hy = qy + dy * s;
            hz = qz + dz * s;
          }
        }
      } else {
        const float s_rim = cone_crossing_t(px, py, pz, dx, dy, dz, c2,
                                            r_lo_eps, r_hi_eps);
        const float s_in = sphere_crossing_t(px, py, pz, dx, dy, dz, radius);
        const float s_out = sphere_crossing_t(px, py, pz, dx, dy, dz, r_out);
        if (s_rim < s_in && s_rim < s_out) {
          hit = 2;
          hx = px + dx * s_rim;
          hy = py + dy * s_rim;
          hz = pz + dz * s_rim;
        } else if (s_in < s_out) {  // re-enters the sphere
          float ex = px + dx * s_in;
          float ey = py + dy * s_in;
          float ez = pz + dz * s_in;
          const float rn = radius * rsqrtf(ex * ex + ey * ey + ez * ez);
          prevx = px;
          prevy = py;
          prevz = pz;
          px = ex * rn;
          py = ey * rn;
          pz = ez * rn;
          in_gap = false;
          continue;
        } else if (!(s_out < INF)) {  // meets no surface: stuck
          status = SUSPENDED;
          break;
        }
      }

      prevx = px;
      prevy = py;
      prevz = pz;
      if (hit == 0) {  // exits: fly on from the segment's start to the box
        box_flight(world_half, dx, dy, dz, px, py, pz);
        status = EXITED;
        break;
      }
      px = hx;
      py = hy;
      pz = hz;
      ++bounces;
      float u[ND];
      draw_uniforms<MODEL, false>(u, lane, 0u, it, seed0, seed1);
      if (!(u[0] < reflectance)) {  // killed by the roulette
        status = ABSORBED;
        break;
      }
      if (hit == 2) cone_face_normal(hx, hy, hz, nx, ny, nz);
      scatter<MODEL>(u, m0, m1, nx, ny, nz, dx, dy, dz);
      in_gap = hit == 2;
    }
    if (status == RUNNING) status = SUSPENDED;
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
void launch(bool exact, dim3 grid, dim3 block, cudaStream_t stream,
            const float* scene, const float* rim, uint32_t seed0,
            uint32_t seed1, int max_iters, long long n, const State& in,
            const Outputs& out) {
  if (exact)
    finish_kernel<MODEL, true><<<grid, block, 0, stream>>>(
        scene, rim, seed0, seed1, max_iters, n, in, out);
  else
    finish_kernel<MODEL, false><<<grid, block, 0, stream>>>(
        scene, rim, seed0, seed1, max_iters, n, in, out);
}

}  // namespace

// Plain C entry, bound with ctypes.  Every pointer is device memory except
// `stream` (a cudaStream_t); the input planes are read, the output planes
// written, and the two may not overlap.  Returns cudaGetLastError() after
// the launch; cudaErrorInvalidValue for an unknown model or n < 1.
extern "C" int altair_finish(
    const float* scene, const float* rim, unsigned int seed0,
    unsigned int seed1, int max_iters, int model, int exact_rim, long long n,
    const float* px, const float* py, const float* pz, const float* dx,
    const float* dy, const float* dz, const float* prevx, const float* prevy,
    const float* prevz, const int* status_in, const int* bounces_in,
    const unsigned char* in_gap, int* status, float* lastx, float* lasty,
    float* lastz, float* segx, float* segy, float* segz, float* dirx,
    float* diry, float* dirz, int* bounces, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const State in{px,    py,    pz,        dx,         dy,    dz,
                 prevx, prevy, prevz, status_in, bounces_in, in_gap};
  const Outputs out{status, lastx, lasty, lastz, segx, segy,
                    segz,   dirx,  diry,  dirz,  bounces};
  const dim3 block(256);
  const dim3 grid(static_cast<unsigned int>((n + 255) / 256));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool exact = exact_rim != 0;
  switch (model) {
    case LAMBERTIAN:
      launch<LAMBERTIAN>(exact, grid, block, s, scene, rim, seed0, seed1,
                         max_iters, n, in, out);
      break;
    case SPECULAR:
      launch<SPECULAR>(exact, grid, block, s, scene, rim, seed0, seed1,
                       max_iters, n, in, out);
      break;
    case MIXED_BRDF:
      launch<MIXED_BRDF>(exact, grid, block, s, scene, rim, seed0, seed1,
                         max_iters, n, in, out);
      break;
    case COS_N_LOBE:
      launch<COS_N_LOBE>(exact, grid, block, s, scene, rim, seed0, seed1,
                         max_iters, n, in, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
