// Plucker scorer kernel for NVIDIA Hopper (sm_90a): every (exit row,
// detector position) pair's disk test and the hit count per position, in
// one launch.
//
// Replaces no Pallas kernel.  The JAX package scores with an XLA fusion of
// an [N, 21] x [21, P] float32 product and its epilogue; the port's plain
// version (core/score.py::_hits_block_mxu over position chunks) runs that
// as a matmul plus six elementwise passes over an [N, P_chunk] block in
// device memory.  Here the pair values live only in registers: each
// thread holds the weights of POS_PER_THREAD positions, the block stages
// a tile of rows in shared memory, and a thread's hits go into its own
// registers, one count per position, added to the output once a block.
//
// The test, per pair (row r, position p), that of _hits_block_mxu:
//   s  = Phi(r) . W_p   the 21-term upper triangle of the 6x6 Plucker
//                       form, Phi the products of r6 = (E_rel x D, D)
//   dn = D . n_p
//   hit = s <= 0  and  |dn| >= PARALLEL_EPS  and  the row is valid.
// A row is valid when its index is below the row count (*n_rows when
// given, else n) and rowmask holds.  Hits are rare (a ray meets ~1.6% of
// the grid's disks), so the guard dn runs only where some position of the
// thread has s <= 0.
//
// What bounds it on this card: issue of float32 instructions on the CUDA
// cores.  A pair costs 21 FMAs and a compare; the staged row's 6 16-byte
// shared loads (broadcast: a warp reads one row) are shared by the
// thread's positions.  Bytes are negligible: each row is read once a
// position tile, each position once a block.  No tensor cores: TF32 and
// bf16 inputs give spurious hits at the disk edge (core/score.py::
// _check_matmul_precision), so the form runs in IEEE float32 with explicit
// __fmaf_rn (the build's -fmad=false forbids contraction elsewhere).
//
// Grid: x the position tiles, y the row splits.  Every split takes an equal
// share of the row count, read on the device, so a count known only there
// (the compacting caller's valid exits) costs no host sync, and the
// splits are chosen from the card's resident blocks so the grid fills
// whole waves.  The position tail is masked here: a padded position gets
// weights with s = |D|^2 > 0 and writes nothing.

#include <cuda_runtime.h>

#include <algorithm>

#ifndef ALTAIR_SCORE_POS_PER_THREAD
#define ALTAIR_SCORE_POS_PER_THREAD 4
#endif
#ifndef ALTAIR_SCORE_THREADS
#define ALTAIR_SCORE_THREADS 128
#endif
#ifndef ALTAIR_SCORE_MIN_BLOCKS
#define ALTAIR_SCORE_MIN_BLOCKS 3
#endif

namespace {

constexpr int PT = ALTAIR_SCORE_POS_PER_THREAD;  // positions a thread
constexpr int THREADS = ALTAIR_SCORE_THREADS;    // threads a block
constexpr int WARPS = THREADS / 32;
constexpr int TILE_POS = THREADS * PT;           // positions a block
constexpr int TILE_ROWS = THREADS;               // rows staged a round
constexpr int NF = 21;                           // Plucker features
constexpr float PARALLEL_EPS = 1e-10f;           // core/score.py
constexpr unsigned FULL = 0xffffffffu;
static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps");
static_assert(PT >= 1, "a position a thread at least");

// A staged row: Phi[0..20], then D.
struct __align__(16) Row {
  float4 q[6];
};

__global__ void __launch_bounds__(THREADS, ALTAIR_SCORE_MIN_BLOCKS)
    score_kernel(const float* __restrict__ e_rel,
                 const float* __restrict__ dir,
                 const unsigned char* __restrict__ rowmask,
                 const int* __restrict__ n_rows, long long n,
                 const float* __restrict__ w, const float* __restrict__ nrm,
                 int p, int* __restrict__ counts) {
  __shared__ Row rows[TILE_ROWS];
  __shared__ int warp_rows[WARPS];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  long long total = n;
  if (n_rows != nullptr) {
    const long long given = *n_rows;
    total = given < 0 ? 0 : (given < n ? given : n);
  }
  const long long r_begin = total * blockIdx.y / gridDim.y;
  const long long r_end = total * (blockIdx.y + 1) / gridDim.y;
  if (r_begin >= r_end) return;  // the same for the whole block

  // this thread's positions: pos0 + j * THREADS
  const int pos0 = blockIdx.x * TILE_POS + tid;
  float wt[PT][NF];
  float nx[PT], ny[PT], nz[PT];
  int cnt[PT];
#pragma unroll
  for (int j = 0; j < PT; ++j) {
    const int pj = pos0 + j * THREADS;
    cnt[j] = 0;
    if (pj < p) {
#pragma unroll
      for (int k = 0; k < NF; ++k)
        wt[j][k] = w[static_cast<long long>(pj) * NF + k];
      nx[j] = nrm[3LL * pj];
      ny[j] = nrm[3LL * pj + 1];
      nz[j] = nrm[3LL * pj + 2];
    } else {
      // s = dx^2 + dy^2 + dz^2 (features 15, 18, 20) = 1 > 0: never a hit
#pragma unroll
      for (int k = 0; k < NF; ++k)
        wt[j][k] = (k == 15 || k == 18 || k == 20) ? 1.0f : 0.0f;
      nx[j] = 0.0f;
      ny[j] = 0.0f;
      nz[j] = 1.0f;
    }
  }

  for (long long r0 = r_begin; r0 < r_end; r0 += TILE_ROWS) {
    // stage this round's valid rows, packed at the front of `rows`
    const long long r = r0 + tid;
    const bool ok = r < r_end && rowmask[r] != 0;
    float f[24];
    if (ok) {
      const float ex = e_rel[3 * r], ey = e_rel[3 * r + 1],
                  ez = e_rel[3 * r + 2];
      const float dx = dir[3 * r], dy = dir[3 * r + 1], dz = dir[3 * r + 2];
      // r6 = (e x d, d), torch.linalg.cross's component formulas
      const float r6[6] = {ey * dz - ez * dy, ez * dx - ex * dz,
                           ex * dy - ey * dx, dx, dy, dz};
      int k = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int b = a; b < 6; ++b) f[k++] = r6[a] * r6[b];
      f[21] = dx;
      f[22] = dy;
      f[23] = dz;
    }
    const unsigned valid = __ballot_sync(FULL, ok);
    if (lane == 0) warp_rows[warp] = __popc(valid);
    __syncthreads();
    int base = 0, m = 0;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
      const int c = warp_rows[i];
      base += i < warp ? c : 0;
      m += c;
    }
    if (ok) {
      float4* q = rows[base + __popc(valid & ((1u << lane) - 1u))].q;
#pragma unroll
      for (int i = 0; i < 6; ++i)
        q[i] = make_float4(f[4 * i], f[4 * i + 1], f[4 * i + 2],
                           f[4 * i + 3]);
    }
    __syncthreads();

#pragma unroll 2
    for (int i = 0; i < m; ++i) {
      const float4* q = rows[i].q;
      float s[PT];
      float4 v = q[0];
#pragma unroll
      for (int j = 0; j < PT; ++j) {
        s[j] = v.x * wt[j][0];
        s[j] = __fmaf_rn(v.y, wt[j][1], s[j]);
        s[j] = __fmaf_rn(v.z, wt[j][2], s[j]);
        s[j] = __fmaf_rn(v.w, wt[j][3], s[j]);
      }
#pragma unroll
      for (int c = 1; c < 5; ++c) {
        v = q[c];
#pragma unroll
        for (int j = 0; j < PT; ++j) {
          s[j] = __fmaf_rn(v.x, wt[j][4 * c], s[j]);
          s[j] = __fmaf_rn(v.y, wt[j][4 * c + 1], s[j]);
          s[j] = __fmaf_rn(v.z, wt[j][4 * c + 2], s[j]);
          s[j] = __fmaf_rn(v.w, wt[j][4 * c + 3], s[j]);
        }
      }
      v = q[5];
      bool any = false;
#pragma unroll
      for (int j = 0; j < PT; ++j) {
        s[j] = __fmaf_rn(v.x, wt[j][20], s[j]);
        any |= s[j] <= 0.0f;
      }
      if (any) {
#pragma unroll
        for (int j = 0; j < PT; ++j) {
          const float dn =
              __fmaf_rn(v.w, nz[j], __fmaf_rn(v.z, ny[j], v.y * nx[j]));
          cnt[j] += (s[j] <= 0.0f) & (fabsf(dn) >= PARALLEL_EPS);
        }
      }
    }
    __syncthreads();  // the next round overwrites `rows`
  }

#pragma unroll
  for (int j = 0; j < PT; ++j) {
    const int pj = pos0 + j * THREADS;
    if (pj < p && cnt[j] != 0) atomicAdd(&counts[pj], cnt[j]);
  }
}

}  // namespace

// Plain C entry, bound with ctypes.  Every pointer is device memory except
// `stream` (a cudaStream_t): e_rel and dir [n, 3] float32, rowmask [n]
// bool, n_rows one int32 (null: n), w [p, 21] and nrm [p, 3] float32, and
// counts [p] int32, which the launch adds into (the caller zeroes it).
// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for
// n < 1 or p < 1.
extern "C" int altair_score(const float* e_rel, const float* dir,
                            const unsigned char* rowmask, const int* n_rows,
                            long long n, const float* w, const float* nrm,
                            int p, int* counts, void* stream) {
  if (n < 1 || p < 1) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, score_kernel,
                                                        THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (p + TILE_POS - 1) / TILE_POS;
  const long long resident = static_cast<long long>(sms) * std::max(per_sm, 1);
  const long long row_tiles = (n + TILE_ROWS - 1) / TILE_ROWS;
  // splits whose blocks fill their waves best, from one wave's worth up
  // to four; never more splits than row tiles
  const long long lo = std::max(1LL, resident / tiles);
  long long splits = 1;
  double best = -1.0;
  for (long long s = lo; s <= 4 * lo; ++s) {
    const long long blocks = tiles * s;
    const double fill =
        static_cast<double>(blocks) /
        static_cast<double>((blocks + resident - 1) / resident * resident);
    if (fill > best + 1e-9) {
      best = fill;
      splits = s;
    }
  }
  splits = std::min({splits, row_tiles, 65535LL});
  const dim3 grid(static_cast<unsigned int>(tiles),
                  static_cast<unsigned int>(splits));
  score_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      e_rel, dir, rowmask, n_rows, n, w, nrm, p, counts);
  return static_cast<int>(cudaGetLastError());
}
