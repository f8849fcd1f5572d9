// Shared device code of the 7-point star kernels (stencil7.cu, fused7.cu).
//
// Layout: the port's padded-resident field (tpusparse_torch/kernels/
// stencil7.py::padded_shape), float32, C order, shape (nz + 2*FACE, ny, nxp):
// FACE zero planes on each z face, no y padding, x rounded up to a multiple
// of 4.  One thread owns one padded cell (but in K6/K7, which march tiles
// through shared memory: fused7.cu); cells outside the domain are written
// as zero, which keeps the layout's pad-zero invariant.  The plain
// (nz, ny, nx) layout is the same geometry with no face planes and
// nxp = nx (make_geom's face = 0).
//
// Neighbour reads are masked by the domain bounds explicitly (the dropped
// entries of the Neumann boundary, reference src/helper.cpp:229-233), so no
// kernel relies on what a pad cell holds.
#pragma once

#include <cuda_runtime.h>

namespace tps {

constexpr int FACE = 3;
constexpr int BLOCK = 256;

struct Geom {
  int nz, ny, nx, nxp;  // domain extents and padded row length
  int face;             // zero planes on each z face: FACE, or 0 (plain)
  long long plane;      // ny * nxp
  long long total;      // (nz + 2*face) * plane
};

inline Geom make_geom(int nz, int ny, int nx, int nxp, int face = FACE) {
  Geom g{nz, ny, nx, nxp, face, (long long)ny * nxp, 0};
  g.total = (long long)(nz + 2 * face) * g.plane;
  return g;
}

inline unsigned grid_blocks(const Geom& g) {
  return (unsigned)((g.total + BLOCK - 1) / BLOCK);
}

// off-diagonal coefficients of the star
struct Legs {
  float cx, cy, cz;
};

// Domain coordinates (k, j, i) of padded cell q; true when q is in the domain.
__device__ __forceinline__ bool cell(const Geom& g, long long q, int& k,
                                     int& j, int& i) {
  const long long kp = q / g.plane;
  const int rem = (int)(q - kp * g.plane);
  j = rem / g.nxp;
  i = rem - j * g.nxp;
  k = (int)kp - g.face;
  return q < g.total && k >= 0 && k < g.nz && i < g.nx;
}

// Stencil input read straight from a field.
struct Field {
  const float* __restrict__ p;
  __device__ __forceinline__ float operator()(long long q) const { return p[q]; }
};

// Stencil input (s * p) * D^-1, formed on the fly at each read: the
// pre-smoother's u = (s0 * b) * D^-1 and the P^T-smoothing D^-1 r.
struct DinvField {
  const float* __restrict__ p;
  const float* __restrict__ d;
  float s;
  __device__ __forceinline__ float operator()(long long q) const {
    return (s * p[q]) * (1.0f / d[q]);
  }
};

// (A u)[q] for in-domain cell (k, j, i) given the diagonal term `center`.
// Pinned origin (MatZeroRowsColumns, reference src/helper.cpp:274): the
// three cells that read u[0,0,0] as a neighbour drop that read, and the
// origin's row keeps only its diagonal term.
template <class U>
__device__ __forceinline__ float star(const U& u, float center, long long q,
                                      int k, int j, int i, const Geom& g,
                                      Legs a, int pinned) {
  float xm = i > 0 ? u(q - 1) : 0.0f;
  float xp = i < g.nx - 1 ? u(q + 1) : 0.0f;
  float ym = j > 0 ? u(q - g.nxp) : 0.0f;
  float yp = j < g.ny - 1 ? u(q + g.nxp) : 0.0f;
  float zm = k > 0 ? u(q - g.plane) : 0.0f;
  float zp = k < g.nz - 1 ? u(q + g.plane) : 0.0f;
  if (pinned) {
    if (k == 0 && j == 0 && i == 0) return center;
    if (k == 0 && j == 0 && i == 1) xm = 0.0f;
    if (k == 0 && j == 1 && i == 0) ym = 0.0f;
    if (k == 1 && j == 0 && i == 0) zm = 0.0f;
  }
  return center + a.cx * (xp + xm) + a.cy * (yp + ym) + a.cz * (zp + zm);
}

// One partial sum per block of THREADS threads into partials[slot]
// (block_partial: the block's index), in a fixed order and without
// atomics, so a dot repeats bit for bit from run to run.  Every thread of
// the block must call it.
template <int THREADS = BLOCK>
__device__ __forceinline__ void block_partial_at(float v, float* partials,
                                                 unsigned slot) {
  static_assert(THREADS % 32 == 0 && THREADS <= 32 * 32, "whole warps");
  __shared__ float warp_sums[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) partials[slot] = v;
  }
}

__device__ __forceinline__ void block_partial(float v, float* partials) {
  block_partial_at(v, partials, blockIdx.x);
}

__device__ __forceinline__ long long thread_cell() {
  return (long long)blockIdx.x * BLOCK + threadIdx.x;
}

}  // namespace tps
