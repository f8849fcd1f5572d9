// K1: the level-0 7-point star apply y = A x on the padded-resident layout.
//
// Replaces tpusparse/kernels/stencil7.py::star7_mv_padded (Pallas body
// _kernel), which the setup runs for the rho power iterations and the
// 27-comb Galerkin probing, and the solve for each inner CG's r0 = b - A x0.
//
// Bound on the H100: bytes.  The ideal is one read of x and diag and one
// write of y (12 bytes per cell, ~330 MB at 300^3, ~0.1 ms at 3.35 TB/s);
// 13 flops per cell are nothing against that.  Design: one thread per
// padded cell, neighbouring threads on neighbouring x addresses so every
// load and store coalesces; the six neighbour reads of x hit in L1/L2
// (a z-plane of a 300^3 field is 360 KB, so the k-1 / k+1 planes of a
// block's rows are still cached when it runs).  Register-resident z
// marching and shared-memory tiles are later work.
//
// K1p, the star on the plain (nz, ny, nx) layout, replaces
// tpusparse/kernels/stencil7.py::star7_mv_pallas, which pads x and diag into
// the resident layout, runs star7_mv_padded and crops y: 4 extra field
// passes.  Here the star masks every neighbour read by the domain bounds, so
// the plain field is a geometry with no face planes and nxp = nx, launched
// directly: one read of x and diag, one write of y (3 passes, ~324 MB at
// 300^3, ~0.097 ms at 3.35 TB/s).
//
// K1p over a stack, y[c] = A x[c] for the k columns of a (k, nz, ny, nx)
// field (KSP.mat_solve's block apply; the JAX package vmaps the star's XLA
// form instead), is one launch for the whole stack: one thread a cell that
// reads diag once and loops over the columns.  Bound: (2k + 1) n 4 bytes
// (diag once, x and y once a column).  The loop is not unrolled: unrolled,
// the launch took 0.52 ms at 300^3 with k = 4, rolled 0.44 (H100, 700 W).
// Each column is bit for bit one K1p launch: both kernels apply star_rn,
// the star with every rounding spelled out (two kernels would each be free
// to contract its sums into FMAs their own way, and did: the unpinned
// columns differed from K1p by an ulp).  K1p stays a kernel without the
// loop, which cost it 7% (0.18 against 0.17 ms) as the k = 1 launch.
#include "star7.cuh"

using namespace tps;

__global__ void __launch_bounds__(BLOCK)
star7_mv_kernel(const float* __restrict__ x, const float* __restrict__ diag,
                float* __restrict__ y, Geom g, Legs a, int pinned) {
  const long long q = thread_cell();
  int k, j, i;
  if (q >= g.total) return;
  float out = 0.0f;
  if (cell(g, q, k, j, i))
    out = star(Field{x}, diag[q] * x[q], q, k, j, i, g, a, pinned);
  y[q] = out;
}

extern "C" int tps_star7_mv(const float* x, const float* diag, float* y,
                            int nz, int ny, int nx, int nxp, float cx,
                            float cy, float cz, int pinned, void* stream) {
  const Geom g = make_geom(nz, ny, nx, nxp);
  star7_mv_kernel<<<grid_blocks(g), BLOCK, 0, (cudaStream_t)stream>>>(
      x, diag, y, g, Legs{cx, cy, cz}, pinned);
  return (int)cudaGetLastError();
}

// (A u)[q] on the plain layout, as star() in star7.cuh but with every
// rounding explicit (no contraction left to the compiler), so that K1p and
// its stacked form compute it bit for bit alike.  Every cell of the plain
// layout is in the domain.
__device__ __forceinline__ float star_rn(const float* __restrict__ u, float center, long long q,
                                         int k, int j, int i, const Geom& g, Legs a, int pinned) {
  float xm = i > 0 ? u[q - 1] : 0.0f;
  float xp = i < g.nx - 1 ? u[q + 1] : 0.0f;
  float ym = j > 0 ? u[q - g.nxp] : 0.0f;
  float yp = j < g.ny - 1 ? u[q + g.nxp] : 0.0f;
  float zm = k > 0 ? u[q - g.plane] : 0.0f;
  float zp = k < g.nz - 1 ? u[q + g.plane] : 0.0f;
  if (pinned) {
    if (k == 0 && j == 0 && i == 0) return center;
    if (k == 0 && j == 0 && i == 1) xm = 0.0f;
    if (k == 0 && j == 1 && i == 0) ym = 0.0f;
    if (k == 1 && j == 0 && i == 0) zm = 0.0f;
  }
  const float s = __fmaf_rn(a.cx, __fadd_rn(xp, xm), center);
  return __fmaf_rn(a.cz, __fadd_rn(zp, zm), __fmaf_rn(a.cy, __fadd_rn(yp, ym), s));
}

__global__ void __launch_bounds__(BLOCK)
star7_mv_plain_kernel(const float* __restrict__ x, const float* __restrict__ diag,
                      float* __restrict__ y, Geom g, Legs a, int pinned) {
  const long long q = thread_cell();
  int k, j, i;
  if (q >= g.total) return;
  cell(g, q, k, j, i);
  y[q] = star_rn(x, __fmul_rn(diag[q], x[q]), q, k, j, i, g, a, pinned);
}

__global__ void __launch_bounds__(BLOCK)
star7_mv_batched_kernel(const float* __restrict__ x, const float* __restrict__ diag,
                        float* __restrict__ y, Geom g, Legs a, int pinned, int nk) {
  const long long q = thread_cell();
  int k, j, i;
  if (q >= g.total) return;
  cell(g, q, k, j, i);
  const float d = diag[q];
#pragma unroll 1
  for (int c = 0; c < nk; ++c) {
    const long long o = (long long)c * g.total;
    y[o + q] = star_rn(x + o, __fmul_rn(d, x[o + q]), q, k, j, i, g, a, pinned);
  }
}

// K1p: y = A x for each of the k plain (nz, ny, nx) fields of x; k = 1 runs
// the kernel without the column loop.
extern "C" int tps_star7_mv_plain(const float* x, const float* diag, float* y,
                                  int nz, int ny, int nx, int k, float cx,
                                  float cy, float cz, int pinned, void* stream) {
  const Geom g = make_geom(nz, ny, nx, nx, 0);
  if (k == 1)
    star7_mv_plain_kernel<<<grid_blocks(g), BLOCK, 0, (cudaStream_t)stream>>>(
        x, diag, y, g, Legs{cx, cy, cz}, pinned);
  else
    star7_mv_batched_kernel<<<grid_blocks(g), BLOCK, 0, (cudaStream_t)stream>>>(
        x, diag, y, g, Legs{cx, cy, cz}, pinned, k);
  return (int)cudaGetLastError();
}

extern "C" const char* tps_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int tps_block_size() { return BLOCK; }
