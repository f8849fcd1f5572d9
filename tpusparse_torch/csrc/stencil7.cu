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
// K1p, the same kernel on the plain (nz, ny, nx) layout, replaces
// tpusparse/kernels/stencil7.py::star7_mv_pallas, which pads x and diag into
// the resident layout, runs star7_mv_padded and crops y: 4 extra field
// passes.  Here star() masks every neighbour read by the domain bounds, so
// the plain field is a geometry with no face planes and nxp = nx, launched
// directly: one read of x and diag, one write of y (3 passes, ~324 MB at
// 300^3, ~0.097 ms at 3.35 TB/s).
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

// K1p: y = A x on plain (nz, ny, nx) fields.
extern "C" int tps_star7_mv_plain(const float* x, const float* diag, float* y,
                                  int nz, int ny, int nx, float cx, float cy,
                                  float cz, int pinned, void* stream) {
  const Geom g = make_geom(nz, ny, nx, nx, 0);
  star7_mv_kernel<<<grid_blocks(g), BLOCK, 0, (cudaStream_t)stream>>>(
      x, diag, y, g, Legs{cx, cy, cz}, pinned);
  return (int)cudaGetLastError();
}

extern "C" const char* tps_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int tps_block_size() { return BLOCK; }
