// K2-K4, K6, K7 and the dot-free K3'/K4'/K6'/K7': the fused fine-level
// kernels of the GAMG V-cycle, on the padded-resident layout.  They replace
// the modes mvdot, descent(_rr), ascent(_rz), descent1(_rr) and
// ascent1(_rz) of tpusparse/kernels/fused7.py::fused7_call (Pallas body
// _kernel), with the math of fused7_xla for those modes.
//
// Bound on the H100: bytes.  Each mode is a chain of two or three stencil
// applies with elementwise epilogues.  The TPU kernel chains them inside
// one HBM pass per launch by temporal blocking over FACE = 3 halo planes:
// descent_rr reads b and diag once and writes x1 and s (4 field passes),
// ascent_rz reads t, b, x1, diag and writes x4 (5 passes).
//
// Design of this first port: a short fixed sequence of launches per mode,
// each fusing ONE stencil apply with its elementwise epilogue, with the
// intermediates in device memory (the wrapper allocates them).  That costs
// descent 10 field passes (3 launches), ascent 14 (3 launches), descent1 9
// (2 launches) and ascent1 9 (2 launches); temporal blocking into one pass
// is later work.  Every chained step writes zero outside the domain (the
// fused7 mask_dom), so the next step's stencil sees the Neumann
// dropped-entry boundary.
//
// The CG dot of a mode is a template flag of the kernel that forms it: with
// DOT the kernel writes one partial per block (block_partial) and the
// wrapper sums the partials in a fixed order, as the JAX wrapper sums its
// per-slab partials outside the kernel (fused7.py:928); without it the
// epilogue is compiled out (the dot-free modes of the non-CG solvers).  An
// entry point takes partials == nullptr for the dot-free form.
#include "star7.cuh"

using namespace tps;

// K2 mvdot: y = A x and partials of <x, A x> (the CG alpha denominator).
__global__ void __launch_bounds__(BLOCK)
mvdot_kernel(const float* __restrict__ x, const float* __restrict__ diag,
             float* __restrict__ y, float* __restrict__ partials, Geom g,
             Legs a, int pinned) {
  const long long q = thread_cell();
  int k, j, i;
  float out = 0.0f, dot = 0.0f;
  if (cell(g, q, k, j, i)) {
    out = star(Field{x}, diag[q] * x[q], q, k, j, i, g, a, pinned);
    dot = x[q] * out;
  }
  if (q < g.total) y[q] = out;
  block_partial(dot, partials);
}

// K3 step 1, both pre-smoothing steps from a zero guess:
// u = (s0 b) D^-1;  x1 = u + ad u + g D^-1 (b - A u);  partials of <b, b>.
template <bool DOT>
__global__ void __launch_bounds__(BLOCK)
pre_smooth_kernel(const float* __restrict__ b, const float* __restrict__ diag,
                  float* __restrict__ x1, float* __restrict__ partials,
                  Geom g, Legs a, float s0, float ad, float gg, int pinned) {
  const long long q = thread_cell();
  int k, j, i;
  float out = 0.0f, dot = 0.0f;
  if (cell(g, q, k, j, i)) {
    const DinvField u{b, diag, s0};
    const float uq = u(q);
    const float w = star(u, diag[q] * uq, q, k, j, i, g, a, pinned);
    out = uq + ad * uq + gg * ((1.0f / diag[q]) * (b[q] - w));
    dot = b[q] * b[q];
  }
  if (q < g.total) x1[q] = out;
  if constexpr (DOT) block_partial(dot, partials);
}

// K6 step 1, one pre-smoothing sweep from a zero guess and the residual:
// x1 = g D^-1 b;  r = b - A x1;  partials of <b, b>.  x1 is formed on the
// fly wherever the stencil reads it.
template <bool DOT>
__global__ void __launch_bounds__(BLOCK)
pre_smooth1_kernel(const float* __restrict__ b,
                   const float* __restrict__ diag, float* __restrict__ x1,
                   float* __restrict__ r, float* __restrict__ partials,
                   Geom g, Legs a, float gg, int pinned) {
  const long long q = thread_cell();
  int k, j, i;
  float xo = 0.0f, ro = 0.0f, dot = 0.0f;
  if (cell(g, q, k, j, i)) {
    const ScaledDinvField u{b, diag, gg};
    xo = u(q);
    ro = b[q] - star(u, diag[q] * xo, q, k, j, i, g, a, pinned);
    dot = b[q] * b[q];
  }
  if (q < g.total) {
    x1[q] = xo;
    r[q] = ro;
  }
  if constexpr (DOT) block_partial(dot, partials);
}

// K3 step 2, the residual: r = b - A x1.
__global__ void __launch_bounds__(BLOCK)
residual_kernel(const float* __restrict__ b, const float* __restrict__ x,
                const float* __restrict__ diag, float* __restrict__ r, Geom g,
                Legs a, int pinned) {
  const long long q = thread_cell();
  int k, j, i;
  if (q >= g.total) return;
  float out = 0.0f;
  if (cell(g, q, k, j, i))
    out = b[q] - star(Field{x}, diag[q] * x[q], q, k, j, i, g, a, pinned);
  r[q] = out;
}

// K3 step 3 and K6 step 2, the P^T smoothing pass: s = r - gw A (D^-1 r).
__global__ void __launch_bounds__(BLOCK)
restrict_smooth_kernel(const float* __restrict__ r,
                       const float* __restrict__ diag, float* __restrict__ s,
                       Geom g, Legs a, float gw, int pinned) {
  const long long q = thread_cell();
  int k, j, i;
  if (q >= g.total) return;
  float out = 0.0f;
  if (cell(g, q, k, j, i)) {
    const DinvField v{r, diag, 1.0f};
    out = r[q] - gw * star(v, diag[q] * v(q), q, k, j, i, g, a, pinned);
  }
  s[q] = out;
}

// K4 and K7 step 1, P smoothing plus the coarse correction:
// x2 = x1 + t - gw D^-1 (A t).
__global__ void __launch_bounds__(BLOCK)
prolong_add_kernel(const float* __restrict__ t, const float* __restrict__ x1,
                   const float* __restrict__ diag, float* __restrict__ x2,
                   Geom g, Legs a, float gw, int pinned) {
  const long long q = thread_cell();
  int k, j, i;
  if (q >= g.total) return;
  float out = 0.0f;
  if (cell(g, q, k, j, i)) {
    const float w = star(Field{t}, diag[q] * t[q], q, k, j, i, g, a, pinned);
    out = x1[q] + t[q] - gw * ((1.0f / diag[q]) * w);
  }
  x2[q] = out;
}

// K4 step 2, post-smoothing step 1: d = g D^-1 (b - A x2);  x3 = x2 + d.
__global__ void __launch_bounds__(BLOCK)
post_smooth1_kernel(const float* __restrict__ b, const float* __restrict__ x2,
                    const float* __restrict__ diag, float* __restrict__ d,
                    float* __restrict__ x3, Geom g, Legs a, float gg,
                    int pinned) {
  const long long q = thread_cell();
  int k, j, i;
  if (q >= g.total) return;
  float dq = 0.0f, out = 0.0f;
  if (cell(g, q, k, j, i)) {
    const float w = star(Field{x2}, diag[q] * x2[q], q, k, j, i, g, a, pinned);
    dq = gg * ((1.0f / diag[q]) * (b[q] - w));
    out = x2[q] + dq;
  }
  d[q] = dq;
  x3[q] = out;
}

// K4 step 3, post-smoothing step 2:
// x4 = x3 + ad d + g2 D^-1 (b - A x3);  partials of <b, x4>.
template <bool DOT>
__global__ void __launch_bounds__(BLOCK)
post_smooth2_kernel(const float* __restrict__ b, const float* __restrict__ x3,
                    const float* __restrict__ d,
                    const float* __restrict__ diag, float* __restrict__ x4,
                    float* __restrict__ partials, Geom g, Legs a, float ad,
                    float g2, int pinned) {
  const long long q = thread_cell();
  int k, j, i;
  float out = 0.0f, dot = 0.0f;
  if (cell(g, q, k, j, i)) {
    const float w = star(Field{x3}, diag[q] * x3[q], q, k, j, i, g, a, pinned);
    out = x3[q] + ad * d[q] + g2 * ((1.0f / diag[q]) * (b[q] - w));
    dot = b[q] * out;
  }
  if (q < g.total) x4[q] = out;
  if constexpr (DOT) block_partial(dot, partials);
}

// K7 step 2, the one post-smoothing sweep:
// x3 = x2 + g D^-1 (b - A x2);  partials of <b, x3>.
template <bool DOT>
__global__ void __launch_bounds__(BLOCK)
rich_kernel(const float* __restrict__ b, const float* __restrict__ x2,
            const float* __restrict__ diag, float* __restrict__ x3,
            float* __restrict__ partials, Geom g, Legs a, float gg,
            int pinned) {
  const long long q = thread_cell();
  int k, j, i;
  float out = 0.0f, dot = 0.0f;
  if (cell(g, q, k, j, i)) {
    const float w = star(Field{x2}, diag[q] * x2[q], q, k, j, i, g, a, pinned);
    out = x2[q] + gg * ((1.0f / diag[q]) * (b[q] - w));
    dot = b[q] * out;
  }
  if (q < g.total) x3[q] = out;
  if constexpr (DOT) block_partial(dot, partials);
}

extern "C" int tps_mvdot(const float* x, const float* diag, float* y,
                         float* partials, int nz, int ny, int nx, int nxp,
                         float cx, float cy, float cz, int pinned,
                         void* stream) {
  const Geom g = make_geom(nz, ny, nx, nxp);
  mvdot_kernel<<<grid_blocks(g), BLOCK, 0, (cudaStream_t)stream>>>(
      x, diag, y, partials, g, Legs{cx, cy, cz}, pinned);
  return (int)cudaGetLastError();
}

// Each launch sequence returns at its first launch error.
#define TPS_CHECK()                              \
  do {                                           \
    const cudaError_t err = cudaGetLastError();  \
    if (err != cudaSuccess) return (int)err;     \
  } while (0)

template <bool DOT>
static int descent(const float* b, const float* diag, float* x1, float* r,
                   float* s, float* partials, const Geom& g, Legs a,
                   float s0, float ad, float gg, float gw, int pinned,
                   cudaStream_t st) {
  pre_smooth_kernel<DOT><<<grid_blocks(g), BLOCK, 0, st>>>(
      b, diag, x1, partials, g, a, s0, ad, gg, pinned);
  TPS_CHECK();
  residual_kernel<<<grid_blocks(g), BLOCK, 0, st>>>(b, x1, diag, r, g, a,
                                                    pinned);
  TPS_CHECK();
  restrict_smooth_kernel<<<grid_blocks(g), BLOCK, 0, st>>>(r, diag, s, g, a,
                                                           gw, pinned);
  return (int)cudaGetLastError();
}

// K3 (descent_rr) with partials, K3' (descent) with partials == nullptr.
extern "C" int tps_descent(const float* b, const float* diag, float* x1,
                           float* r, float* s, float* partials, int nz,
                           int ny, int nx, int nxp, float cx, float cy,
                           float cz, float s0, float ad, float gg, float gw,
                           int pinned, void* stream) {
  const Geom g = make_geom(nz, ny, nx, nxp);
  const Legs a{cx, cy, cz};
  const cudaStream_t st = (cudaStream_t)stream;
  return partials ? descent<true>(b, diag, x1, r, s, partials, g, a, s0, ad,
                                  gg, gw, pinned, st)
                  : descent<false>(b, diag, x1, r, s, partials, g, a, s0, ad,
                                   gg, gw, pinned, st);
}

template <bool DOT>
static int ascent(const float* t, const float* b, const float* x1,
                  const float* diag, float* x2, float* d, float* x3,
                  float* x4, float* partials, const Geom& g, Legs a, float gg,
                  float ad, float g2, float gw, int pinned, cudaStream_t st) {
  prolong_add_kernel<<<grid_blocks(g), BLOCK, 0, st>>>(t, x1, diag, x2, g, a,
                                                       gw, pinned);
  TPS_CHECK();
  post_smooth1_kernel<<<grid_blocks(g), BLOCK, 0, st>>>(b, x2, diag, d, x3, g,
                                                        a, gg, pinned);
  TPS_CHECK();
  post_smooth2_kernel<DOT><<<grid_blocks(g), BLOCK, 0, st>>>(
      b, x3, d, diag, x4, partials, g, a, ad, g2, pinned);
  return (int)cudaGetLastError();
}

// K4 (ascent_rz) with partials, K4' (ascent) with partials == nullptr.
extern "C" int tps_ascent(const float* t, const float* b, const float* x1,
                          const float* diag, float* x2, float* d, float* x3,
                          float* x4, float* partials, int nz, int ny, int nx,
                          int nxp, float cx, float cy, float cz, float gg,
                          float ad, float g2, float gw, int pinned,
                          void* stream) {
  const Geom g = make_geom(nz, ny, nx, nxp);
  const Legs a{cx, cy, cz};
  const cudaStream_t st = (cudaStream_t)stream;
  return partials ? ascent<true>(t, b, x1, diag, x2, d, x3, x4, partials, g,
                                 a, gg, ad, g2, gw, pinned, st)
                  : ascent<false>(t, b, x1, diag, x2, d, x3, x4, partials, g,
                                  a, gg, ad, g2, gw, pinned, st);
}

template <bool DOT>
static int descent1(const float* b, const float* diag, float* x1, float* r,
                    float* s, float* partials, const Geom& g, Legs a,
                    float gg, float gw, int pinned, cudaStream_t st) {
  pre_smooth1_kernel<DOT><<<grid_blocks(g), BLOCK, 0, st>>>(
      b, diag, x1, r, partials, g, a, gg, pinned);
  TPS_CHECK();
  restrict_smooth_kernel<<<grid_blocks(g), BLOCK, 0, st>>>(r, diag, s, g, a,
                                                           gw, pinned);
  return (int)cudaGetLastError();
}

// K6 (descent1_rr) with partials, K6' (descent1) with partials == nullptr.
extern "C" int tps_descent1(const float* b, const float* diag, float* x1,
                            float* r, float* s, float* partials, int nz,
                            int ny, int nx, int nxp, float cx, float cy,
                            float cz, float gg, float gw, int pinned,
                            void* stream) {
  const Geom g = make_geom(nz, ny, nx, nxp);
  const Legs a{cx, cy, cz};
  const cudaStream_t st = (cudaStream_t)stream;
  return partials ? descent1<true>(b, diag, x1, r, s, partials, g, a, gg, gw,
                                   pinned, st)
                  : descent1<false>(b, diag, x1, r, s, partials, g, a, gg, gw,
                                    pinned, st);
}

template <bool DOT>
static int ascent1(const float* t, const float* b, const float* x1,
                   const float* diag, float* x2, float* x3, float* partials,
                   const Geom& g, Legs a, float gg, float gw, int pinned,
                   cudaStream_t st) {
  prolong_add_kernel<<<grid_blocks(g), BLOCK, 0, st>>>(t, x1, diag, x2, g, a,
                                                       gw, pinned);
  TPS_CHECK();
  rich_kernel<DOT><<<grid_blocks(g), BLOCK, 0, st>>>(b, x2, diag, x3,
                                                     partials, g, a, gg,
                                                     pinned);
  return (int)cudaGetLastError();
}

// K7 (ascent1_rz) with partials, K7' (ascent1) with partials == nullptr.
extern "C" int tps_ascent1(const float* t, const float* b, const float* x1,
                           const float* diag, float* x2, float* x3,
                           float* partials, int nz, int ny, int nx, int nxp,
                           float cx, float cy, float cz, float gg, float gw,
                           int pinned, void* stream) {
  const Geom g = make_geom(nz, ny, nx, nxp);
  const Legs a{cx, cy, cz};
  const cudaStream_t st = (cudaStream_t)stream;
  return partials ? ascent1<true>(t, b, x1, diag, x2, x3, partials, g, a, gg,
                                  gw, pinned, st)
                  : ascent1<false>(t, b, x1, diag, x2, x3, partials, g, a, gg,
                                   gw, pinned, st);
}
