// K2-K4, K6-K16 and the dot-free K3'/K4'/K6'/K7': the fused7 kernels of
// the GAMG V-cycle and of the full-fusion CG body, on the padded-resident
// layout.  They replace every mode of tpusparse/kernels/fused7.py::
// fused7_call (Pallas body _kernel) but mv, which is K1 (stencil7.cu):
// mvdot, descent(_rr), ascent(_rz), descent1(_rr), ascent1(_rz), cgmv and
// descentu (the fused fine level), and residual, rich, cheb0, cheb, pre2,
// restrict and prolong (K10-K16, the single steps of the unfused padded
// V-cycle), with the math of fused7_xla for each mode.
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
// (2 launches), ascent1 9 (2 launches), cgmv 7 (1 launch, its bound) and
// descentu 12 (3 launches, against a bound of 6); temporal blocking into
// one pass is later work.  K10-K16 are one launch each at their bounds'
// pass counts: residual and rich 4, cheb0 5, cheb 6, pre2 4, restrict and
// prolong 3.  Every chained step writes zero outside the
// domain (the fused7 mask_dom), so the next step's stencil sees the
// Neumann dropped-entry boundary.
//
// K8 (cgmv) and K9 (descentu) carry the CG vector updates.  K8 is one
// launch: p' = z + beta p is formed at each of the star's seven reads, and
// x' = x + alpha_prev p rides along (4 field reads, 3 writes).  K9 is K3
// with the residual update r' = r - alpha ap formed at each read of its
// first launch, which writes r' next to x1.  Their CG scalars (beta,
// alpha_prev, alpha) are device scalars read by pointer: they come out of
// the previous launches' dots, and passing them by value would cost CG a
// host read of each per iteration.
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

// K15 (restrict), K3 step 3 and K6 step 2, the P^T smoothing pass:
// s = r - gw A_f (D^-1 r), A_f the operator with the filtered legs ``f``.
__global__ void __launch_bounds__(BLOCK)
restrict_smooth_kernel(const float* __restrict__ r,
                       const float* __restrict__ diag, float* __restrict__ s,
                       Geom g, Legs f, float gw, int pinned) {
  const long long q = thread_cell();
  int k, j, i;
  if (q >= g.total) return;
  float out = 0.0f;
  if (cell(g, q, k, j, i)) {
    const DinvField v{r, diag, 1.0f};
    out = r[q] - gw * star(v, diag[q] * v(q), q, k, j, i, g, f, pinned);
  }
  s[q] = out;
}

// The P smoothing pass with the filtered legs ``f``: K16 (prolong),
// t - gw D^-1 (A_f t); with ADD, K4 and K7 step 1, which add the coarse
// correction to the pre-smoothed x1: x2 = x1 + t - gw D^-1 (A_f t).
template <bool ADD>
__global__ void __launch_bounds__(BLOCK)
prolong_kernel(const float* __restrict__ t, const float* __restrict__ x1,
               const float* __restrict__ diag, float* __restrict__ x2,
               Geom g, Legs f, float gw, int pinned) {
  const long long q = thread_cell();
  int k, j, i;
  if (q >= g.total) return;
  float out = 0.0f;
  if (cell(g, q, k, j, i)) {
    const float w = star(Field{t}, diag[q] * t[q], q, k, j, i, g, f, pinned);
    const float base = ADD ? x1[q] + t[q] : t[q];
    out = base - gw * ((1.0f / diag[q]) * w);
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

// K8 input p' = z + beta p_old, formed at each read of the star.
struct PUpdateField {
  const float* __restrict__ z;
  const float* __restrict__ p;
  float beta;
  __device__ __forceinline__ float operator()(long long q) const {
    return z[q] + beta * p[q];
  }
};

// K8 cgmv, the CG iteration's top half: p' = z + beta p_old;  w = A p';
// x' = x + alpha_prev p_old (the deferred x update);  partials of <p', w>.
__global__ void __launch_bounds__(BLOCK)
cgmv_kernel(const float* __restrict__ z, const float* __restrict__ p,
            const float* __restrict__ x, const float* __restrict__ diag,
            const float* __restrict__ beta_p,
            const float* __restrict__ alpha_prev_p, float* __restrict__ w,
            float* __restrict__ pn, float* __restrict__ xn,
            float* __restrict__ partials, Geom g, Legs a, int pinned) {
  const float beta = *beta_p;
  const float alpha_prev = *alpha_prev_p;
  const long long q = thread_cell();
  int k, j, i;
  float wo = 0.0f, po = 0.0f, xo = 0.0f, dot = 0.0f;
  if (cell(g, q, k, j, i)) {
    const PUpdateField u{z, p, beta};
    po = u(q);
    wo = star(u, diag[q] * po, q, k, j, i, g, a, pinned);
    xo = x[q] + alpha_prev * p[q];
    dot = po * wo;
  }
  if (q < g.total) {
    w[q] = wo;
    pn[q] = po;
    xn[q] = xo;
  }
  block_partial(dot, partials);
}

// K9 input r' = r_old - alpha ap, formed at each read.
struct RUpdateField {
  const float* __restrict__ r;
  const float* __restrict__ ap;
  float alpha;
  __device__ __forceinline__ float operator()(long long q) const {
    return r[q] - alpha * ap[q];
  }
};

// K9 stencil input (s0 r') D^-1: K3's pre-smoother u on the updated residual.
struct RUpdateDinvField {
  RUpdateField r;
  const float* __restrict__ d;
  float s;
  __device__ __forceinline__ float operator()(long long q) const {
    return (s * r(q)) * (1.0f / d[q]);
  }
};

// K9 step 1, the residual update and both pre-smoothing steps:
// r' = r_old - alpha ap;  u = (s0 r') D^-1;  x1 = u + ad u + g D^-1 (r' - A u);
// partials of <r', r'>.  Steps 2 and 3 are K3's on r'.
__global__ void __launch_bounds__(BLOCK)
rupdate_pre_smooth_kernel(const float* __restrict__ r_old,
                          const float* __restrict__ ap,
                          const float* __restrict__ alpha_p,
                          const float* __restrict__ diag,
                          float* __restrict__ x1, float* __restrict__ r_new,
                          float* __restrict__ partials, Geom g, Legs a,
                          float s0, float ad, float gg, int pinned) {
  const float alpha = *alpha_p;
  const long long q = thread_cell();
  int k, j, i;
  float xo = 0.0f, ro = 0.0f, dot = 0.0f;
  if (cell(g, q, k, j, i)) {
    const RUpdateField rn{r_old, ap, alpha};
    const RUpdateDinvField u{rn, diag, s0};
    ro = rn(q);
    const float uq = u(q);
    const float w = star(u, diag[q] * uq, q, k, j, i, g, a, pinned);
    xo = uq + ad * uq + gg * ((1.0f / diag[q]) * (ro - w));
    dot = ro * ro;
  }
  if (q < g.total) {
    x1[q] = xo;
    r_new[q] = ro;
  }
  block_partial(dot, partials);
}

// K10-K13: one stencil apply of the full operator with the elementwise
// epilogue of a single-step mode (fused7_xla :974-983).  s = D^-1 (b - A x):
//   RESIDUAL  out = b - A x                                (3 reads, 1 write)
//   RICH      out = x + g s                                (3 reads, 1 write)
//   CHEB0     d' = g s;  out = x + d'                      (3 reads, 2 writes)
//   CHEB      d' = ad d + g s;  out = x + d'               (4 reads, 2 writes)
enum Step { RESIDUAL, RICH, CHEB0, CHEB };

template <int MODE>
__global__ void __launch_bounds__(BLOCK)
step_kernel(const float* __restrict__ x, const float* __restrict__ b,
            const float* __restrict__ d, const float* __restrict__ diag,
            float* __restrict__ out, float* __restrict__ dout, Geom g,
            Legs a, float gg, float ad, int pinned) {
  const long long q = thread_cell();
  int k, j, i;
  if (q >= g.total) return;
  float o = 0.0f, dn = 0.0f;
  if (cell(g, q, k, j, i)) {
    const float w = star(Field{x}, diag[q] * x[q], q, k, j, i, g, a, pinned);
    if constexpr (MODE == RESIDUAL) {
      o = b[q] - w;
    } else {
      const float sq = (1.0f / diag[q]) * (b[q] - w);
      if constexpr (MODE == RICH) {
        o = x[q] + gg * sq;
      } else {
        dn = MODE == CHEB ? ad * d[q] + gg * sq : gg * sq;
        o = x[q] + dn;
      }
    }
  }
  out[q] = o;
  if constexpr (MODE == CHEB0 || MODE == CHEB) dout[q] = dn;
}

// K14 pre2, both Chebyshev pre-smoothing steps from a zero guess:
// u = (s0 b) D^-1;  d' = ad u + g D^-1 (b - A u);  out = u + d'.  u is
// formed on the fly wherever the stencil reads it (fused7_xla :984-987).
__global__ void __launch_bounds__(BLOCK)
pre2_kernel(const float* __restrict__ b, const float* __restrict__ diag,
            float* __restrict__ out, float* __restrict__ dout, Geom g,
            Legs a, float s0, float ad, float gg, int pinned) {
  const long long q = thread_cell();
  int k, j, i;
  if (q >= g.total) return;
  float o = 0.0f, dn = 0.0f;
  if (cell(g, q, k, j, i)) {
    const DinvField u{b, diag, s0};
    const float uq = u(q);
    const float w = star(u, diag[q] * uq, q, k, j, i, g, a, pinned);
    dn = ad * uq + gg * ((1.0f / diag[q]) * (b[q] - w));
    o = uq + dn;
  }
  out[q] = o;
  dout[q] = dn;
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

// Every P-smoothing stage below takes the filtered legs f (fcx, fcy, fcz):
// the -pc_gamg_threshold prolongator smoother (fused7.py:359-365), equal
// to the operator's legs a when nothing is filtered.

template <bool DOT>
static int descent(const float* b, const float* diag, float* x1, float* r,
                   float* s, float* partials, const Geom& g, Legs a, Legs f,
                   float s0, float ad, float gg, float gw, int pinned,
                   cudaStream_t st) {
  pre_smooth_kernel<DOT><<<grid_blocks(g), BLOCK, 0, st>>>(
      b, diag, x1, partials, g, a, s0, ad, gg, pinned);
  TPS_CHECK();
  step_kernel<RESIDUAL><<<grid_blocks(g), BLOCK, 0, st>>>(
      x1, b, nullptr, diag, r, nullptr, g, a, 0.0f, 0.0f, pinned);
  TPS_CHECK();
  restrict_smooth_kernel<<<grid_blocks(g), BLOCK, 0, st>>>(r, diag, s, g, f,
                                                           gw, pinned);
  return (int)cudaGetLastError();
}

// K3 (descent_rr) with partials, K3' (descent) with partials == nullptr.
extern "C" int tps_descent(const float* b, const float* diag, float* x1,
                           float* r, float* s, float* partials, int nz,
                           int ny, int nx, int nxp, float cx, float cy,
                           float cz, float fcx, float fcy, float fcz,
                           float s0, float ad, float gg, float gw,
                           int pinned, void* stream) {
  const Geom g = make_geom(nz, ny, nx, nxp);
  const Legs a{cx, cy, cz}, f{fcx, fcy, fcz};
  const cudaStream_t st = (cudaStream_t)stream;
  return partials ? descent<true>(b, diag, x1, r, s, partials, g, a, f, s0,
                                  ad, gg, gw, pinned, st)
                  : descent<false>(b, diag, x1, r, s, partials, g, a, f, s0,
                                   ad, gg, gw, pinned, st);
}

template <bool DOT>
static int ascent(const float* t, const float* b, const float* x1,
                  const float* diag, float* x2, float* d, float* x3,
                  float* x4, float* partials, const Geom& g, Legs a, Legs f,
                  float gg, float ad, float g2, float gw, int pinned,
                  cudaStream_t st) {
  prolong_kernel<true><<<grid_blocks(g), BLOCK, 0, st>>>(t, x1, diag, x2, g,
                                                         f, gw, pinned);
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
                          int nxp, float cx, float cy, float cz, float fcx,
                          float fcy, float fcz, float gg, float ad, float g2,
                          float gw, int pinned, void* stream) {
  const Geom g = make_geom(nz, ny, nx, nxp);
  const Legs a{cx, cy, cz}, f{fcx, fcy, fcz};
  const cudaStream_t st = (cudaStream_t)stream;
  return partials ? ascent<true>(t, b, x1, diag, x2, d, x3, x4, partials, g,
                                 a, f, gg, ad, g2, gw, pinned, st)
                  : ascent<false>(t, b, x1, diag, x2, d, x3, x4, partials, g,
                                  a, f, gg, ad, g2, gw, pinned, st);
}

template <bool DOT>
static int descent1(const float* b, const float* diag, float* x1, float* r,
                    float* s, float* partials, const Geom& g, Legs a, Legs f,
                    float gg, float gw, int pinned, cudaStream_t st) {
  pre_smooth1_kernel<DOT><<<grid_blocks(g), BLOCK, 0, st>>>(
      b, diag, x1, r, partials, g, a, gg, pinned);
  TPS_CHECK();
  restrict_smooth_kernel<<<grid_blocks(g), BLOCK, 0, st>>>(r, diag, s, g, f,
                                                           gw, pinned);
  return (int)cudaGetLastError();
}

// K6 (descent1_rr) with partials, K6' (descent1) with partials == nullptr.
extern "C" int tps_descent1(const float* b, const float* diag, float* x1,
                            float* r, float* s, float* partials, int nz,
                            int ny, int nx, int nxp, float cx, float cy,
                            float cz, float fcx, float fcy, float fcz,
                            float gg, float gw, int pinned, void* stream) {
  const Geom g = make_geom(nz, ny, nx, nxp);
  const Legs a{cx, cy, cz}, f{fcx, fcy, fcz};
  const cudaStream_t st = (cudaStream_t)stream;
  return partials ? descent1<true>(b, diag, x1, r, s, partials, g, a, f, gg,
                                   gw, pinned, st)
                  : descent1<false>(b, diag, x1, r, s, partials, g, a, f, gg,
                                    gw, pinned, st);
}

template <bool DOT>
static int ascent1(const float* t, const float* b, const float* x1,
                   const float* diag, float* x2, float* x3, float* partials,
                   const Geom& g, Legs a, Legs f, float gg, float gw,
                   int pinned, cudaStream_t st) {
  prolong_kernel<true><<<grid_blocks(g), BLOCK, 0, st>>>(t, x1, diag, x2, g,
                                                         f, gw, pinned);
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
                           float cx, float cy, float cz, float fcx, float fcy,
                           float fcz, float gg, float gw, int pinned,
                           void* stream) {
  const Geom g = make_geom(nz, ny, nx, nxp);
  const Legs a{cx, cy, cz}, f{fcx, fcy, fcz};
  const cudaStream_t st = (cudaStream_t)stream;
  return partials ? ascent1<true>(t, b, x1, diag, x2, x3, partials, g, a, f,
                                  gg, gw, pinned, st)
                  : ascent1<false>(t, b, x1, diag, x2, x3, partials, g, a, f,
                                   gg, gw, pinned, st);
}

// K8 cgmv: one launch.
extern "C" int tps_cgmv(const float* z, const float* p, const float* x,
                        const float* diag, const float* beta,
                        const float* alpha_prev, float* w, float* pn,
                        float* xn, float* partials, int nz, int ny, int nx,
                        int nxp, float cx, float cy, float cz, int pinned,
                        void* stream) {
  const Geom g = make_geom(nz, ny, nx, nxp);
  cgmv_kernel<<<grid_blocks(g), BLOCK, 0, (cudaStream_t)stream>>>(
      z, p, x, diag, beta, alpha_prev, w, pn, xn, partials, g,
      Legs{cx, cy, cz}, pinned);
  return (int)cudaGetLastError();
}

// K9 descentu: the r-update with the pre-smoother, then K3's residual and
// P^T-smoothing launches on r'.
extern "C" int tps_descentu(const float* r_old, const float* ap,
                            const float* alpha, const float* diag, float* x1,
                            float* r_new, float* r, float* s, float* partials,
                            int nz, int ny, int nx, int nxp, float cx,
                            float cy, float cz, float fcx, float fcy,
                            float fcz, float s0, float ad, float gg,
                            float gw, int pinned, void* stream) {
  const Geom g = make_geom(nz, ny, nx, nxp);
  const Legs a{cx, cy, cz}, f{fcx, fcy, fcz};
  const cudaStream_t st = (cudaStream_t)stream;
  rupdate_pre_smooth_kernel<<<grid_blocks(g), BLOCK, 0, st>>>(
      r_old, ap, alpha, diag, x1, r_new, partials, g, a, s0, ad, gg, pinned);
  TPS_CHECK();
  step_kernel<RESIDUAL><<<grid_blocks(g), BLOCK, 0, st>>>(
      x1, r_new, nullptr, diag, r, nullptr, g, a, 0.0f, 0.0f, pinned);
  TPS_CHECK();
  restrict_smooth_kernel<<<grid_blocks(g), BLOCK, 0, st>>>(r, diag, s, g, f,
                                                           gw, pinned);
  return (int)cudaGetLastError();
}

// K10-K16, the single-step modes: one launch each.  Unused operands are
// never read (nullptr).
static int step(int mode, const float* x, const float* b, const float* d,
                const float* diag, float* out, float* dout, int nz, int ny,
                int nx, int nxp, float cx, float cy, float cz, float gg,
                float ad, int pinned, void* stream) {
  const Geom g = make_geom(nz, ny, nx, nxp);
  const Legs a{cx, cy, cz};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case RESIDUAL:
      step_kernel<RESIDUAL><<<grid_blocks(g), BLOCK, 0, st>>>(
          x, b, d, diag, out, dout, g, a, gg, ad, pinned);
      break;
    case RICH:
      step_kernel<RICH><<<grid_blocks(g), BLOCK, 0, st>>>(
          x, b, d, diag, out, dout, g, a, gg, ad, pinned);
      break;
    case CHEB0:
      step_kernel<CHEB0><<<grid_blocks(g), BLOCK, 0, st>>>(
          x, b, d, diag, out, dout, g, a, gg, ad, pinned);
      break;
    default:
      step_kernel<CHEB><<<grid_blocks(g), BLOCK, 0, st>>>(
          x, b, d, diag, out, dout, g, a, gg, ad, pinned);
  }
  return (int)cudaGetLastError();
}

// K10 residual: r = b - A x.
extern "C" int tps_residual(const float* x, const float* b, const float* diag,
                            float* r, int nz, int ny, int nx, int nxp,
                            float cx, float cy, float cz, int pinned,
                            void* stream) {
  return step(RESIDUAL, x, b, nullptr, diag, r, nullptr, nz, ny, nx, nxp, cx,
              cy, cz, 0.0f, 0.0f, pinned, stream);
}

// K11 rich: x' = x + g D^-1 (b - A x).
extern "C" int tps_rich(const float* x, const float* b, const float* diag,
                        float* xo, int nz, int ny, int nx, int nxp, float cx,
                        float cy, float cz, float gg, int pinned,
                        void* stream) {
  return step(RICH, x, b, nullptr, diag, xo, nullptr, nz, ny, nx, nxp, cx, cy,
              cz, gg, 0.0f, pinned, stream);
}

// K12 cheb0: d' = g D^-1 (b - A x);  x' = x + d'.
extern "C" int tps_cheb0(const float* x, const float* b, const float* diag,
                         float* xo, float* dout, int nz, int ny, int nx,
                         int nxp, float cx, float cy, float cz, float gg,
                         int pinned, void* stream) {
  return step(CHEB0, x, b, nullptr, diag, xo, dout, nz, ny, nx, nxp, cx, cy,
              cz, gg, 0.0f, pinned, stream);
}

// K13 cheb: d' = ad d + g D^-1 (b - A x);  x' = x + d'.
extern "C" int tps_cheb(const float* x, const float* b, const float* d,
                        const float* diag, float* xo, float* dout, int nz,
                        int ny, int nx, int nxp, float cx, float cy, float cz,
                        float ad, float gg, int pinned, void* stream) {
  return step(CHEB, x, b, d, diag, xo, dout, nz, ny, nx, nxp, cx, cy, cz, gg,
              ad, pinned, stream);
}

// K14 pre2.
extern "C" int tps_pre2(const float* b, const float* diag, float* xo,
                        float* dout, int nz, int ny, int nx, int nxp,
                        float cx, float cy, float cz, float s0, float ad,
                        float gg, int pinned, void* stream) {
  const Geom g = make_geom(nz, ny, nx, nxp);
  pre2_kernel<<<grid_blocks(g), BLOCK, 0, (cudaStream_t)stream>>>(
      b, diag, xo, dout, g, Legs{cx, cy, cz}, s0, ad, gg, pinned);
  return (int)cudaGetLastError();
}

// K15 restrict: s = r - g A_f (D^-1 r); (fcx, fcy, fcz) are A_f's legs.
extern "C" int tps_restrict(const float* r, const float* diag, float* s,
                            int nz, int ny, int nx, int nxp, float fcx,
                            float fcy, float fcz, float gg, int pinned,
                            void* stream) {
  const Geom g = make_geom(nz, ny, nx, nxp);
  restrict_smooth_kernel<<<grid_blocks(g), BLOCK, 0, (cudaStream_t)stream>>>(
      r, diag, s, g, Legs{fcx, fcy, fcz}, gg, pinned);
  return (int)cudaGetLastError();
}

// K16 prolong: out = t - g D^-1 (A_f t).
extern "C" int tps_prolong(const float* t, const float* diag, float* out,
                           int nz, int ny, int nx, int nxp, float fcx,
                           float fcy, float fcz, float gg, int pinned,
                           void* stream) {
  const Geom g = make_geom(nz, ny, nx, nxp);
  prolong_kernel<false><<<grid_blocks(g), BLOCK, 0, (cudaStream_t)stream>>>(
      t, nullptr, diag, out, g, Legs{fcx, fcy, fcz}, gg, pinned);
  return (int)cudaGetLastError();
}
