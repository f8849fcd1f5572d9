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
// Two designs.  K6 and K7 (descent1(_rr), ascent1(_rz): the reference
// config's Richardson(1) V-cycle, the kernels its solve launches most) are
// one launch each that marches a column tile up a z-chunk of planes through
// shared-memory rings, so each field crosses HBM about once: 4 passes for
// K6, 5 for K7, their bounds (see the K6/K7 section below).  The others are
// first-port designs: a short fixed sequence of launches per mode, each
// fusing ONE stencil apply with its elementwise epilogue, one thread per
// padded cell, with the intermediates in device memory (the wrapper
// allocates them).  That costs descent 10 field passes (3 launches), ascent
// 14 (3 launches), cgmv 7 (1 launch, its bound) and descentu 12 (3
// launches, against a bound of 6).  K10-K16 are one launch each at their
// bounds' pass counts: residual and rich 4, cheb0 5, cheb 6, pre2 4,
// restrict and prolong 3.  Every chained step writes zero outside the
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

// K15 (restrict) and K3 step 3, the P^T smoothing pass:
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
// t - gw D^-1 (A_f t); with ADD, K4 step 1, which adds the coarse
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

// ---------------------------------------------------------------------------
// K6 (descent1_rr) and K7 (ascent1_rz), with K6'/K7' their dot-free forms:
// the degree-1 V-cycle of the reference config, one launch each, by
// z-marching.  They replace fused7_call's modes descent1(_rr) and
// ascent1(_rz) (tpusparse/kernels/fused7.py:632-673).
//
// Bound on the H100: bytes.  K6 reads b and diag and writes x1 and s (4
// field passes, 0.1315 ms at 300^3); K7 reads t, b, x1 and diag and writes
// x3 (5 passes, 0.1644 ms).  Each chains two stencil applies, so a cell's
// output depends on inputs two cells away in every direction.
//
// Design, after the TPU kernel's slab streaming with halo planes
// (fused7.py:381-421): a block owns a ZM_TY x ZM_TX = 12 x 56 column tile
// of the (ny, nxp) plane and marches up one z-chunk of padded planes.  Its
// region is the tile plus 2 rows a side in y and one quad (4 cells, 2 of
// them needed) a side in x: 16 x 64 cells, one quad of 4 consecutive x
// cells a thread, copied and stored 16 bytes at a time (the region's
// columns start on 16 bytes).  The inputs come through a staging ring in
// shared memory by cp.async, 2-3 planes ahead of their use, so that a block
// keeps that many planes of loads in flight: a first version that loaded
// one plane ahead into registers waited on HBM latency and ran at 0.36 /
// 0.53 ms (PERF.md, PR 6).  Per plane p:
//   1. the thread's quads of plane p go through the first step and into a
//      shared ring of 3 planes (K6: x1 = g (b D^-1); K7: t as it is);
//   2. the chained step runs on plane p - 1 for the tile plus one cell a
//      side, reading its stencil from that ring, and writes a second ring
//      (K6: r = b - A x1, stored as D^-1 r; K7: x2 = x1 + t - gw D^-1 A_f t);
//   3. the last step runs on plane p - 2 for the tile, reading the second
//      ring, writes the tile's outputs (K6: x1 and s = r - gw A_f(D^-1 r);
//      K7: x3 = x2 + g D^-1 (b - A x2)) and adds to the dot.
// So each input and output crosses HBM about once: a chunk re-reads its 4
// halo planes and a tile its halo columns (mostly from L2, where the
// neighbouring blocks that run at the same time put them).  One IEEE
// reciprocal 1/d a cell and plane, reused by both steps.  The rings hold 0
// at every cell off the domain (face planes, x pads, beyond the field), so
// a stencil read there is the Neumann boundary's dropped entry without a
// mask; only the pinned origin is tested, in the one block that holds it.
// A thread reads the stencil's six neighbours as four float4 quads and two
// scalars from shared memory.  Every value is the same expression as in the
// plain twin and in the single-step kernels (restrict_smooth_kernel,
// prolong_kernel<true>), so x1 is bit-equal to the twin's.  Every output
// cell of the tile's chunk is written, zero off the domain.
//
// The launch plan (tiles, z-chunk, grid, shared bytes, partials) is
// computed by the wrapper (kernels/fused7.py::zmarch_plan); the entry
// points refuse a plan that does not cover the field exactly once.
// ---------------------------------------------------------------------------
constexpr int ZM_TX = 56, ZM_TY = 12;        // a block's output tile (x, y)
constexpr int ZM_HX = 4, ZM_HY = 2;          // region halo: a quad in x
constexpr int ZM_SX = ZM_TX + 2 * ZM_HX;     // 64 region columns
constexpr int ZM_SY = ZM_TY + 2 * ZM_HY;     // 16 region rows
constexpr int ZM_QX = ZM_SX / 4;             // 16 quads a region row
constexpr int ZM_PLANE = ZM_SX * ZM_SY;      // shared floats a ring plane
constexpr int ZM_RING_PLANES = 6;            // two rings of 3 planes
// Each kernel stages its input fields STAGES planes deep, copied STAGES - 3
// planes ahead of their use: as many as its blocks' shared memory allows
// at the SM's occupancy it asks for (MIN_BLOCKS), so that enough bytes are
// in flight to keep HBM busy.  K6: 2 fields, 6 stages, 3 blocks an SM (72
// KB each); K7: 4 fields, 5 stages, 2 blocks an SM (104 KB each).
constexpr int ZM6_FIELDS = 2, ZM6_STAGES = 6, ZM6_MIN_BLOCKS = 3;
constexpr int ZM7_FIELDS = 4, ZM7_STAGES = 5, ZM7_MIN_BLOCKS = 2;
static_assert(ZM_QX * ZM_SY == BLOCK, "one quad of the region a thread");

// Four consecutive cells of a row, one thread's share of every step.
struct Quad {
  float v[4];
};

__device__ __forceinline__ Quad quad_of(float4 f) {
  return Quad{{f.x, f.y, f.z, f.w}};
}

__device__ __forceinline__ float4 float4_of(const Quad& q) {
  return make_float4(q.v[0], q.v[1], q.v[2], q.v[3]);
}

// The thread's quad: its place in the region, its domain coordinates, and
// which of its cells each step covers.  The region starts ZM_HX columns and
// ZM_HY rows before the tile, so a quad lies wholly inside or wholly
// outside [0, nxp) and its global rows start on 16 bytes.
struct ZQuad {
  int q;          // float4 index in a ring plane: ly * ZM_QX + qx
  int ly, qx;     // region row and quad column
  int j, i0;      // domain y, and x of the quad's first cell
  int off;        // j * nxp + i0: the quad's offset in a padded plane
  bool field;     // the quad lies in the padded plane (0 <= j < ny, i0 < nxp)
  bool dom[4];    // each cell lies in the domain's plane (also i < nx)
  bool mid;       // the quad's row is one of step 2's, whose cells are the
                  // tile plus one cell a side (every such row's quads hold
                  // one at least; the others' values are never read)
  bool out;       // the quad is in the tile and the field: step 3 writes it
};

__device__ __forceinline__ ZQuad zquad(const Geom& g) {
  ZQuad z;
  z.ly = (int)threadIdx.x / ZM_QX;
  z.qx = (int)threadIdx.x % ZM_QX;
  z.q = z.ly * ZM_QX + z.qx;
  z.j = (int)blockIdx.y * ZM_TY - ZM_HY + z.ly;
  z.i0 = (int)blockIdx.x * ZM_TX - ZM_HX + 4 * z.qx;
  z.off = z.j * g.nxp + z.i0;
  z.field = z.j >= 0 && z.j < g.ny && z.i0 >= 0 && z.i0 < g.nxp;
#pragma unroll
  for (int l = 0; l < 4; ++l) z.dom[l] = z.field && z.i0 + l < g.nx;
  z.mid = z.ly >= 1 && z.ly < ZM_SY - 1;
  z.out = z.field && z.ly >= ZM_HY && z.ly < ZM_SY - ZM_HY && z.qx >= 1 &&
          z.qx < ZM_QX - 1;
  return z;
}

// A ring of 3 shared planes; rotate() before writing the newest plane
// makes plane(0) the oldest, plane(1) the next and plane(2) the slot that
// is written (the oldest of the three before the rotation).
struct Ring {
  float* base;
  int s0, s1, s2;
  __device__ __forceinline__ void rotate() {
    const int t = s0;
    s0 = s1;
    s1 = s2;
    s2 = t;
  }
  __device__ __forceinline__ float* plane(int n) const {
    return base + (n == 0 ? s0 : n == 1 ? s1 : s2);
  }
  __device__ __forceinline__ Quad get(int n, int q) const {
    return quad_of(reinterpret_cast<const float4*>(plane(n))[q]);
  }
  __device__ __forceinline__ void put(const Quad& v, int q) const {
    reinterpret_cast<float4*>(plane(2))[q] = float4_of(v);
  }
};

__device__ __forceinline__ Ring make_ring(float* base) {
  return Ring{base, 0, ZM_PLANE, 2 * ZM_PLANE};
}

// (A u) at the four cells of quad z on the middle plane of ring r, given
// each cell's diagonal term: six neighbour quads, two of them shifted by
// one cell.  The ring holds 0 outside the domain, so a neighbour the
// Neumann boundary drops reads that 0 and needs no mask; only the pinned
// origin needs a test (MatZeroRowsColumns, as in star), and only in the
// blocks whose region holds it (``pin``, uniform in a block).  A cell outside
// the step's cells gets a value that is never read.
__device__ __forceinline__ Quad quad_star(const Ring& r, const ZQuad& z,
                                          const Quad& center, int k, Legs a,
                                          bool pin) {
  const float* mid = r.plane(1);
  const Quad c = r.get(1, z.q);
  const Quad ym = r.get(1, z.q - ZM_QX), yp = r.get(1, z.q + ZM_QX);
  const Quad zm = r.get(0, z.q), zp = r.get(2, z.q);
  const float left = mid[4 * z.q - 1], right = mid[4 * z.q + 4];
  Quad w;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    float xm = l == 0 ? left : c.v[l - 1];
    const float xp = l == 3 ? right : c.v[l + 1];
    float ymv = ym.v[l], zmv = zm.v[l];
    const int i = z.i0 + l;
    if (pin) {
      if (k == 0 && z.j == 0 && i == 0) {
        w.v[l] = center.v[l];
        continue;
      }
      if (k == 0 && z.j == 0 && i == 1) xm = 0.0f;
      if (k == 0 && z.j == 1 && i == 0) ymv = 0.0f;
      if (k == 1 && z.j == 0 && i == 0) zmv = 0.0f;
    }
    w.v[l] = center.v[l] + a.cx * (xp + xm) + a.cy * (yp.v[l] + ymv) +
             a.cz * (zp.v[l] + zmv);
  }
  return w;
}

// The pinned origin's cells, (k, j, i) with k + j + i <= 1, lie in this
// block's region and march: the first tile in y and x, and a z-chunk whose
// march (from 2 planes below z0) reaches domain plane 1.
__device__ __forceinline__ bool pins_origin(const Geom& g, int pinned,
                                            int z0) {
  return pinned && blockIdx.x == 0 && blockIdx.y == 0 &&
         z0 - 2 <= g.face + 1;
}

// Plane p of the padded field is a domain plane (k = p - face in [0, nz)).
__device__ __forceinline__ bool domain_plane(const Geom& g, int p) {
  return p >= g.face && p < g.face + g.nz;
}

// One 16-byte cp.async from global to shared memory; with valid false it
// reads nothing and writes zeros (src-size 0).
__device__ __forceinline__ void cp_async16(float4* dst, const float* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's copy groups are in flight.  The
// memory clobber keeps the compiler from moving the reads of the staged
// planes above the wait.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The staging ring after the two rings: STAGES planes of each of FIELDS
// input fields.  Plane p of the march (which starts at z0 - 2) is in slot
// (p - z0 + 2) % STAGES.  Each thread copies and reads only its own quad,
// so cp_async_wait alone, with no barrier, makes a copy visible to its
// reader; a slot is copied into again STAGES planes later, 3 planes after
// its last read (step 3, two planes behind step 1).
template <int FIELDS, int STAGES>
struct Staging {
  float* base;
  int z0;
  __device__ __forceinline__ float4* at(int field, int p) const {
    return reinterpret_cast<float4*>(
        base + (field * STAGES + (p - z0 + 2) % STAGES) * ZM_PLANE);
  }
  // copy the thread's quad of field f, plane p (zeros where it has none)
  __device__ __forceinline__ void copy(int field, const float* f,
                                       const Geom& g, const ZQuad& z, int p,
                                       bool want) const {
    const bool valid = want && z.field && domain_plane(g, p);
    cp_async16(at(field, p) + z.q,
               valid ? f + (long long)p * g.plane + z.off : f, valid);
  }
  // the thread's quad of field `field` on plane p: its domain cells' values
  // and `fill` at the others
  __device__ __forceinline__ Quad get(int field, const Geom& g,
                                      const ZQuad& z, int p,
                                      float fill) const {
    const Quad got = quad_of(at(field, p)[z.q]);
    const bool dp = domain_plane(g, p);
    Quad v;
#pragma unroll
    for (int l = 0; l < 4; ++l) v.v[l] = dp && z.dom[l] ? got.v[l] : fill;
    return v;
  }
};

__device__ __forceinline__ void store_quad(float* __restrict__ f,
                                           const Geom& g, const ZQuad& z,
                                           int p, const Quad& v) {
  reinterpret_cast<float4*>(f + (long long)p * g.plane + z.off)[0] =
      float4_of(v);
}

// K6 / K6': x1 = g (b D^-1);  r = b - A x1;  s = r - gw A_f (D^-1 r);
// partials of <b, b> with DOT.
template <bool DOT>
__global__ void __launch_bounds__(BLOCK, ZM6_MIN_BLOCKS)
descent1_kernel(const float* __restrict__ b, const float* __restrict__ diag,
                float* __restrict__ x1, float* __restrict__ s,
                float* __restrict__ partials, Geom g, Legs a, Legs f,
                float gg, float gw, int pinned, int zchunk) {
  constexpr int AHEAD = ZM6_STAGES - 3;
  extern __shared__ float4 smem4[];
  float* rings = reinterpret_cast<float*>(smem4);
  Ring xr = make_ring(rings), vr = make_ring(rings + 3 * ZM_PLANE);
  const int nzp = g.nz + 2 * g.face;
  const int z0 = (int)blockIdx.z * zchunk, z1 = min(z0 + zchunk, nzp);
  const ZQuad z = zquad(g);
  const bool pin = pins_origin(g, pinned, z0);
  // b (field 0) and diag (field 1), staged AHEAD planes ahead: one copy
  // group a plane, empty past the march, so every wait counts alike
  const Staging<ZM6_FIELDS, ZM6_STAGES> st{rings + ZM_RING_PLANES * ZM_PLANE,
                                           z0};
  auto stage = [&](int p) {
    if (p <= z1 + 1) {
      st.copy(0, b, g, z, p, true);
      st.copy(1, diag, g, z, p, true);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int n = 0; n < AHEAD; ++n) stage(z0 - 2 + n);

  Quad dinv1, r2;   // D^-1 of plane p - 1 and r of plane p - 2, kept
  float dot = 0.0f;
  for (int p = z0 - 2; p <= z1 + 1; ++p) {
    stage(p + AHEAD);
    cp_async_wait<AHEAD>();

    // step 1, plane p, the whole region: one reciprocal a cell, x1 =
    // g (b D^-1) (b is 0 off the domain, and so is x1); <b, b> over the
    // tile's cells of the chunk's planes
    xr.rotate();
    const Quad b0 = st.get(0, g, z, p, 0.0f), d0 = st.get(1, g, z, p, 1.0f);
    Quad dinv0, x10;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      dinv0.v[l] = 1.0f / d0.v[l];
      x10.v[l] = gg * (b0.v[l] * dinv0.v[l]);
    }
    if constexpr (DOT) {
      if (z.out && p >= z0 && p < z1) {
#pragma unroll
        for (int l = 0; l < 4; ++l) dot += b0.v[l] * b0.v[l];
      }
    }
    xr.put(x10, z.q);
    __syncthreads();

    // step 2, plane p - 1, the tile plus a cell a side: r = b - A x1,
    // stored as D^-1 r (the P^T smoothing's stencil input), 0 off the domain
    vr.rotate();
    Quad r1{};
    if (p - 1 >= z0 - 1 && z.mid) {
      const bool dp = domain_plane(g, p - 1);
      const Quad b1 = st.get(0, g, z, p - 1, 0.0f);
      const Quad d1 = st.get(1, g, z, p - 1, 1.0f);
      const Quad x11 = xr.get(1, z.q);
      Quad center, v;
#pragma unroll
      for (int l = 0; l < 4; ++l) center.v[l] = d1.v[l] * x11.v[l];
      const Quad w = quad_star(xr, z, center, p - 1 - g.face, a, pin);
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        r1.v[l] = dp && z.dom[l] ? b1.v[l] - w.v[l] : 0.0f;
        v.v[l] = r1.v[l] * dinv1.v[l];
      }
      vr.put(v, z.q);
    }
    __syncthreads();

    // step 3, plane p - 2, the tile: s = r - gw A_f (D^-1 r); write x1
    // (the thread's own quad of the x1 ring) and s
    if (p - 2 >= z0 && z.out) {
      const bool dp = domain_plane(g, p - 2);
      const Quad d2 = st.get(1, g, z, p - 2, 1.0f);
      const Quad v = vr.get(1, z.q);
      Quad center, so;
#pragma unroll
      for (int l = 0; l < 4; ++l) center.v[l] = d2.v[l] * v.v[l];
      const Quad w = quad_star(vr, z, center, p - 2 - g.face, f, pin);
#pragma unroll
      for (int l = 0; l < 4; ++l)
        so.v[l] = dp && z.dom[l] ? r2.v[l] - gw * w.v[l] : 0.0f;
      store_quad(x1, g, z, p - 2, xr.get(0, z.q));
      store_quad(s, g, z, p - 2, so);
    }
    r2 = r1;
    dinv1 = dinv0;
  }
  if constexpr (DOT)
    block_partial_at(dot, partials,
                     (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                         blockIdx.x);
}

// K7 / K7': x2 = x1 + t - gw D^-1 (A_f t);  x3 = x2 + g D^-1 (b - A x2);
// partials of <b, x3> with DOT.
template <bool DOT>
__global__ void __launch_bounds__(BLOCK, ZM7_MIN_BLOCKS)
ascent1_kernel(const float* __restrict__ t, const float* __restrict__ b,
               const float* __restrict__ x1, const float* __restrict__ diag,
               float* __restrict__ x3, float* __restrict__ partials, Geom g,
               Legs a, Legs f, float gg, float gw, int pinned, int zchunk) {
  constexpr int AHEAD = ZM7_STAGES - 3;
  extern __shared__ float4 smem4[];
  float* rings = reinterpret_cast<float*>(smem4);
  Ring tr = make_ring(rings), x2r = make_ring(rings + 3 * ZM_PLANE);
  const int nzp = g.nz + 2 * g.face;
  const int z0 = (int)blockIdx.z * zchunk, z1 = min(z0 + zchunk, nzp);
  const ZQuad z = zquad(g);
  const bool pin = pins_origin(g, pinned, z0);
  // t (field 0, every quad), x1 and diag (fields 1, 2: step 2's rows) and
  // b (field 3: the tile), staged AHEAD planes ahead
  const Staging<ZM7_FIELDS, ZM7_STAGES> st{rings + ZM_RING_PLANES * ZM_PLANE,
                                           z0};
  auto stage = [&](int p) {
    if (p <= z1 + 1) {
      st.copy(0, t, g, z, p, true);
      st.copy(1, x1, g, z, p, z.mid);
      st.copy(2, diag, g, z, p, z.mid);
      st.copy(3, b, g, z, p, z.out);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int n = 0; n < AHEAD; ++n) stage(z0 - 2 + n);

  Quad dinv1, dinv2;   // D^-1 of planes p - 1 and p - 2, kept
  float dot = 0.0f;
  for (int p = z0 - 2; p <= z1 + 1; ++p) {
    stage(p + AHEAD);
    cp_async_wait<AHEAD>();

    // step 1, plane p: t into its ring (0 off the domain); one reciprocal
    // a cell of step 2's rows
    tr.rotate();
    tr.put(st.get(0, g, z, p, 0.0f), z.q);
    Quad dinv0{};
    if (z.mid) {
      const Quad d0 = st.get(2, g, z, p, 1.0f);
#pragma unroll
      for (int l = 0; l < 4; ++l) dinv0.v[l] = 1.0f / d0.v[l];
    }
    __syncthreads();

    // step 2, plane p - 1, the tile plus a cell a side:
    // x2 = x1 + t - gw D^-1 (A_f t), 0 off the domain
    x2r.rotate();
    if (p - 1 >= z0 - 1 && z.mid) {
      const bool dp = domain_plane(g, p - 1);
      const Quad tc = tr.get(1, z.q);
      const Quad x11 = st.get(1, g, z, p - 1, 0.0f);
      const Quad d1 = st.get(2, g, z, p - 1, 1.0f);
      Quad center, x2;
#pragma unroll
      for (int l = 0; l < 4; ++l) center.v[l] = d1.v[l] * tc.v[l];
      const Quad w = quad_star(tr, z, center, p - 1 - g.face, f, pin);
#pragma unroll
      for (int l = 0; l < 4; ++l)
        x2.v[l] = dp && z.dom[l]
                      ? x11.v[l] + tc.v[l] - gw * (dinv1.v[l] * w.v[l])
                      : 0.0f;
      x2r.put(x2, z.q);
    }
    __syncthreads();

    // step 3, plane p - 2, the tile: x3 = x2 + g D^-1 (b - A x2)
    if (p - 2 >= z0 && z.out) {
      const bool dp = domain_plane(g, p - 2);
      const Quad x2 = x2r.get(1, z.q);
      const Quad d2 = st.get(2, g, z, p - 2, 1.0f);
      const Quad b2 = st.get(3, g, z, p - 2, 0.0f);
      Quad center, out;
#pragma unroll
      for (int l = 0; l < 4; ++l) center.v[l] = d2.v[l] * x2.v[l];
      const Quad w = quad_star(x2r, z, center, p - 2 - g.face, a, pin);
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        out.v[l] = dp && z.dom[l]
                       ? x2.v[l] + gg * (dinv2.v[l] * (b2.v[l] - w.v[l]))
                       : 0.0f;
        if constexpr (DOT) dot += b2.v[l] * out.v[l];
      }
      store_quad(x3, g, z, p - 2, out);
    }
    dinv2 = dinv1;
    dinv1 = dinv0;
  }
  if constexpr (DOT)
    block_partial_at(dot, partials,
                     (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                         blockIdx.x);
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

// The z-marching plan the wrapper computed (kernels/fused7.py::zmarch_plan)
// must cover the padded field exactly once, with the kernels' tile, and
// give the shared bytes of the rings and of the kernel's staged planes.
static bool zmarch_plan_ok(const Geom& g, int tiles_x, int tiles_y,
                           int chunks, int zchunk, int smem_bytes,
                           int staged_planes) {
  const int nzp = g.nz + 2 * g.face;
  return zchunk > 0 && tiles_x == (g.nxp + ZM_TX - 1) / ZM_TX &&
         tiles_y == (g.ny + ZM_TY - 1) / ZM_TY &&
         chunks == (nzp + zchunk - 1) / zchunk &&
         smem_bytes == (ZM_RING_PLANES + staged_planes) * ZM_PLANE *
                           (int)sizeof(float);
}

// Launch a z-marching kernel on the plan's grid, its dynamic shared memory
// allowed past the default 48 KB first.
template <class Kernel, class... Args>
static int zmarch_launch(Kernel kernel, int tiles_x, int tiles_y, int chunks,
                         int smem_bytes, cudaStream_t st, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(tiles_x, tiles_y, chunks), BLOCK, smem_bytes, st>>>(args...);
  return (int)cudaGetLastError();
}

// K6 (descent1_rr) with partials, K6' (descent1) with partials == nullptr:
// one launch of the plan's grid, one partial a block.
extern "C" int tps_descent1(const float* b, const float* diag, float* x1,
                            float* s, float* partials, int nz, int ny,
                            int nx, int nxp, float cx, float cy, float cz,
                            float fcx, float fcy, float fcz, float gg,
                            float gw, int pinned, int tiles_x, int tiles_y,
                            int chunks, int zchunk, int smem_bytes,
                            void* stream) {
  const Geom g = make_geom(nz, ny, nx, nxp);
  if (!zmarch_plan_ok(g, tiles_x, tiles_y, chunks, zchunk, smem_bytes,
                      ZM6_FIELDS * ZM6_STAGES))
    return (int)cudaErrorInvalidValue;
  const Legs a{cx, cy, cz}, f{fcx, fcy, fcz};
  return zmarch_launch(partials ? descent1_kernel<true> : descent1_kernel<false>,
                       tiles_x, tiles_y, chunks, smem_bytes,
                       (cudaStream_t)stream, b, diag, x1, s, partials, g, a, f,
                       gg, gw, pinned, zchunk);
}

// K7 (ascent1_rz) with partials, K7' (ascent1) with partials == nullptr.
extern "C" int tps_ascent1(const float* t, const float* b, const float* x1,
                           const float* diag, float* x3, float* partials,
                           int nz, int ny, int nx, int nxp, float cx,
                           float cy, float cz, float fcx, float fcy,
                           float fcz, float gg, float gw, int pinned,
                           int tiles_x, int tiles_y, int chunks, int zchunk,
                           int smem_bytes, void* stream) {
  const Geom g = make_geom(nz, ny, nx, nxp);
  if (!zmarch_plan_ok(g, tiles_x, tiles_y, chunks, zchunk, smem_bytes,
                      ZM7_FIELDS * ZM7_STAGES))
    return (int)cudaErrorInvalidValue;
  const Legs a{cx, cy, cz}, f{fcx, fcy, fcz};
  return zmarch_launch(partials ? ascent1_kernel<true> : ascent1_kernel<false>,
                       tiles_x, tiles_y, chunks, smem_bytes,
                       (cudaStream_t)stream, t, b, x1, diag, x3, partials, g,
                       a, f, gg, gw, pinned, zchunk);
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
