// K2-K4, K6-K16 and the dot-free K3'/K4'/K6'/K7': the fused7 kernels of
// the GAMG V-cycle and of the full-fusion CG body, on the padded-resident
// layout.  They replace every mode of tpusparse/kernels/fused7.py::
// fused7_call (Pallas body _kernel) but mv, which is K1 (stencil7.cu):
// mvdot, descent(_rr), ascent(_rz), descent1(_rr), ascent1(_rz), cgmv and
// descentu (the fused fine level), and residual, rich, cheb0, cheb, pre2,
// restrict and prolong (K10-K16, the single steps of the unfused padded
// V-cycle), with the math of fused7_xla for each mode.  K3z/K4z are K3'
// and K4' in fused7_call's z-slab form (z0, nzg: one z-shard of a grid,
// tpusparse/dist/fused_sharded.py), the same kernels with a template flag.
//
// Bound on the H100: bytes.  Each mode is a chain of one to three stencil
// applies with elementwise epilogues.  The TPU kernel chains them inside
// one HBM pass per launch by temporal blocking over FACE = 3 halo planes:
// descent_rr reads b and diag once and writes x1 and s (4 field passes),
// ascent_rz reads t, b, x1, diag and writes x4 (5 passes).
//
// Two designs.  The kernels that chain two or three stencil applies, and
// K2, K14 and K15, march: K3/K4 (descent(_rr), ascent(_rz): the degree-2
// cycle of the headline solve, of the non-CG solvers, the W-cycle and the
// threshold schedules), K9 (descentu: K3 with the CG residual update in
// front, the full-fusion body's downstroke), K6/K7 (descent1(_rr),
// ascent1(_rz): the reference config's Richardson(1) cycle), and the
// halo-1 kernels K2 (mvdot, CG's A p and <p, A p>), K14 (pre2, the unfused
// cycle's two Chebyshev pre-smoothing steps) and K15 (restrict, one stencil
// apply of D^-1 r) are one launch each that marches a column tile up a
// z-chunk of planes through shared-memory rings, so each field crosses HBM
// about once: 4 passes for K3, K6 and K14, 5 for K4 and K7, 6 for K9, 3
// for K2 and K15, their bounds (see the z-marching section below).  The
// others do not march: one thread per padded cell, each launch fusing ONE
// stencil apply with its elementwise epilogue.  K8, K10-K13 and K16 are
// one launch each at their bounds' pass counts: cgmv 7, residual and rich
// 4, cheb0 5, cheb 6, prolong 3.  Every chained step writes zero outside
// the domain (the fused7 mask_dom), so the next step's stencil sees the
// Neumann dropped-entry boundary.
//
// K8 (cgmv) and K9 (descentu) carry the CG vector updates.  K8: p' = z +
// beta p is formed at each of the star's seven reads, and x' = x +
// alpha_prev p rides along (4 field reads, 3 writes).  K9 forms the
// residual update r' = r - alpha ap once a cell as it stages the plane,
// and runs K3's steps on r'.  Their CG scalars (beta, alpha_prev, alpha)
// are device scalars read by pointer: they come out of the previous
// launches' dots, and passing them by value would cost CG a host read of
// each per iteration.
//
// The CG dot of a mode is a template flag of the kernel that forms it: with
// DOT the kernel writes one partial per block (block_partial) and the
// wrapper sums the partials in a fixed order, as the JAX wrapper sums its
// per-slab partials outside the kernel (fused7.py:928); without it the
// epilogue is compiled out (the dot-free modes of the non-CG solvers).  An
// entry point takes partials == nullptr for the dot-free form.
#include <type_traits>

#include "star7.cuh"

using namespace tps;

// K16 prolong, the P smoothing pass with the filtered legs ``f``:
// t - gw D^-1 (A_f t).
__global__ void __launch_bounds__(BLOCK)
prolong_kernel(const float* __restrict__ t, const float* __restrict__ diag,
               float* __restrict__ out, Geom g, Legs f, float gw,
               int pinned) {
  const long long q = thread_cell();
  int k, j, i;
  if (q >= g.total) return;
  float o = 0.0f;
  if (cell(g, q, k, j, i)) {
    const float w = star(Field{t}, diag[q] * t[q], q, k, j, i, g, f, pinned);
    o = t[q] - gw * ((1.0f / diag[q]) * w);
  }
  out[q] = o;
}

// ---------------------------------------------------------------------------
// The z-marching kernels, one launch each, with their dot-free forms:
// K3 (descent_rr) / K3' and K4 (ascent_rz) / K4', the degree-2 V-cycle's
// fine level, K9 (descentu), the full-fusion body's downstroke, K6
// (descent1_rr) / K6' and K7 (ascent1_rz) / K7', the reference config's
// degree-1 fine level, and the halo-1 kernels K2 (mvdot), CG's A p and
// <p, A p>, K14 (pre2), the unfused cycle's Chebyshev pre-smoothing, and
// K15 (restrict), its P^T smoothing pass.  They replace fused7_call's
// modes descent(_rr), ascent(_rz) (tpusparse/kernels/fused7.py:575-602,
// 674-701), descentu (:603-631), descent1(_rr), ascent1(_rz) (:632-673),
// mvdot (:515-520), pre2 (:566-573) and restrict (:541-545).
//
// Bound on the H100: bytes.  K3 and K6 read b and diag and write x1 and s
// (4 field passes, 0.1315 ms at 300^3); K4 and K7 read t, b, x1 and diag
// and write x4 (x3) (5 passes, 0.1644 ms); K9 reads r, ap and diag and
// writes x1, s and r' (6 passes, 0.1973 ms); K2 reads x and diag and
// writes y (3 passes, 0.0987 ms), K14 reads b and diag and writes x' and
// d' (4 passes, 0.1315 ms), K15 reads r and diag and writes s (3 passes).
// K3/K4/K9 chain three stencil applies, K6/K7 two and K2/K14/K15 one, so a
// cell's output depends on inputs H = 3 (2, 1) cells away in every
// direction: H is each kernel's halo.
//
// Design, after the TPU kernel's slab streaming with halo planes
// (fused7.py:381-421): a block owns a column tile of the (ny, nxp) plane,
// SY - 2 H rows by ZM_TX = 56 columns, and marches up one z-chunk of padded
// planes.  Its region is the tile plus H rows a side in y and one quad (4
// cells, H of them needed) a side in x: SY x 64 cells, one quad of 4
// consecutive x cells a thread, copied and stored 16 bytes at a time (the
// region's columns start on 16 bytes).  K6/K7: SY = 16, tile 12 x 56, 256
// threads; K3/K4/K9: SY = 40, tile 34 x 56, 640 threads, one block an SM,
// each thread within 96 registers (the register file's 64 K); K2, K14,
// K15: SY = 16, tile 14 x 56, 256 threads, 4 blocks an SM.  K3/K4 are
// bound by the latency their warps cannot hide, not by bytes: the 40-row
// region holds 20 warps an SM against a 32-row one's 16 and loads 6% fewer
// rows at 300^3 (9 tiles of 40 against 12 of 32), and ran 9-10% faster; a
// 16-row region, 2 blocks an SM, ran 15-20% slower than the 32-row one
// (PERF.md section 6).  The inputs come
// through a staging ring in shared memory by cp.async, AHEAD planes ahead
// of their first use, so that a block keeps that many planes of loads in
// flight: a first K6/K7 that loaded one plane ahead into registers waited
// on HBM latency and ran at 0.36 / 0.53 ms (PERF.md section 6).  Per plane
// p, H + 1 steps, each one plane behind the last and on one cell less a
// side (n = 0 .. H):
//   n = 0, plane p, the whole region: the first step, into a shared ring
//      (K3: u = (s0 b) D^-1; K9: the same on b = r' = r - alpha ap, which
//      it writes back to r's staging slot for the later steps and, on the
//      tile, to the output r'; K4, K7: t as it is; K6: x1 = g b D^-1;
//      K2: x as it is; K14: u = (s0 b) D^-1; K15: u = D^-1 r);
//   0 < n < H, plane p - n, the tile plus H - n cells a side (rows n to
//      SY - n; whole quads): a chained step reads its stencil from the
//      ring of step n - 1 and writes a ring of its own (K3: x1 = u + ad u +
//      g D^-1 (b - A u), then r = b - A x1 stored as D^-1 r; K4: x2 = x1 +
//      t - gw D^-1 A_f t, then d = g D^-1 (b - A x2) and x3 = x2 + d; K6:
//      D^-1 r; K7: x2);
//   n = H, plane p - H, the tile: the last step writes the tile's outputs
//      (K3, K9, K6: x1 and s = r - gw A_f (D^-1 r); K4: x4 = x3 + ad d + g2
//      D^-1 (b - A x3); K7: x3 = x2 + g D^-1 (b - A x2); K2: y = A x; K14:
//      d' = ad u + g D^-1 (b - A u) and x' = u + d', the centre term of A u
//      s0 b; K15: s = r - gw A_f u, whose centre term is r itself) and adds
//      to the dot (K2 adds <x, y>; K9 adds <r', r'> at step 0, as K3 adds
//      <b, b>).
// So each input and output crosses HBM about once: a chunk re-reads its 2 H
// halo planes and a tile its halo rows and columns (mostly from L2, where
// the neighbouring blocks that run at the same time put them).  One IEEE
// reciprocal 1/d a cell and plane, reused by every later step: a thread
// carries its own quads' D^-1 (and K3's r, K4's d) across the lag in
// registers, and reads b and diag again from the staging ring, which keeps
// each field's plane until that field's last read.  The rings hold 0 at
// every cell off the domain (face planes, x pads, beyond the field), so a
// stencil read there is the Neumann boundary's dropped entry without a
// mask; only the pinned origin is tested, in the one block that holds it.
// Every value is the plain twin's expression; K6's x1 is bit-equal to the
// twin's, and the outputs of the chained steps may round apart by nvcc's
// contraction of a product and a sum into an FMA.  Every output cell of the
// tile's chunk is written, zero off the domain.
//
// The two pairs read a stencil's neighbours two ways.  K6/K7 keep 3 planes
// of each ring in shared memory and read six neighbour quads and two cells
// from there, with a barrier after each step (quad_star).  K3/K4 read only
// the rows above and below from shared memory: a thread keeps its own quads
// of the three planes a stencil needs in registers (the centre and its z
// neighbours) and takes its x neighbours from the next lanes (Ring2,
// row_neighbours).  A step then reads in shared memory only planes that
// the steps wrote one plane earlier, so each ring needs 2 planes and a
// plane needs one barrier, at its end.  The first K3/K4, in K6/K7's way
// (16-row regions, three barriers a plane), ran at 0.455 / 0.434 ms at
// 300^3 (PERF.md section 6).  K9 and the halo-1 kernels are built on
// K3/K4's way; K9 is K3's kernel with the residual update as a template
// flag, and K2, K14 and K15 are one march (march1) with the mode as a
// template parameter.
//
// K3z/K4z (the SLAB flag of descent_kernel / ascent_kernel) march the q
// z-shards of the stacked layout (q, nz_l + 2 FACE, ny, nxp) in one
// launch, each slab's face planes holding the neighbouring shards' planes.
// blockIdx.z is shard * chunks + chunk (slab_of): a block finds its slab's
// offset in the stack and its global placement before anything else.  Two
// predicates take the place of domain_plane: what is staged and computed
// on is every slab_plane (in the slab's array and in the global domain),
// while the outputs are written 0 on the slab's face planes, as the layout
// of tpusparse/dist/fused_sharded.py keeps them between launches; the pin
// is tested in global planes.  Planes the march reaches outside the slab's
// array (the first chunk starts H below it, the last ends H above) are
// staged as zeros, never read from the neighbouring slab in the stack:
// they feed only face-plane outputs.  The flag adds no work to the
// unsharded kernels, which compile as before.  q = 1 is one slab alone,
// what a card of a multi-card run would launch.
// Bound: bytes, K3'/K4''s 4 / 5 passes over each slab's nz_l + 2 FACE
// planes, 0.139 / 0.174 ms for the 4 slabs of 300^3 at the H100's 3.35
// TB/s.  One launch a slab held one block an SM to 0.82 of a wave at 300^3
// / 4 and ran at 40-50% of the bound (PERF.md section 6); one launch over
// every slab with z-chunks chosen for the whole grid
// (kernels/fused7.py::zmarch_slab_plan) fills whole waves instead.
//
// The launch plan (tiles, z-chunk, grid, shared bytes, partials) is
// computed by the wrapper (kernels/fused7.py::zmarch_plan); the entry
// points refuse a plan that does not cover the field exactly once.
// ---------------------------------------------------------------------------
constexpr int ZM_TX = 56;                    // a block's output tile in x
constexpr int ZM_HX = 4;                     // region halo in x: a quad
constexpr int ZM_SX = ZM_TX + 2 * ZM_HX;     // 64 region columns
constexpr int ZM_QX = ZM_SX / 4;             // 16 quads a region row
static_assert(32 % ZM_QX == 0, "a warp holds whole region rows");
// region rows (the tile's and H a side), one quad of the region a thread:
// K6/K7/K2/K14/K15 16 rows of 256 threads, K3/K4/K9 40 rows of 640
constexpr int ZM_SY = 16, ZM3_SY = 40;
constexpr int ZM_PLANE = ZM_SX * ZM_SY;      // shared floats a K6/K7 plane
constexpr int ZM3_PLANE = ZM_SX * ZM3_SY;    // and a K3/K4 one
constexpr int ZM3_THREADS = ZM_QX * ZM3_SY;
static_assert(ZM_QX * ZM_SY == BLOCK, "one quad of the region a thread");

// Per kernel: the input fields it stages and how many planes ahead of
// their first read (AHEAD), and the blocks an SM must hold (MIN_BLOCKS): as
// many as the shared memory of its rings and staging allows with enough
// bytes in flight to keep HBM busy (Little's law: ~25 KB an SM; PERF.md
// section 6).  A field's staging ring holds at least AHEAD + 1 + L planes,
// L the lag of its last read behind its first (see Staging).  K6: b and
// diag, 3 ahead, 6 deep; 3 blocks an SM (72 KB each).  K7: t, x1, diag and
// b, 2 ahead, 5 deep; 2 blocks (104 KB).  K3: b (read at n = 0-2) and diag
// (n = 0-3), 4 ahead, 8 deep; one block (220 KB).  K4: t (n = 0), x1 (n =
// 1), diag (n = 1-3) and b (n = 2-3), 1 ahead (its 20 planes of 2 ahead
// would not fit), 2, 2, 4 and 4 deep; one block (180 KB).  K9: r (n = 0-2,
// as r' from n = 0 on), diag (n = 0-3) and ap (n = 0), 1 ahead (K3's 4 would
// need 26 planes of 10 KB beside the rings), 4, 8 and 2 deep; one block
// (200 KB).  K2, K14 and K15: their input (x, b, r) and diag (n = 0; step
// 1 takes what it needs of plane p - 1 from the thread's registers), 4
// ahead, 5 deep, and one ring of 2 planes; 4 blocks an SM (48 KB each: a
// fifth does not fit, so that at 300^3 the plan's 132 tiles times 8
// z-chunks make 2 whole waves).
constexpr int ZM6_AHEAD = 3, ZM6_MIN_BLOCKS = 3;
constexpr int ZM7_AHEAD = 2, ZM7_MIN_BLOCKS = 2;
constexpr int ZM3_AHEAD = 4, ZM3_MIN_BLOCKS = 1;
constexpr int ZM4_AHEAD = 1, ZM4_MIN_BLOCKS = 1;
constexpr int ZM9_AHEAD = 1;
constexpr int ZM15_AHEAD = 4, ZM15_MIN_BLOCKS = 4;

// The thread's quad: its place in the region, its domain coordinates, and
// which of its cells each step covers.  The region starts ZM_HX columns and
// H rows before the tile, so a quad lies wholly inside or wholly outside
// [0, nxp) and its global rows start on 16 bytes.
struct ZQuad {
  int q;          // float4 index in a ring plane: ly * ZM_QX + qx
  int ly, qx;     // region row and quad column
  int j, i0;      // domain y, and x of the quad's first cell
  int off;        // j * nxp + i0: the quad's offset in a padded plane
  bool field;     // the quad lies in the padded plane (0 <= j < ny, i0 < nxp)
  bool dom[4];    // each cell lies in the domain's plane (also i < nx)
  bool out;       // the quad is in the tile and the field: the last step
                  // writes it
  int sy;         // the region's rows
  // the quad's row is one of step n's, whose cells are the tile plus H - n
  // cells a side (every such row's quads hold one at least; the others'
  // values are never read)
  __device__ __forceinline__ bool rows(int n) const {
    return ly >= n && ly < sy - n;
  }
};

// The thread's quad in a region of SY rows around a tile of SY - 2 H.
template <int H, int SY>
__device__ __forceinline__ ZQuad zquad(const Geom& g) {
  ZQuad z;
  z.sy = SY;
  z.ly = (int)threadIdx.x / ZM_QX;
  z.qx = (int)threadIdx.x % ZM_QX;
  z.q = z.ly * ZM_QX + z.qx;
  z.j = (int)blockIdx.y * (SY - 2 * H) - H + z.ly;
  z.i0 = (int)blockIdx.x * ZM_TX - ZM_HX + 4 * z.qx;
  z.off = z.j * g.nxp + z.i0;
  z.field = z.j >= 0 && z.j < g.ny && z.i0 >= 0 && z.i0 < g.nxp;
#pragma unroll
  for (int l = 0; l < 4; ++l) z.dom[l] = z.field && z.i0 + l < g.nx;
  z.out = z.field && z.rows(H) && z.qx >= 1 && z.qx < ZM_QX - 1;
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

// (A u) at the four cells of quad z on domain plane k, given each cell's
// diagonal term: u's quad there (c), the cells left and right of it in its
// row, its quads in the rows below and above (ym, yp) and on the planes
// below and above (zm, zp).  Every u holds 0 outside the domain, so a
// neighbour the Neumann boundary drops reads that 0 and needs no mask; only
// the pinned origin needs a test (MatZeroRowsColumns, as in star), and only
// in the blocks whose region holds it (``pin``, uniform in a block).  A
// cell outside the step's cells gets a value that is never read.
__device__ __forceinline__ Quad star_quad(const Quad& c, float left,
                                          float right, const Quad& ym,
                                          const Quad& yp, const Quad& zm,
                                          const Quad& zp, const Quad& center,
                                          const ZQuad& z, int k, Legs a,
                                          bool pin) {
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

// star_quad of u on the middle plane of ring r (K6/K7): six neighbour
// quads and two cells read from shared memory.
__device__ __forceinline__ Quad quad_star(const Ring& r, const ZQuad& z,
                                          const Quad& center, int k, Legs a,
                                          bool pin) {
  const float* mid = r.plane(1);
  return star_quad(r.get(1, z.q), mid[4 * z.q - 1], mid[4 * z.q + 4],
                   r.get(1, z.q - ZM_QX), r.get(1, z.q + ZM_QX),
                   r.get(0, z.q), r.get(2, z.q), center, z, k, a, pin);
}

// Two shared planes of the region, of PLANE floats each (K3/K4/K9, K15): a
// step writes its newest plane into one while the next step reads the
// plane before from the other.  The next step's stencil reads only the
// rows above and below there: the thread keeps its own quads of the three
// planes it needs (its centre and z neighbours) in registers, and takes
// its x neighbours from the next lanes (row_neighbours).
template <int PLANE>
struct Ring2 {
  float* base;
  int wr;   // offset of the plane written next: 0 or PLANE
  __device__ __forceinline__ void flip() { wr = PLANE - wr; }
  __device__ __forceinline__ void put(const Quad& v, int q) const {
    reinterpret_cast<float4*>(base + wr)[q] = float4_of(v);
  }
  __device__ __forceinline__ Quad get(int q) const {
    return quad_of(reinterpret_cast<const float4*>(base + PLANE - wr)[q]);
  }
};

// The cells left and right of the thread's quad c in its region row: the
// last cell of the lane before and the first of the lane after (a warp
// holds two whole region rows).  Every lane of the warp must call it; at a
// row's ends the value is another row's, which no step's cells read.
__device__ __forceinline__ void row_neighbours(const Quad& c, float& left,
                                               float& right) {
  left = __shfl_up_sync(0xffffffffu, c.v[3], 1);
  right = __shfl_down_sync(0xffffffffu, c.v[0], 1);
}

// The pinned origin's cells, (k, j, i) with k + j + i <= 1, lie in this
// block's region and march: the first tile in y and x, and a z-chunk whose
// march (from H planes below z0) reaches domain plane 1, global plane 1 in
// the slab form, whose domain planes start at global plane zg.
template <int H>
__device__ __forceinline__ bool pins_origin(const Geom& g, int pinned,
                                            int z0, int zg = 0) {
  return pinned && blockIdx.x == 0 && blockIdx.y == 0 &&
         z0 - H + zg <= g.face + 1;
}

// Plane p of the padded field is a domain plane (k = p - face in [0, nz)).
__device__ __forceinline__ bool domain_plane(const Geom& g, int p) {
  return p >= g.face && p < g.face + g.nz;
}

// The slab form of K3/K4 (K3z/K4z, tpusparse/kernels/fused7.py's z0 and
// nzg, :367-370): the fields are q consecutive z-shards of a grid of nzg
// planes, stacked in one array of q slabs of nz + 2 face planes each.
// Slab i's domain planes are the global planes [zg0 + i nz, zg0 + (i + 1)
// nz), and its face planes the neighbouring shards' planes (zero where
// they leave the grid).  One launch covers every slab: blockIdx.z is
// i * chunks + the z-chunk within slab i (slab_of).
struct ZSlab {
  int zg0, nzg, chunks;
};

// The z-chunk of this block within its slab, and the slab's first domain
// plane's global index zg and the offset of its first plane from the
// stacked array's (64-bit, as the march's offsets).  Without SLAB the
// slab is the whole field and the chunk is blockIdx.z.
template <bool SLAB>
__device__ __forceinline__ int slab_of(const Geom& g, ZSlab s, int& zg,
                                       long long& base) {
  if constexpr (!SLAB) {
    zg = 0;
    base = 0;
    return (int)blockIdx.z;
  } else {
    const int i = (int)blockIdx.z / s.chunks;
    zg = s.zg0 + i * g.nz;
    base = (long long)i * (g.nz + 2 * g.face) * g.plane;
    return (int)blockIdx.z - i * s.chunks;
  }
}

// Plane p of a slab is read and computed on: it lies in the slab's array
// and in the global domain (global plane p - kofs in [0, nzg), kofs = face
// - zg for a slab whose domain starts at global plane zg).  A plane
// outside the array, the neighbouring slab's in the stack, is never read.
// With kofs = face and nzg = nz it is domain_plane.  The outputs stay
// local: a chained step keeps its values on such a face plane (fused7.py's
// mask_dom, :455-467), and the last step writes 0 there.
__device__ __forceinline__ bool slab_plane(const Geom& g, int kofs, int nzg,
                                           int p) {
  const int kg = p - kofs;
  return p >= 0 && p < g.nz + 2 * g.face && kg >= 0 && kg < nzg;
}

// The staging ring after the rings: input field F (0-3) keeps its last DF
// planes (at(p) is F's slot of plane p, which K9 also writes).  Plane p of the march (which starts at z0 - H) is in slot
// (p - z0 + H) % DF of F's.  Each thread copies and reads only its own
// quad, so cp_async_wait alone, with no barrier, makes a copy visible to
// its reader.  A slot is copied into again DF planes later, which must come
// after the plane's last read: DF >= A + 1 + L for a field copied A planes
// ahead of step 0 and last read L planes behind it.  A power of two makes
// the slot a mask.
template <int H, int PLANE, int D0, int D1, int D2 = 0, int D3 = 0>
struct Staging {
  static constexpr int PLANES = D0 + D1 + D2 + D3;
  static constexpr int PLANE_FLOATS = PLANE;
  float* base;
  int z0;
  template <int F>
  __device__ __forceinline__ float4* at(int p) const {
    constexpr int depth = F == 0 ? D0 : F == 1 ? D1 : F == 2 ? D2 : D3;
    constexpr int first = F == 0 ? 0 : F == 1 ? D0 : F == 2 ? D0 + D1
                                                            : D0 + D1 + D2;
    return reinterpret_cast<float4*>(
        base + (first + (unsigned)(p - z0 + H) % depth) * PLANE);
  }
  // copy the thread's quad of field F, plane p, from src, its address
  // there; with valid false, zeros (src is not read)
  template <int F>
  __device__ __forceinline__ void copy_from(const float* src, const ZQuad& z,
                                            int p, bool valid) const {
    cp_async16(at<F>(p) + z.q, src, valid ? 16 : 0);
  }
  // copy the thread's quad of field F, plane p (zeros where it has none)
  template <int F>
  __device__ __forceinline__ void copy(const float* f, const Geom& g,
                                       const ZQuad& z, int p,
                                       bool want) const {
    const bool valid = want && z.field && domain_plane(g, p);
    copy_from<F>(valid ? f + (long long)p * g.plane + z.off : f, z, p, valid);
  }
  // the thread's quad of field F on plane p as copied: zeros where it has
  // none, the field's own values at its pads (for a step whose results
  // are 0 off the domain by a select of their own)
  template <int F>
  __device__ __forceinline__ Quad raw(const ZQuad& z, int p) const {
    return quad_of(at<F>(p)[z.q]);
  }
  // the thread's quad of field F on plane p, a domain plane when dp: its
  // domain cells' values and `fill` at the others
  template <int F>
  __device__ __forceinline__ Quad get_if(const ZQuad& z, int p, bool dp,
                                         float fill) const {
    const Quad got = quad_of(at<F>(p)[z.q]);
    Quad v;
#pragma unroll
    for (int l = 0; l < 4; ++l) v.v[l] = dp && z.dom[l] ? got.v[l] : fill;
    return v;
  }
  template <int F>
  __device__ __forceinline__ Quad get(const Geom& g, const ZQuad& z, int p,
                                      float fill) const {
    return get_if<F>(z, p, domain_plane(g, p), fill);
  }
};
// K6 (b, diag), K7 (t, x1, diag, b), K3 (b, diag), K4 (t, x1, diag, b),
// K9 (r, diag, ap), K2 / K14 / K15 (x / b / r, diag)
using Staging6 = Staging<2, ZM_PLANE, ZM6_AHEAD + 3, ZM6_AHEAD + 3>;
using Staging7 = Staging<2, ZM_PLANE, ZM7_AHEAD + 3, ZM7_AHEAD + 3,
                         ZM7_AHEAD + 3, ZM7_AHEAD + 3>;
constexpr int pow2_ceil(int n) {
  return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2);
}
using Staging3 = Staging<3, ZM3_PLANE, pow2_ceil(ZM3_AHEAD + 3),
                         pow2_ceil(ZM3_AHEAD + 4)>;
using Staging4 = Staging<3, ZM3_PLANE, pow2_ceil(ZM4_AHEAD + 1),
                         pow2_ceil(ZM4_AHEAD + 1), pow2_ceil(ZM4_AHEAD + 3),
                         pow2_ceil(ZM4_AHEAD + 2)>;
using Staging9 = Staging<3, ZM3_PLANE, pow2_ceil(ZM9_AHEAD + 3),
                         pow2_ceil(ZM9_AHEAD + 4), pow2_ceil(ZM9_AHEAD + 1)>;
using Staging15 = Staging<1, ZM_PLANE, ZM15_AHEAD + 1, ZM15_AHEAD + 1>;
// the shared bytes of a kernel's rings, RINGS planes (K6/K7: two of 3;
// K3/K4/K9: three of 2; K2/K14/K15: one of 2), and its staging
constexpr int ZM_RING_PLANES = 6, ZM15_RING_PLANES = 2;
template <class St, int RINGS = ZM_RING_PLANES>
constexpr int zmarch_smem() {
  return (RINGS + St::PLANES) * St::PLANE_FLOATS * (int)sizeof(float);
}

__device__ __forceinline__ void store_quad(float* __restrict__ f,
                                           const Geom& g, const ZQuad& z,
                                           int p, const Quad& v) {
  reinterpret_cast<float4*>(f + (long long)p * g.plane + z.off)[0] =
      float4_of(v);
}

// K3/K4 address a field's quad by its offset from the field's start, p *
// plane + z.off for plane p, which they keep for the march's plane and
// advance a plane a step: no 64-bit product in the loop (PERF.md section 6).
__device__ __forceinline__ void store_quad_at(float* __restrict__ f,
                                              long long off, const Quad& v) {
  reinterpret_cast<float4*>(f + off)[0] = float4_of(v);
}

// K6 / K6': x1 = g (b D^-1);  r = b - A x1;  s = r - gw A_f (D^-1 r);
// partials of <b, b> with DOT.
template <bool DOT>
__global__ void __launch_bounds__(BLOCK, ZM6_MIN_BLOCKS)
descent1_kernel(const float* __restrict__ b, const float* __restrict__ diag,
                float* __restrict__ x1, float* __restrict__ s,
                float* __restrict__ partials, Geom g, Legs a, Legs f,
                float gg, float gw, int pinned, int zchunk) {
  constexpr int AHEAD = ZM6_AHEAD;
  extern __shared__ float4 smem4[];
  float* rings = reinterpret_cast<float*>(smem4);
  Ring xr = make_ring(rings), vr = make_ring(rings + 3 * ZM_PLANE);
  const int nzp = g.nz + 2 * g.face;
  const int z0 = (int)blockIdx.z * zchunk, z1 = min(z0 + zchunk, nzp);
  const ZQuad z = zquad<2, ZM_SY>(g);
  const bool pin = pins_origin<2>(g, pinned, z0);
  // b (field 0) and diag (field 1), staged AHEAD planes ahead: one copy
  // group a plane, empty past the march, so every wait counts alike
  const Staging6 st{rings + ZM_RING_PLANES * ZM_PLANE, z0};
  auto stage = [&](int p) {
    if (p <= z1 + 1) {
      st.copy<0>(b, g, z, p, true);
      st.copy<1>(diag, g, z, p, true);
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

    // step 0, plane p, the whole region: one reciprocal a cell, x1 =
    // g (b D^-1) (b is 0 off the domain, and so is x1); <b, b> over the
    // tile's cells of the chunk's planes
    xr.rotate();
    const Quad b0 = st.get<0>(g, z, p, 0.0f), d0 = st.get<1>(g, z, p, 1.0f);
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

    // step 1, plane p - 1, the tile plus a cell a side: r = b - A x1,
    // stored as D^-1 r (the P^T smoothing's stencil input), 0 off the domain
    vr.rotate();
    Quad r1{};
    if (p - 1 >= z0 - 1 && z.rows(1)) {
      const bool dp = domain_plane(g, p - 1);
      const Quad b1 = st.get<0>(g, z, p - 1, 0.0f);
      const Quad d1 = st.get<1>(g, z, p - 1, 1.0f);
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

    // step 2, plane p - 2, the tile: s = r - gw A_f (D^-1 r); write x1
    // (the thread's own quad of the x1 ring) and s
    if (p - 2 >= z0 && z.out) {
      const bool dp = domain_plane(g, p - 2);
      const Quad d2 = st.get<1>(g, z, p - 2, 1.0f);
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
  constexpr int AHEAD = ZM7_AHEAD;
  extern __shared__ float4 smem4[];
  float* rings = reinterpret_cast<float*>(smem4);
  Ring tr = make_ring(rings), x2r = make_ring(rings + 3 * ZM_PLANE);
  const int nzp = g.nz + 2 * g.face;
  const int z0 = (int)blockIdx.z * zchunk, z1 = min(z0 + zchunk, nzp);
  const ZQuad z = zquad<2, ZM_SY>(g);
  const bool pin = pins_origin<2>(g, pinned, z0);
  // t (field 0, every quad), x1 and diag (fields 1, 2: step 1's rows) and
  // b (field 3: the tile), staged AHEAD planes ahead
  const Staging7 st{rings + ZM_RING_PLANES * ZM_PLANE, z0};
  auto stage = [&](int p) {
    if (p <= z1 + 1) {
      st.copy<0>(t, g, z, p, true);
      st.copy<1>(x1, g, z, p, z.rows(1));
      st.copy<2>(diag, g, z, p, z.rows(1));
      st.copy<3>(b, g, z, p, z.out);
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

    // step 0, plane p: t into its ring (0 off the domain); one reciprocal
    // a cell of step 1's rows
    tr.rotate();
    tr.put(st.get<0>(g, z, p, 0.0f), z.q);
    Quad dinv0{};
    if (z.rows(1)) {
      const Quad d0 = st.get<2>(g, z, p, 1.0f);
#pragma unroll
      for (int l = 0; l < 4; ++l) dinv0.v[l] = 1.0f / d0.v[l];
    }
    __syncthreads();

    // step 1, plane p - 1, the tile plus a cell a side:
    // x2 = x1 + t - gw D^-1 (A_f t), 0 off the domain
    x2r.rotate();
    if (p - 1 >= z0 - 1 && z.rows(1)) {
      const bool dp = domain_plane(g, p - 1);
      const Quad tc = tr.get(1, z.q);
      const Quad x11 = st.get<1>(g, z, p - 1, 0.0f);
      const Quad d1 = st.get<2>(g, z, p - 1, 1.0f);
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

    // step 2, plane p - 2, the tile: x3 = x2 + g D^-1 (b - A x2)
    if (p - 2 >= z0 && z.out) {
      const bool dp = domain_plane(g, p - 2);
      const Quad x2 = x2r.get(1, z.q);
      const Quad d2 = st.get<2>(g, z, p - 2, 1.0f);
      const Quad b2 = st.get<3>(g, z, p - 2, 0.0f);
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

// K3 / K3': u = (s0 b) D^-1;  x1 = u + ad u + g D^-1 (b - A u);
// r = b - A x1;  s = r - gw A_f (D^-1 r);  partials of <b, b> with DOT.
// K9 (UPDATE, always with DOT): b is r' = r - alpha ap, formed at step 0
// from the staged r (``b``) and ``ap``, written to ``r_new`` on the tile;
// partials of <r', r'>.  K3 passes ap, alpha_p and r_new as nullptr.
// K3z (SLAB, dot-free): K3' on each of the q stacked z-shards (ZSlab) in
// one launch: b's face planes hold the neighbours' planes, the steps read
// and compute on every slab_plane and mask the pin in global planes, and
// x1 and s are 0 on the face planes.
template <bool DOT, bool UPDATE, bool SLAB = false>
__global__ void __launch_bounds__(ZM3_THREADS, ZM3_MIN_BLOCKS)
descent_kernel(const float* __restrict__ b, const float* __restrict__ ap,
               const float* __restrict__ alpha_p,
               const float* __restrict__ diag, float* __restrict__ x1,
               float* __restrict__ s, float* __restrict__ r_new,
               float* __restrict__ partials, Geom g, Legs a, Legs f,
               float s0, float ad, float gg, float gw, int pinned,
               int zchunk, ZSlab zs) {
  constexpr int H = 3, AHEAD = UPDATE ? ZM9_AHEAD : ZM3_AHEAD;
  using St = std::conditional_t<UPDATE, Staging9, Staging3>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  Ring2<ZM3_PLANE> ur{sm, 0}, xr{sm + 2 * ZM3_PLANE, 0},
      vr{sm + 4 * ZM3_PLANE, 0};
  const int nzp = g.nz + 2 * g.face;
  // the block's slab (its global placement and offset in the stack, read
  // before the pin test and the first stage) and its z-chunk there
  int zg;
  long long base;
  const int z0 = slab_of<SLAB>(g, zs, zg, base) * zchunk,
            z1 = min(z0 + zchunk, nzp);
  const ZQuad z = zquad<H, ZM3_SY>(g);
  const bool pin = pins_origin<H>(g, pinned, z0, zg);
  // the (global) domain plane index of padded plane p, p - kofs, and the
  // planes the steps read and compute on (the slab's placement kept in
  // kofs alone: one register)
  const int kofs = g.face - zg;
  auto live = [&](int p) {
    return SLAB ? slab_plane(g, kofs, zs.nzg, p) : domain_plane(g, p);
  };
  const float alpha = UPDATE ? *alpha_p : 0.0f;
  // b (field 0), diag (field 1) and K9's ap (field 2), every quad, staged
  // AHEAD planes ahead: one copy group a plane, empty past the march, so
  // every wait counts alike
  const St st{sm + ZM_RING_PLANES * ZM3_PLANE, z0};
  const long long plane = g.plane;
  auto stage = [&](int p, long long off) {
    if (p <= z1 + H - 1) {
      const bool valid = z.field && live(p);
      st.template copy_from<0>(valid ? b + off : b, z, p, valid);
      st.template copy_from<1>(valid ? diag + off : diag, z, p, valid);
      if constexpr (UPDATE)
        st.template copy_from<2>(valid ? ap + off : ap, z, p, valid);
    }
    cp_async_commit();
  };
  // the quad's offset in the stack, plane p of the block's slab
  long long off = base + (long long)(z0 - H) * plane + z.off;
#pragma unroll
  for (int n = 0; n < AHEAD; ++n) stage(z0 - H + n, off + n * plane);

  // the thread's own quads, kept from earlier planes: u of planes p - 2,
  // p - 1; x1 of p - 3, p - 2; D^-1 r of p - 4, p - 3; D^-1 of p - 1,
  // p - 2; r of p - 3
  Quad um{}, uc{}, xm{}, xc{}, vm{}, vc{}, dinv1{}, dinv2{}, r3{};
  float dot = 0.0f, left, right;
  // unrolled twice: 5-10% faster at 300^3 (PERF.md section 6)
#pragma unroll 2
  for (int p = z0 - H; p <= z1 + H - 1; ++p, off += plane) {
    stage(p + AHEAD, off + AHEAD * plane);
    cp_async_wait<AHEAD>();
    ur.flip();
    xr.flip();
    vr.flip();

    // step 0, plane p, the whole region: K9's r' = r - alpha ap (0 off the
    // domain, as r and ap are), kept in r's staging slot for steps 1-2 and
    // written on the tile; one reciprocal a cell, u = (s0 b) D^-1 (b is 0
    // off the domain, and so is u); <b, b> over the tile's cells of the
    // chunk's planes
    const bool dp0 = live(p);
    Quad b0 = st.template get_if<0>(z, p, dp0, 0.0f);
    const Quad d0 = st.template get_if<1>(z, p, dp0, 1.0f);
    if constexpr (UPDATE) {
      const Quad ap0 = st.template get<2>(g, z, p, 0.0f);
#pragma unroll
      for (int l = 0; l < 4; ++l) b0.v[l] = b0.v[l] - alpha * ap0.v[l];
      st.template at<0>(p)[z.q] = float4_of(b0);
    }
    Quad dinv0, u0;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      dinv0.v[l] = 1.0f / d0.v[l];
      u0.v[l] = (s0 * b0.v[l]) * dinv0.v[l];
    }
    if (z.out && p >= z0 && p < z1) {
      if constexpr (DOT) {
#pragma unroll
        for (int l = 0; l < 4; ++l) dot += b0.v[l] * b0.v[l];
      }
      if constexpr (UPDATE) store_quad_at(r_new, off, b0);
    }
    ur.put(u0, z.q);

    // step 1, plane p - 1, the tile plus 2 cells a side:
    // x1 = u + ad u + g D^-1 (b - A u), 0 off the domain
    row_neighbours(uc, left, right);
    Quad x1n{};
    if (p - 1 >= z0 - 2 && z.rows(1)) {
      const bool dp = live(p - 1);
      const Quad b1 = st.template raw<0>(z, p - 1);
      const Quad d1 = st.template raw<1>(z, p - 1);
      Quad center;
#pragma unroll
      for (int l = 0; l < 4; ++l) center.v[l] = d1.v[l] * uc.v[l];
      const Quad w = star_quad(uc, left, right, ur.get(z.q - ZM_QX),
                               ur.get(z.q + ZM_QX), um, u0, center, z,
                               p - 1 - kofs, a, pin);
#pragma unroll
      for (int l = 0; l < 4; ++l)
        x1n.v[l] = dp && z.dom[l]
                       ? uc.v[l] + ad * uc.v[l] +
                             gg * (dinv1.v[l] * (b1.v[l] - w.v[l]))
                       : 0.0f;
      xr.put(x1n, z.q);
    }

    // step 2, plane p - 2, the tile plus a cell a side: r = b - A x1,
    // kept, and D^-1 r (the P^T smoothing's stencil input), 0 off the domain
    row_neighbours(xc, left, right);
    Quad r2{}, vn{};
    if (p - 2 >= z0 - 1 && z.rows(2)) {
      const bool dp = live(p - 2);
      const Quad b2 = st.template raw<0>(z, p - 2);
      const Quad d2 = st.template raw<1>(z, p - 2);
      Quad center;
#pragma unroll
      for (int l = 0; l < 4; ++l) center.v[l] = d2.v[l] * xc.v[l];
      const Quad w = star_quad(xc, left, right, xr.get(z.q - ZM_QX),
                               xr.get(z.q + ZM_QX), xm, x1n, center, z,
                               p - 2 - kofs, a, pin);
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        r2.v[l] = dp && z.dom[l] ? b2.v[l] - w.v[l] : 0.0f;
        vn.v[l] = r2.v[l] * dinv2.v[l];
      }
      vr.put(vn, z.q);
    }

    // step 3, plane p - 3, the tile: s = r - gw A_f (D^-1 r); write x1
    // and s
    row_neighbours(vc, left, right);
    if (p - 3 >= z0 && z.out) {
      const bool dp = domain_plane(g, p - 3);
      const Quad d3 = st.template raw<1>(z, p - 3);
      Quad center, so;
#pragma unroll
      for (int l = 0; l < 4; ++l) center.v[l] = d3.v[l] * vc.v[l];
      const Quad w = star_quad(vc, left, right, vr.get(z.q - ZM_QX),
                               vr.get(z.q + ZM_QX), vm, vn, center, z,
                               p - 3 - kofs, f, pin);
#pragma unroll
      for (int l = 0; l < 4; ++l)
        so.v[l] = dp && z.dom[l] ? r3.v[l] - gw * w.v[l] : 0.0f;
      // x1 is 0 off the domain but, in the slab form, on the face planes
      store_quad_at(x1, off - 3 * plane, SLAB && !dp ? Quad{} : xm);
      store_quad_at(s, off - 3 * plane, so);
    }
    um = uc;
    uc = u0;
    xm = xc;
    xc = x1n;
    vm = vc;
    vc = vn;
    r3 = r2;
    dinv2 = dinv1;
    dinv1 = dinv0;
    // the one barrier a plane: the planes this iteration's steps wrote are
    // the next one's stencil inputs, and the planes they read its outputs
    __syncthreads();
  }
  if constexpr (DOT)
    block_partial_at<ZM3_THREADS>(
        dot, partials,
        (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x);
}

// K4 / K4': x2 = x1 + t - gw D^-1 (A_f t);  d = g D^-1 (b - A x2);
// x3 = x2 + d;  x4 = x3 + ad d + g2 D^-1 (b - A x3);  partials of <b, x4>
// with DOT.  K4z (SLAB, dot-free): K4' on each stacked z-shard, as K3z is
// K3''s (t, x1, b and diag carry the neighbours' planes on their face
// planes).
template <bool DOT, bool SLAB = false>
__global__ void __launch_bounds__(ZM3_THREADS, ZM4_MIN_BLOCKS)
ascent_kernel(const float* __restrict__ t, const float* __restrict__ b,
              const float* __restrict__ x1, const float* __restrict__ diag,
              float* __restrict__ x4, float* __restrict__ partials, Geom g,
              Legs a, Legs f, float gg, float ad, float g2, float gw,
              int pinned, int zchunk, ZSlab zs) {
  constexpr int H = 3, AHEAD = ZM4_AHEAD;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  Ring2<ZM3_PLANE> tr{sm, 0}, x2r{sm + 2 * ZM3_PLANE, 0},
      x3r{sm + 4 * ZM3_PLANE, 0};
  const int nzp = g.nz + 2 * g.face;
  // as in descent_kernel
  int zg;
  long long base;
  const int z0 = slab_of<SLAB>(g, zs, zg, base) * zchunk,
            z1 = min(z0 + zchunk, nzp);
  const ZQuad z = zquad<H, ZM3_SY>(g);
  const bool pin = pins_origin<H>(g, pinned, z0, zg);
  const int kofs = g.face - zg;
  auto live = [&](int p) {
    return SLAB ? slab_plane(g, kofs, zs.nzg, p) : domain_plane(g, p);
  };
  // each field copied AHEAD planes before its first read: t (field 0,
  // every quad) of plane p, x1 and diag (fields 1, 2: step 1's rows) of
  // p - 1, b (field 3: step 2's rows) of p - 2; none below the march
  const Staging4 st{sm + ZM_RING_PLANES * ZM3_PLANE, z0};
  const long long plane = g.plane;
  auto stage = [&](int p, long long off) {
    if (p <= z1 + H - 1) {
      const bool valid = z.field && live(p);
      st.copy_from<0>(valid ? t + off : t, z, p, valid);
    }
    if (p - 1 >= z0 - H) {
      const bool valid = z.rows(1) && z.field && live(p - 1);
      st.copy_from<1>(valid ? x1 + (off - plane) : x1, z, p - 1, valid);
      st.copy_from<2>(valid ? diag + (off - plane) : diag, z, p - 1, valid);
    }
    if (p - 2 >= z0 - H) {
      const bool valid = z.rows(2) && z.field && live(p - 2);
      st.copy_from<3>(valid ? b + (off - 2 * plane) : b, z, p - 2, valid);
    }
    cp_async_commit();
  };
  long long off = base + (long long)(z0 - H) * plane + z.off;   // as K3's
#pragma unroll
  for (int n = 0; n < AHEAD; ++n) stage(z0 - H + n, off + n * plane);

  // the thread's own quads, kept from earlier planes: t of planes p - 2,
  // p - 1; x2 of p - 3, p - 2; x3 of p - 4, p - 3; D^-1 of p - 2, p - 3;
  // d of p - 3
  Quad tm{}, tc{}, x2m{}, x2c{}, x3m{}, x3c{}, dinv2{}, dinv3{}, d3{};
  float dot = 0.0f, left, right;
  // unrolled twice, as in descent_kernel
#pragma unroll 2
  for (int p = z0 - H; p <= z1 + H - 1; ++p, off += plane) {
    stage(p + AHEAD, off + AHEAD * plane);
    cp_async_wait<AHEAD>();
    tr.flip();
    x2r.flip();
    x3r.flip();

    // step 0, plane p: t into its ring (0 off the domain)
    const Quad t0 = st.get_if<0>(z, p, live(p), 0.0f);
    tr.put(t0, z.q);

    // step 1, plane p - 1, the tile plus 2 cells a side: one reciprocal a
    // cell; x2 = x1 + t - gw D^-1 (A_f t), 0 off the domain
    row_neighbours(tc, left, right);
    Quad dinv1{}, x2n{};
    if (p - 1 >= z0 - 2 && z.rows(1)) {
      const bool dp = live(p - 1);
      const Quad x11 = st.raw<1>(z, p - 1), d1 = st.raw<2>(z, p - 1);
      Quad center;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        dinv1.v[l] = 1.0f / d1.v[l];
        center.v[l] = d1.v[l] * tc.v[l];
      }
      const Quad w = star_quad(tc, left, right, tr.get(z.q - ZM_QX),
                               tr.get(z.q + ZM_QX), tm, t0, center, z,
                               p - 1 - kofs, f, pin);
#pragma unroll
      for (int l = 0; l < 4; ++l)
        x2n.v[l] = dp && z.dom[l]
                       ? x11.v[l] + tc.v[l] - gw * (dinv1.v[l] * w.v[l])
                       : 0.0f;
      x2r.put(x2n, z.q);
    }

    // step 2, plane p - 2, the tile plus a cell a side:
    // d = g D^-1 (b - A x2), kept;  x3 = x2 + d; both 0 off the domain
    row_neighbours(x2c, left, right);
    Quad d2{}, x3n{};
    if (p - 2 >= z0 - 1 && z.rows(2)) {
      const bool dp = live(p - 2);
      const Quad dg2 = st.raw<2>(z, p - 2), b2 = st.raw<3>(z, p - 2);
      Quad center;
#pragma unroll
      for (int l = 0; l < 4; ++l) center.v[l] = dg2.v[l] * x2c.v[l];
      const Quad w = star_quad(x2c, left, right, x2r.get(z.q - ZM_QX),
                               x2r.get(z.q + ZM_QX), x2m, x2n, center, z,
                               p - 2 - kofs, a, pin);
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const bool in = dp && z.dom[l];
        d2.v[l] = in ? gg * (dinv2.v[l] * (b2.v[l] - w.v[l])) : 0.0f;
        x3n.v[l] = in ? x2c.v[l] + d2.v[l] : 0.0f;
      }
      x3r.put(x3n, z.q);
    }

    // step 3, plane p - 3, the tile: x4 = x3 + ad d + g2 D^-1 (b - A x3)
    row_neighbours(x3c, left, right);
    if (p - 3 >= z0 && z.out) {
      const bool dp = domain_plane(g, p - 3);
      const Quad dg3 = st.raw<2>(z, p - 3);
      const Quad b3 = st.get<3>(g, z, p - 3, 0.0f);
      Quad center, out;
#pragma unroll
      for (int l = 0; l < 4; ++l) center.v[l] = dg3.v[l] * x3c.v[l];
      const Quad w = star_quad(x3c, left, right, x3r.get(z.q - ZM_QX),
                               x3r.get(z.q + ZM_QX), x3m, x3n, center, z,
                               p - 3 - kofs, a, pin);
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        out.v[l] = dp && z.dom[l]
                       ? x3c.v[l] + ad * d3.v[l] +
                             g2 * (dinv3.v[l] * (b3.v[l] - w.v[l]))
                       : 0.0f;
        if constexpr (DOT) dot += b3.v[l] * out.v[l];
      }
      store_quad_at(x4, off - 3 * plane, out);
    }
    tm = tc;
    tc = t0;
    x2m = x2c;
    x2c = x2n;
    x3m = x3c;
    x3c = x3n;
    d3 = d2;
    dinv3 = dinv2;
    dinv2 = dinv1;
    // the one barrier a plane (as in descent_kernel)
    __syncthreads();
  }
  if constexpr (DOT)
    block_partial_at<ZM3_THREADS>(
        dot, partials,
        (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x);
}

// The halo-1 marches, two steps a plane: K15 restrict, K2 mvdot and K14
// pre2, one loop with the mode as a template parameter.
enum class Halo1 { RESTRICT, MVDOT, PRE2 };

// One block's march of a halo-1 kernel (``in``: K15's r, K2's x, K14's b):
//   K15 restrict, the P^T smoothing pass: u = D^-1 r, one reciprocal a
//     cell; out = s = r - gg A u (A: the filtered legs ``a``, gg: gw), the
//     centre term r itself (diag (D^-1 r) == r, as fused7_xla's mode has
//     it);
//   K2 mvdot: out = y = A x, the centre term diag x (the TPU's diag *
//     win(p, 1, 0) and the twin's), and <x, y> over the domain cells into
//     partials, one a block;
//   K14 pre2, both Chebyshev pre-smoothing steps from a zero guess: one
//     reciprocal a cell, u = (s0 b) D^-1; out = x' = u + d' and dout = d' =
//     ad u + gg D^-1 (b - A u), the centre term of A u the Pallas kernel's
//     s0 b (fused7.py:569; the twin's diag ((s0 b) D^-1) is an ulp away).
// Step 0 puts plane p's u (K2: x) into the ring; step 1 applies the star
// at plane p - 1 and writes the tile, 0 off the domain.  A thread carries
// what step 1 needs of its own quad of plane p - 1 in registers (u, and
// K15's r, K2's diag x, K14's b and D^-1): no second divide, and no
// staging slot read after its plane's step 0.
template <Halo1 MODE>
__device__ __forceinline__ void march1(const float* __restrict__ in,
                                       const float* __restrict__ diag,
                                       float* __restrict__ out,
                                       float* __restrict__ dout,
                                       float* __restrict__ partials, Geom g,
                                       Legs a, float s0, float ad, float gg,
                                       int pinned, int zchunk) {
  constexpr int H = 1, AHEAD = ZM15_AHEAD;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  Ring2<ZM_PLANE> ur{sm, 0};
  const int nzp = g.nz + 2 * g.face;
  const int z0 = (int)blockIdx.z * zchunk, z1 = min(z0 + zchunk, nzp);
  const ZQuad z = zquad<H, ZM_SY>(g);
  const bool pin = pins_origin<H>(g, pinned, z0);
  // the input (field 0) and diag (field 1), every quad, staged AHEAD
  // planes ahead
  const Staging15 st{sm + ZM15_RING_PLANES * ZM_PLANE, z0};
  const long long plane = g.plane;
  auto stage = [&](int p, long long off) {
    if (p <= z1 + H - 1) {
      const bool valid = z.field && domain_plane(g, p);
      st.copy_from<0>(valid ? in + off : in, z, p, valid);
      st.copy_from<1>(valid ? diag + off : diag, z, p, valid);
    }
    cp_async_commit();
  };
  long long off = (long long)(z0 - H) * plane + z.off;   // the quad's, plane p
#pragma unroll
  for (int n = 0; n < AHEAD; ++n) stage(z0 - H + n, off + n * plane);

  // the thread's own quads, kept from earlier planes: u of planes p - 2,
  // p - 1; of p - 1 also K15's r / K2's diag x / K14's b (c) and K14's D^-1
  Quad um{}, uc{}, cc{}, dinvc{};
  float dot = 0.0f, left, right;
  for (int p = z0 - H; p <= z1 + H - 1; ++p, off += plane) {
    stage(p + AHEAD, off + AHEAD * plane);
    cp_async_wait<AHEAD>();
    ur.flip();

    // step 0, plane p, the whole region: u (0 off the domain)
    const Quad in0 = st.get<0>(g, z, p, 0.0f);
    Quad u0, c0, dinv0;
    if constexpr (MODE == Halo1::MVDOT) {
      const Quad d0 = st.raw<1>(z, p);
#pragma unroll
      for (int l = 0; l < 4; ++l) c0.v[l] = d0.v[l] * in0.v[l];
      u0 = in0;
    } else {
      const Quad d0 = st.get<1>(g, z, p, 1.0f);
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        dinv0.v[l] = 1.0f / d0.v[l];
        u0.v[l] = MODE == Halo1::PRE2 ? (s0 * in0.v[l]) * dinv0.v[l]
                                      : in0.v[l] * dinv0.v[l];
      }
      c0 = in0;
    }
    ur.put(u0, z.q);

    // step 1, plane p - 1, the tile
    row_neighbours(uc, left, right);
    if (p - 1 >= z0 && z.out) {
      const bool dp = domain_plane(g, p - 1);
      Quad center = cc;
      if constexpr (MODE == Halo1::PRE2) {
#pragma unroll
        for (int l = 0; l < 4; ++l) center.v[l] = s0 * cc.v[l];
      }
      const Quad w = star_quad(uc, left, right, ur.get(z.q - ZM_QX),
                               ur.get(z.q + ZM_QX), um, u0, center, z,
                               p - 1 - g.face, a, pin);
      Quad o, d;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const bool cell_in = dp && z.dom[l];
        if constexpr (MODE == Halo1::RESTRICT) {
          o.v[l] = cell_in ? cc.v[l] - gg * w.v[l] : 0.0f;
        } else if constexpr (MODE == Halo1::MVDOT) {
          o.v[l] = cell_in ? w.v[l] : 0.0f;
          dot += uc.v[l] * o.v[l];
        } else {
          d.v[l] = cell_in ? ad * uc.v[l] + gg * (dinvc.v[l] * (cc.v[l] - w.v[l]))
                           : 0.0f;
          o.v[l] = cell_in ? uc.v[l] + d.v[l] : 0.0f;
        }
      }
      store_quad_at(out, off - plane, o);
      if constexpr (MODE == Halo1::PRE2) store_quad_at(dout, off - plane, d);
    }
    um = uc;
    uc = u0;
    cc = c0;
    if constexpr (MODE == Halo1::PRE2) dinvc = dinv0;
    // the one barrier a plane, as in descent_kernel
    __syncthreads();
  }
  if constexpr (MODE == Halo1::MVDOT)
    block_partial_at(dot, partials,
                     (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                         blockIdx.x);
}

// K15 restrict: s = r - gw A_f (D^-1 r).
__global__ void __launch_bounds__(BLOCK, ZM15_MIN_BLOCKS)
restrict_kernel(const float* __restrict__ r, const float* __restrict__ diag,
                float* __restrict__ s, Geom g, Legs f, float gw, int pinned,
                int zchunk) {
  march1<Halo1::RESTRICT>(r, diag, s, nullptr, nullptr, g, f, 0.0f, 0.0f, gw,
                          pinned, zchunk);
}

// K2 mvdot: y = A x and partials of <x, A x> (the CG alpha denominator).
__global__ void __launch_bounds__(BLOCK, ZM15_MIN_BLOCKS)
mvdot_kernel(const float* __restrict__ x, const float* __restrict__ diag,
             float* __restrict__ y, float* __restrict__ partials, Geom g,
             Legs a, int pinned, int zchunk) {
  march1<Halo1::MVDOT>(x, diag, y, nullptr, partials, g, a, 0.0f, 0.0f, 0.0f,
                       pinned, zchunk);
}

// K14 pre2: u = (s0 b) D^-1;  d' = ad u + g D^-1 (b - A u);  x' = u + d'.
__global__ void __launch_bounds__(BLOCK, ZM15_MIN_BLOCKS)
pre2_kernel(const float* __restrict__ b, const float* __restrict__ diag,
            float* __restrict__ xo, float* __restrict__ dout, Geom g, Legs a,
            float s0, float ad, float gg, int pinned, int zchunk) {
  march1<Halo1::PRE2>(b, diag, xo, dout, nullptr, g, a, s0, ad, gg, pinned,
                      zchunk);
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

// Every P-smoothing stage below takes the filtered legs f (fcx, fcy, fcz):
// the -pc_gamg_threshold prolongator smoother (fused7.py:359-365), equal
// to the operator's legs a when nothing is filtered.

// The z-marching plan the wrapper computed (kernels/fused7.py::zmarch_plan)
// must cover the padded field exactly once, with the tile of a kernel of
// halo H in a region of ROWS rows, and give that kernel's shared bytes
// (zmarch_smem).
static bool zmarch_plan_ok(const Geom& g, int halo, int rows,
                           int kernel_smem, int tiles_x, int tiles_y,
                           int chunks, int zchunk, int smem_bytes) {
  const int nzp = g.nz + 2 * g.face, ty = rows - 2 * halo;
  return zchunk > 0 && tiles_x == (g.nxp + ZM_TX - 1) / ZM_TX &&
         tiles_y == (g.ny + ty - 1) / ty &&
         chunks == (nzp + zchunk - 1) / zchunk && smem_bytes == kernel_smem;
}

// Launch a z-marching kernel of THREADS threads a block on the plan's grid,
// its dynamic shared memory allowed past the default 48 KB first.
template <int THREADS, class Kernel, class... Args>
static int zmarch_launch(Kernel kernel, int tiles_x, int tiles_y, int chunks,
                         int smem_bytes, cudaStream_t st, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(tiles_x, tiles_y, chunks), THREADS, smem_bytes, st>>>(
      args...);
  return (int)cudaGetLastError();
}

// The q stacked slabs of (nz, zg0, nzg): slab i's domain planes are the
// global planes [zg0 + i nz, zg0 + (i + 1) nz) of a grid of nzg; (0, nz,
// q = 1) is the whole grid, the unsharded kernels' case.  Slabs the global
// grid does not hold (the last one's end checked), or more than a grid's z
// extent of blocks (q times the chunks), are refused.
static bool slab_ok(int nz, int zg0, int nzg, int q, int chunks) {
  return zg0 >= 0 && nz > 0 && q > 0 && zg0 + (long long)q * nz <= nzg &&
         (long long)q * chunks <= 65535;
}
static bool is_slab(int nz, int zg0, int nzg, int q) {
  return zg0 != 0 || nzg != nz || q != 1;
}

// K3 (descent_rr) with partials, K3' (descent) with partials == nullptr:
// one launch of the plan's grid, one partial a block.  K3z, K3' on the q
// stacked slabs (zg0, nzg) of a z-sharded grid, where that is not the
// whole grid (dot-free only): one launch of q times the plan's z-chunks,
// the plan's chunks covering each slab's padded depth.
extern "C" int tps_descent(const float* b, const float* diag, float* x1,
                           float* s, float* partials, int nz, int ny, int nx,
                           int nxp, float cx, float cy, float cz, float fcx,
                           float fcy, float fcz, float s0, float ad, float gg,
                           float gw, int pinned, int zg0, int nzg, int q,
                           int tiles_x, int tiles_y, int chunks, int zchunk,
                           int smem_bytes, void* stream) {
  const Geom g = make_geom(nz, ny, nx, nxp);
  const bool slab = is_slab(nz, zg0, nzg, q);
  if (!zmarch_plan_ok(g, 3, ZM3_SY, zmarch_smem<Staging3>(), tiles_x,
                      tiles_y, chunks, zchunk, smem_bytes) ||
      !slab_ok(nz, zg0, nzg, q, chunks) || (slab && partials))
    return (int)cudaErrorInvalidValue;
  const Legs a{cx, cy, cz}, f{fcx, fcy, fcz};
  return zmarch_launch<ZM3_THREADS>(
      slab ? descent_kernel<false, false, true>
           : partials ? descent_kernel<true, false>
                      : descent_kernel<false, false>,
      tiles_x, tiles_y, q * chunks, smem_bytes, (cudaStream_t)stream, b,
      (const float*)nullptr, (const float*)nullptr, diag, x1, s,
      (float*)nullptr, partials, g, a, f, s0, ad, gg, gw, pinned, zchunk,
      ZSlab{zg0, nzg, chunks});
}

// K4 (ascent_rz) with partials, K4' (ascent) with partials == nullptr, and
// K4z, K4' on q stacked slabs, as tps_descent.
extern "C" int tps_ascent(const float* t, const float* b, const float* x1,
                          const float* diag, float* x4, float* partials,
                          int nz, int ny, int nx, int nxp, float cx, float cy,
                          float cz, float fcx, float fcy, float fcz, float gg,
                          float ad, float g2, float gw, int pinned, int zg0,
                          int nzg, int q, int tiles_x, int tiles_y,
                          int chunks, int zchunk, int smem_bytes,
                          void* stream) {
  const Geom g = make_geom(nz, ny, nx, nxp);
  const bool slab = is_slab(nz, zg0, nzg, q);
  if (!zmarch_plan_ok(g, 3, ZM3_SY, zmarch_smem<Staging4>(), tiles_x,
                      tiles_y, chunks, zchunk, smem_bytes) ||
      !slab_ok(nz, zg0, nzg, q, chunks) || (slab && partials))
    return (int)cudaErrorInvalidValue;
  const Legs a{cx, cy, cz}, f{fcx, fcy, fcz};
  return zmarch_launch<ZM3_THREADS>(
      slab ? ascent_kernel<false, true>
           : partials ? ascent_kernel<true> : ascent_kernel<false>,
      tiles_x, tiles_y, q * chunks, smem_bytes, (cudaStream_t)stream, t, b,
      x1, diag, x4, partials, g, a, f, gg, ad, g2, gw, pinned, zchunk,
      ZSlab{zg0, nzg, chunks});
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
  if (!zmarch_plan_ok(g, 2, ZM_SY, zmarch_smem<Staging6>(), tiles_x,
                      tiles_y, chunks, zchunk, smem_bytes))
    return (int)cudaErrorInvalidValue;
  const Legs a{cx, cy, cz}, f{fcx, fcy, fcz};
  return zmarch_launch<BLOCK>(
      partials ? descent1_kernel<true> : descent1_kernel<false>, tiles_x,
      tiles_y, chunks, smem_bytes, (cudaStream_t)stream, b, diag, x1, s,
      partials, g, a, f, gg, gw, pinned, zchunk);
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
  if (!zmarch_plan_ok(g, 2, ZM_SY, zmarch_smem<Staging7>(), tiles_x,
                      tiles_y, chunks, zchunk, smem_bytes))
    return (int)cudaErrorInvalidValue;
  const Legs a{cx, cy, cz}, f{fcx, fcy, fcz};
  return zmarch_launch<BLOCK>(
      partials ? ascent1_kernel<true> : ascent1_kernel<false>, tiles_x,
      tiles_y, chunks, smem_bytes, (cudaStream_t)stream, t, b, x1, diag, x3,
      partials, g, a, f, gg, gw, pinned, zchunk);
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

// K9 descentu: one launch of the plan's grid (K3's kernel with the residual
// update r' = r_old - alpha ap), one partial of <r', r'> a block.
extern "C" int tps_descentu(const float* r_old, const float* ap,
                            const float* alpha, const float* diag, float* x1,
                            float* s, float* r_new, float* partials, int nz,
                            int ny, int nx, int nxp, float cx, float cy,
                            float cz, float fcx, float fcy, float fcz,
                            float s0, float ad, float gg, float gw,
                            int pinned, int tiles_x, int tiles_y, int chunks,
                            int zchunk, int smem_bytes, void* stream) {
  const Geom g = make_geom(nz, ny, nx, nxp);
  if (!zmarch_plan_ok(g, 3, ZM3_SY, zmarch_smem<Staging9>(), tiles_x,
                      tiles_y, chunks, zchunk, smem_bytes))
    return (int)cudaErrorInvalidValue;
  const Legs a{cx, cy, cz}, f{fcx, fcy, fcz};
  return zmarch_launch<ZM3_THREADS>(
      descent_kernel<true, true>, tiles_x, tiles_y, chunks, smem_bytes,
      (cudaStream_t)stream, r_old, ap, alpha, diag, x1, s, r_new, partials,
      g, a, f, s0, ad, gg, gw, pinned, zchunk, ZSlab{0, nz, chunks});
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

// The halo-1 kernels' plan: K15's region, staging, ring and shared bytes.
static bool march1_plan_ok(const Geom& g, int tiles_x, int tiles_y,
                           int chunks, int zchunk, int smem_bytes) {
  return zmarch_plan_ok(g, 1, ZM_SY,
                        zmarch_smem<Staging15, ZM15_RING_PLANES>(), tiles_x,
                        tiles_y, chunks, zchunk, smem_bytes);
}

// K15 restrict: s = r - g A_f (D^-1 r); (fcx, fcy, fcz) are A_f's legs.
// One z-marching launch of the plan's grid.
extern "C" int tps_restrict(const float* r, const float* diag, float* s,
                            int nz, int ny, int nx, int nxp, float fcx,
                            float fcy, float fcz, float gg, int pinned,
                            int tiles_x, int tiles_y, int chunks, int zchunk,
                            int smem_bytes, void* stream) {
  const Geom g = make_geom(nz, ny, nx, nxp);
  if (!march1_plan_ok(g, tiles_x, tiles_y, chunks, zchunk, smem_bytes))
    return (int)cudaErrorInvalidValue;
  return zmarch_launch<BLOCK>(restrict_kernel, tiles_x, tiles_y, chunks,
                              smem_bytes, (cudaStream_t)stream, r, diag, s, g,
                              Legs{fcx, fcy, fcz}, gg, pinned, zchunk);
}

// K2 mvdot: one z-marching launch of the plan's grid, one partial of
// <x, A x> a block.
extern "C" int tps_mvdot(const float* x, const float* diag, float* y,
                         float* partials, int nz, int ny, int nx, int nxp,
                         float cx, float cy, float cz, int pinned,
                         int tiles_x, int tiles_y, int chunks, int zchunk,
                         int smem_bytes, void* stream) {
  const Geom g = make_geom(nz, ny, nx, nxp);
  if (!march1_plan_ok(g, tiles_x, tiles_y, chunks, zchunk, smem_bytes))
    return (int)cudaErrorInvalidValue;
  return zmarch_launch<BLOCK>(mvdot_kernel, tiles_x, tiles_y, chunks,
                              smem_bytes, (cudaStream_t)stream, x, diag, y,
                              partials, g, Legs{cx, cy, cz}, pinned, zchunk);
}

// K14 pre2: one z-marching launch of the plan's grid.
extern "C" int tps_pre2(const float* b, const float* diag, float* xo,
                        float* dout, int nz, int ny, int nx, int nxp,
                        float cx, float cy, float cz, float s0, float ad,
                        float gg, int pinned, int tiles_x, int tiles_y,
                        int chunks, int zchunk, int smem_bytes,
                        void* stream) {
  const Geom g = make_geom(nz, ny, nx, nxp);
  if (!march1_plan_ok(g, tiles_x, tiles_y, chunks, zchunk, smem_bytes))
    return (int)cudaErrorInvalidValue;
  return zmarch_launch<BLOCK>(pre2_kernel, tiles_x, tiles_y, chunks,
                              smem_bytes, (cudaStream_t)stream, b, diag, xo,
                              dout, g, Legs{cx, cy, cz}, s0, ad, gg, pinned,
                              zchunk);
}

// K16 prolong: out = t - g D^-1 (A_f t).
extern "C" int tps_prolong(const float* t, const float* diag, float* out,
                           int nz, int ny, int nx, int nxp, float fcx,
                           float fcy, float fcz, float gg, int pinned,
                           void* stream) {
  const Geom g = make_geom(nz, ny, nx, nxp);
  prolong_kernel<<<grid_blocks(g), BLOCK, 0, (cudaStream_t)stream>>>(
      t, diag, out, g, Legs{fcx, fcy, fcz}, gg, pinned);
  return (int)cudaGetLastError();
}

// Registers a thread, spilled (local) bytes a thread and static shared
// bytes a block of z-marching kernel `which`: 0-13 are K3, K3', K4, K4',
// K6, K6', K7, K7', K9, K15, K2, K14, K3z, K4z
// (kernels/fused7.py::zmarch_attributes).
extern "C" int tps_zmarch_attributes(int which, int* regs, int* local_bytes,
                                     int* static_smem) {
  const void* kernels[] = {
      (const void*)descent_kernel<true, false>,
      (const void*)descent_kernel<false, false>,
      (const void*)ascent_kernel<true>,
      (const void*)ascent_kernel<false>,
      (const void*)descent1_kernel<true>,
      (const void*)descent1_kernel<false>,
      (const void*)ascent1_kernel<true>,
      (const void*)ascent1_kernel<false>,
      (const void*)descent_kernel<true, true>,
      (const void*)restrict_kernel,
      (const void*)mvdot_kernel,
      (const void*)pre2_kernel,
      (const void*)descent_kernel<false, false, true>,
      (const void*)ascent_kernel<false, true>,
  };
  if (which < 0 || which >= (int)(sizeof(kernels) / sizeof(kernels[0])))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernels[which]);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *static_smem = (int)attr.sharedSizeBytes;
  return 0;
}
