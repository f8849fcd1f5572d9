"""Scaling harness — port of ``tpusparse/bench/scaling.py``, parity with the
reference's PBS benchmark jobs.

The reference's protocol (``runs/single-node-scaling.pbs:56-67``,
``runs/multiple-node-scaling.pbs:57-68``): run the same problem at a sweep
of rank counts, log each run's block, plot KSPSolve time against ranks.
Here the sweep is over the blocks of the fine level in ONE process:
``solve_poisson(..., n_devices=d)`` is the split solve (``dist/``): the
fused z route where the options take it (kernels K3z/K4z, one launch a
stroke over every shard, and K1h for CG's A p), the (z, y) plain route
otherwise.  Each point prints the reference's log line and the sweep
writes a JSON record in the JAX package's format, so ``bench/plots.py``
reads either package's records.

Every point's blocks share one device, so every record says
``"emulated": true``: its times validate code paths, not hardware scaling.
A sweep over ranks (one card a rank) is ROADMAP queue 12; a point whose
options the JAX driver refuses with ``n_devices > 1`` raises
``NotImplementedError`` in its words, from ``solve_poisson``.

Strong scaling: fixed global problem, more shards.  Weak scaling: fixed
per-shard box on the JAX package's constant-h protocol.  The record has the
JAX package's keys and meanings less ``hlo_validation`` (the JAX package's
check of ``comm_model`` against XLA's compiled collectives; not to port).

    python -m tpusparse_torch.bench.scaling strong --n 128 --devices 1,2,4,8
    python -m tpusparse_torch.bench.scaling weak --per-device 64 --devices 1,2,4,8

Each needs a CUDA device unless given ``--device cpu``; the records go to
``runs/torch_scaling_{mode}.json`` (the JAX package's own records,
``runs/scaling_{mode}.json``, stay as they are).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib

import torch

from tpusparse_torch.bench.driver import solve_poisson


@dataclasses.dataclass
class ScalingPoint:
    n_devices: int
    nx: int
    ny: int
    nz: int
    t_solve: float
    iters: int
    linf_error: float
    nnz: int

    @property
    def nnz_per_s(self) -> float:
        # nnz * iters: each CG iteration applies the fine operator once
        return self.nnz * max(self.iters, 1) / self.t_solve


def _poisson_nnz(nx: int, ny: int, nz: int) -> int:
    n = nx * ny * nz
    return 7 * n - 2 * (ny * nz + nx * nz + nx * ny)


def _factor2(n: int) -> tuple[int, int]:
    """Split n into (pz, py) with pz >= py, as square as possible
    (``tpusparse/dist/mesh.py:33``)."""
    best = (n, 1)
    for py in range(1, math.isqrt(n) + 1):
        if n % py == 0:
            best = (n // py, py)
    return best


def _point(d: int, nx: int, ny: int, nz: int, rtol: float, on_point, **kw) -> ScalingPoint:
    rep = solve_poisson(nx, ny, nz, rtol=rtol, n_devices=d, **kw)
    p = ScalingPoint(
        n_devices=d, nx=nx, ny=ny, nz=nz,
        t_solve=rep.t_solve, iters=rep.iters,
        linf_error=rep.linf_error, nnz=_poisson_nnz(nx, ny, nz),
    )
    print(_reference_line(p))
    if on_point is not None:
        on_point(p, rep)
    return p


def run_strong(
    n: int, device_counts: list[int], rtol: float = 1e-8, *, device="cuda", on_point=None, **kw
) -> list[ScalingPoint]:
    """The ``n``^3 solve at each z-shard count.  ``kw`` goes to
    ``solve_poisson``; ``on_point(point, report)``, if given, is called
    after each point's solve."""
    return [_point(d, n, n, n, rtol, on_point, device=device, **kw) for d in device_counts]


def run_weak(
    per_device: int, device_counts: list[int], rtol: float = 1e-8, *, device="cuda", on_point=None, **kw
) -> list[ScalingPoint]:
    """Grow nz/ny with the shard count at fixed per-shard box.

    The PHYSICAL DOMAIN grows with the grid (extent = (1, py, pz) at
    h = 1/per per axis) — the standard HPC weak-scaling protocol, the JAX
    package's.  Growing the grid on a fixed [0,1]^3 domain instead makes
    the operator anisotropic, and the isotropic 3^3 aggregation then loses
    mesh-independence.  With constant h the iteration count stays flat and
    the manufactured cosine solution remains valid (integer periods).
    (pz, py) is ``_factor2(d)``, the JAX package's (z, y) mesh; the port's
    route cuts only z, into d shards of nz = per * pz.
    """
    pts = []
    for d in device_counts:
        pz, py = _factor2(d)
        nx, ny, nz = per_device, per_device * py, per_device * pz
        pts.append(_point(d, nx, ny, nz, rtol, on_point, device=device,
                          extent=(1.0, float(py), float(pz)), **kw))
    return pts


def _reference_line(p: ScalingPoint) -> str:
    """One line per run, shaped like the reference's log contract
    (``scripts/generate_plots.py:87-90`` parses ``<N> Cores ... Time ...``)."""
    return (
        f"{p.n_devices} Devices [{p.nx}x{p.ny}x{p.nz}] "
        f"iters {p.iters} Linf {p.linf_error:.3e} "
        f"Time [solve]: [{p.t_solve:.6f}] "
        f"({p.nnz_per_s/1e9:.2f} Gnnz/s)"
    )


# --- bandwidth-model weak-scaling projection --------------------------------
# Wall times of shards that share one device say nothing of scaling, but the
# communication volume is fixed by the layout.  The model turns it into a
# projected efficiency with its inputs recorded beside it: the JAX
# package's formula and volume terms, with the link constants of several
# H100s in one node.
MODEL = {
    # NVLink on an H100 SXM: 900 GB/s bidirectional a card, taken as
    # 450 GB/s a direction (``MODEL_SOURCES``)
    "link_bytes_per_s": 4.5e11,
    # a small all-reduce round among the cards of one node (an assumption)
    "psum_latency_s": 2.0e-5,
    # fine-level operator applies per CG+AMG iteration: V-cycle 6 + CG 1
    "fine_applies_per_iter": 7,
    # scalar reductions per CG iteration (alpha dot, r.z, ||r||)
    "psums_per_iter": 3,
    # AMG levels whose halos the model charges: with the coarse levels
    # replicated only level 0 (sharded) has halos, and the fine/coarse seam
    # pays one coarse-vector all-reduce per cycle instead (charged below)
    "sharded_levels": 1,
    # coarsening ratio per level (3^3 aggregation)
    "coarsen_ratio": 27,
}
MODEL_SOURCES = {
    "link_bytes_per_s": "NVIDIA H100 SXM data sheet: NVLink 900 GB/s bidirectional a card;"
                        " half of it a direction",
    "psum_latency_s": "assumption, not measured: one all-reduce round of a few bytes among"
                      " the cards of one NVLink node, of the order of 10-30 us",
}


def comm_model(pts: list[ScalingPoint], t_iter_1dev: float) -> list[dict]:
    """Per-point communication volume + projected weak-scaling efficiency.

    eff = t_compute / (t_compute + t_halo + t_seam + t_latency), with
    t_compute held at the measured single-device per-iteration time (weak
    scaling keeps per-device work constant).  Traffic terms, the JAX
    package's, on its (pz, py) mesh of ``_factor2``:

    - fine halos: each sharded axis exchanges one boundary plane per face
      per fine apply (full-duplex links, send+recv each counted once);
    - coarse seam: with the coarse levels replicated and the level-0
      transfer seam-local (``dist/seam.py``), the restrict's only
      collective is one ring all-reduce of the coarse (n/27) field —
      2*(p-1)/p * n/27 bytes per device per cycle.
    """
    out = []
    itemsize = 4  # f32 inner fields carry the fine-level traffic
    for p in pts:
        pz, py = _factor2(p.n_devices)
        bz, by = p.nz // pz, p.ny // py
        plane_z = by * p.nx * itemsize      # z-face plane bytes
        plane_y = bz * p.nx * itemsize      # y-face plane bytes
        faces_z = 2 if pz > 1 else 0
        faces_y = 2 if py > 1 else 0
        halo_per_apply = faces_z * plane_z + faces_y * plane_y
        halo_per_iter = halo_per_apply * MODEL["fine_applies_per_iter"]
        # fine/coarse seam: one ring all-reduce of the coarse field per cycle
        n27 = (p.nx * p.ny * p.nz) // MODEL["coarsen_ratio"]
        seam_per_iter = int(
            n27 * itemsize
            * 2.0 * (p.n_devices - 1) / max(p.n_devices, 1)
        )
        t_halo = halo_per_iter / MODEL["link_bytes_per_s"]
        t_seam = seam_per_iter / MODEL["link_bytes_per_s"]
        t_lat = (
            MODEL["psums_per_iter"] + 1  # +1: the seam collective round
        ) * MODEL["psum_latency_s"]
        if p.n_devices == 1:
            t_halo = t_seam = t_lat = 0.0
        eff = t_iter_1dev / (t_iter_1dev + t_halo + t_seam + t_lat)
        out.append(
            {
                "n_devices": p.n_devices,
                "mesh": [pz, py],
                "halo_bytes_per_iter": int(halo_per_iter),
                "coarse_seam_bytes_per_iter": seam_per_iter,
                "psums_per_iter": MODEL["psums_per_iter"],
                "t_halo_s": t_halo,
                "t_seam_s": t_seam,
                "t_latency_s": t_lat,
                "projected_efficiency": eff,
            }
        )
    return out


def efficiency(pts: list[ScalingPoint], weak: bool) -> dict[int, float]:
    """Scaling efficiency vs the smallest device count in the sweep.

    Weak mode reports the nnz*iters/s rate efficiency (BASELINE's metric);
    ``tts_efficiency`` reports the time-to-solution form, which does not
    credit iteration growth as useful work."""
    base = pts[0]
    out = {}
    for p in pts:
        scale = p.n_devices / base.n_devices
        if weak:
            out[p.n_devices] = (p.nnz_per_s / base.nnz_per_s) / scale
        else:
            out[p.n_devices] = base.t_solve / (p.t_solve * scale)
    return out


def tts_efficiency(pts: list[ScalingPoint]) -> dict[int, float]:
    """Weak-scaling time-to-solution efficiency: ideal weak scaling solves
    the p-times-larger problem in the same wall time, so
    eff = t_solve(base) / t_solve(p)."""
    base = pts[0]
    return {p.n_devices: base.t_solve / p.t_solve for p in pts}


def save_json(
    pts: list[ScalingPoint], mode: str, path: pathlib.Path,
    t_iter_1dev: float | None = None, *, backend: str,
) -> None:
    """The sweep's record at ``path``; ``backend`` is "cuda" or "cpu"."""
    rec = {
        "mode": mode,
        "backend": backend,
        # every shard of every point shares one device (a sweep over ranks is
        # ROADMAP queue 12): wall times validate code paths, not hardware
        # scaling, and the plots watermark the record
        "emulated": True,
        "points": [dataclasses.asdict(p) for p in pts],
        "efficiency": efficiency(pts, weak=(mode == "weak")),
    }
    if mode == "weak":
        rec["tts_efficiency"] = tts_efficiency(pts)
        # the measured per-iteration time of the first point anchors the
        # projection
        t1 = t_iter_1dev or pts[0].t_solve / max(pts[0].iters, 1)
        rec["projection_model"] = dict(MODEL, t_iter_1dev_s=t1, sources=MODEL_SOURCES)
        rec["projection"] = comm_model(pts, t1)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=2))
    print(f"wrote {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mode", choices=["strong", "weak"])
    ap.add_argument("--n", type=int, default=128, help="grid edge (strong)")
    ap.add_argument(
        "--per-device", type=int, default=64, help="per-shard edge (weak)"
    )
    ap.add_argument("--devices", default="1,2,4,8", help="z-shard counts")
    ap.add_argument("--rtol", type=float, default=1e-8)
    ap.add_argument("--precision", default="mixed")
    ap.add_argument("--out", default="runs/torch_scaling_{mode}.json")
    ap.add_argument(
        "--t-iter", type=float, default=None,
        help="per-iteration compute time (s) anchoring the weak-scaling"
        " projection (default: measured from the first point of this sweep)",
    )
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the scaling sweep on cuda needs a CUDA device (--device cpu runs it on the host)")

    counts = [int(c) for c in args.devices.split(",")]
    kw = dict(rtol=args.rtol, precision=args.precision, device=args.device)
    if args.mode == "strong":
        pts = run_strong(args.n, counts, **kw)
    else:
        pts = run_weak(args.per_device, counts, **kw)
    eff = efficiency(pts, weak=(args.mode == "weak"))
    for d, e in eff.items():
        print(f"  {d} devices: efficiency {e*100:.1f}%")
    save_json(
        pts, args.mode, pathlib.Path(args.out.format(mode=args.mode)),
        t_iter_1dev=args.t_iter, backend=torch.device(args.device).type,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
