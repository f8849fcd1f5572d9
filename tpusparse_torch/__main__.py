"""CLI driver — the reference's benchmark binary on the PyTorch port; port
of ``tpusparse/__main__.py``: the Poisson problem, the diffusion family
and the file route.

    python -m tpusparse_torch -da_grid_x 300 -da_grid_y 300 -da_grid_z 300 \
        -config configs/SolverOptions_GAMG.info
    python -m tpusparse_torch -da_grid_x 300 -da_grid_y 300 -da_grid_z 300 \
        -mat_view binary:p300.petsc
    python -m tpusparse_torch -f p300.petsc -ksp_view_solution binary:x300.petsc
    python -m tpusparse_torch -problem diffusion -da_grid_x 192 -da_grid_y 192 \
        -da_grid_z 192 -diffusion_contrast 100 -ksp_rtol 1e-8

Prints the reference's output block (``src/main_ksp.cpp:124-129``) plus a
JSON sidecar line prefixed with ``JSON:``, and what ``-ksp_view``,
``-ksp_monitor``, ``-ksp_converged_reason``, ``-ksp_compute_eigenvalues``,
``-log_view`` and ``-options_left`` ask for.  ``-mat_view
binary:<file>`` writes the assembled Poisson system (matrix, rhs, exact
solution) as PETSc binary objects before the solve; ``-f <file>`` solves
the system of a PETSc binary or MatrixMarket file instead (PETSc's ex10,
``bench/driver.py::solve_from_file``), and ``-ksp_view_solution
binary:<file>`` writes its solution; ``-mat_reorder auto|rcm|none``
orders its matrix (``KSP``).  ``-problem diffusion`` solves the
variable-coefficient diffusion problem (``bench/driver.py::
solve_diffusion``; CG + GAMG only, ``-diffusion_contrast``).
``-profile <dir>`` writes a ``torch.profiler`` trace of the solve into
``<dir>`` (``utils/profiling.py``).  ``-device cuda`` (the default) needs
a CUDA device; ``-device cpu`` runs every kernel's plain twin on the CPU.

``-devices p`` splits the Poisson solve over p blocks (``dist/``).  Under
torchrun, the reference's ``aprun -n W``,

    python -m torch.distributed.run --standalone --nproc-per-node W \
        -m tpusparse_torch -da_grid_x 300 -da_grid_y 300 -da_grid_z 300 -devices 4

each of the W ranks joins the process group (``dist/multihost.py``: NCCL
with one card a rank, gloo where ranks share a card or run on the CPU),
holds p/W of the blocks on ``cuda:{LOCAL_RANK % device_count}``, and only
rank 0 prints.
"""

from __future__ import annotations

import sys
import time

import torch
import torch.distributed


def _viewer_file(spec: str) -> str:
    """The file of a PETSc viewer spec 'binary:<filename>' ('' for none)."""
    if not spec:
        return ""
    fmt, _, fname = spec.partition(":")
    if fmt != "binary" or not fname:
        raise ValueError(f"{spec!r}: expected 'binary:<filename>'")
    return fname


def _export(opts) -> None:
    """-mat_view binary:<file> (MatView): the assembled Poisson system —
    matrix, rhs, exact solution — as PETSc binary objects, which -f (or
    PETSc's MatLoad) reads back."""
    from tpusparse_torch.grid.grid3d import Grid3D
    from tpusparse_torch.grid.poisson import assemble_poisson
    from tpusparse_torch.sparse.io import save_petsc_mat, save_petsc_vec

    fname = _viewer_file(opts.mat_view)
    if opts.problem != "poisson":
        # the export assembles the Poisson system: for another problem it
        # would not be the system of the run
        raise ValueError(
            f"-mat_view export supports -problem poisson only (the requested problem is {opts.problem!r})"
        )
    t0 = time.perf_counter()
    a, rhs, exact = assemble_poisson(Grid3D(opts.da_grid_x, opts.da_grid_y, opts.da_grid_z))
    t1 = time.perf_counter()
    save_petsc_mat(fname, a)
    save_petsc_vec(fname, rhs, append=True)
    save_petsc_vec(fname, exact, append=True)
    print(
        f"Mat Object: {a.shape[0]} x {a.shape[1]}, nnz {a.nnz} written to {fname}"
        f" (PETSc binary; + rhs and exact vectors; assembled in {t1 - t0:.3f} s, written in"
        f" {time.perf_counter() - t1:.3f} s)"
    )


def _diffusion(opts, device):
    """-problem diffusion: the second problem family, CG + GAMG only.  A
    method the user asked for explicitly is never silently replaced: any
    other -ksp_type or -pc_type is an error, as in the JAX CLI."""
    import warnings

    from tpusparse_torch.bench.driver import solve_diffusion

    provided = getattr(opts, "_provided", ())
    if "ksp_type" in provided and opts.ksp_type != "cg":
        raise ValueError(
            f"-problem diffusion runs -ksp_type cg (got {opts.ksp_type!r}); other Krylov methods are not"
            " wired to the diffusion driver"
        )
    if "pc_type" in provided and opts.pc_type != "gamg":
        raise ValueError(f"-problem diffusion runs -pc_type gamg (got {opts.pc_type!r})")
    if opts.ksp_monitor or opts.ksp_compute_eigenvalues:
        warnings.warn("-ksp_monitor/-ksp_compute_eigenvalues are not wired to the diffusion driver; ignoring")
    return solve_diffusion(
        opts.da_grid_x, opts.da_grid_y, opts.da_grid_z,
        device=device,
        contrast=opts.diffusion_contrast,
        rtol=opts.ksp_rtol,
        atol=opts.ksp_atol,
        divtol=opts.ksp_divtol,
        maxiter=opts.ksp_max_it,
        precision=opts.precision,
        amg_params=opts.amg_params(),
        mg_cycle=opts.pc_mg_cycle_type,
        view=opts.ksp_view,
    )


def main(argv: list[str] | None = None) -> int:
    from tpusparse_torch.config.options import help_text, load_options
    from tpusparse_torch.dist import multihost

    args = argv if argv is not None else sys.argv[1:]
    if "-help" in args or "--help" in args:
        print(help_text())
        return 0
    opts = load_options(args)
    device = torch.device(opts.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "-device cuda: no CUDA device here; -device cpu runs the"
            " kernels' plain twins"
        )
    # the process group: torchrun's (joined here, left at the end), or one
    # the caller made
    joined = not torch.distributed.is_initialized()
    if not multihost.initialize(device=device):
        return _main(opts, device, True)
    try:
        world, rank = torch.distributed.get_world_size(), torch.distributed.get_rank()
        if opts.f or opts.problem != "poisson" or opts.devices % world:
            raise ValueError(
                f"{world} ranks run the Poisson solve split over -devices p, with W | p (got -devices"
                f" {opts.devices}{', -f' if opts.f else ''}, -problem {opts.problem})"
            )
        return _main(opts, multihost.rank_device(device), rank == 0)
    finally:
        if joined:
            multihost.finalize()


def _main(opts, device, report: bool) -> int:
    """The run the options ask for on ``device``; ``report``: print (rank 0,
    or the one process)."""
    from tpusparse_torch.config.options import options_left_report
    from tpusparse_torch.utils.profiling import trace

    if not report:
        _solve(opts, device)
        return 0
    if opts.mat_view and not opts.f:
        _export(opts)
    if not opts.f and opts.problem not in ("poisson", "diffusion"):
        raise ValueError(f"unknown -problem {opts.problem!r} (poisson | diffusion)")
    # the Poisson branch's extra blocks (-ksp_monitor, -ksp_compute_eigenvalues,
    # -log_view), as in the JAX CLI
    poisson = not opts.f and opts.problem == "poisson"
    with trace(opts.profile):
        rep = _solve(opts, device)
    if opts.ksp_view and rep.solver_view:
        print(rep.solver_view)
    if opts.ksp_monitor and poisson:
        print(rep.monitor_block())
    if opts.ksp_converged_reason:
        print(rep.converged_reason_line())
    if opts.ksp_compute_eigenvalues and rep.eigenvalues:
        print(rep.eigenvalues_block())
    print(rep.reference_block())
    if opts.log_view and poisson:
        print(rep.log_view())
    print("JSON:", rep.json_sidecar())
    if opts.options_left:
        print(options_left_report(opts))
    return 0


def _solve(opts, device):
    """The solve the options ask for: the file route, the diffusion
    problem or the Poisson problem."""
    from tpusparse_torch.bench.driver import solve_from_file, solve_poisson

    if opts.f:
        return solve_from_file(
            opts.f,
            device=device,
            rtol=opts.ksp_rtol,
            atol=opts.ksp_atol,
            divtol=opts.ksp_divtol,
            maxiter=opts.ksp_max_it,
            ksp=opts.ksp_type,
            pc=opts.pc_type,
            precision=opts.precision,
            amg_params=opts.amg_params() if opts.pc_type == "gamg" else None,
            mg_cycle=opts.pc_mg_cycle_type,
            ksp_gmres_restart=opts.ksp_gmres_restart,
            ksp_richardson_scale=opts.ksp_richardson_scale,
            view=opts.ksp_view,
            solution_out=_viewer_file(opts.ksp_view_solution),
            mat_reorder=opts.mat_reorder,
        )
    if opts.problem == "diffusion":
        return _diffusion(opts, device)
    return solve_poisson(
        opts.da_grid_x, opts.da_grid_y, opts.da_grid_z,
        device=device,
        rtol=opts.ksp_rtol,
        atol=opts.ksp_atol,
        divtol=opts.ksp_divtol,
        maxiter=opts.ksp_max_it,
        pc=opts.pc_type,
        amg_params=opts.amg_params(),
        ksp=opts.ksp_type,
        ksp_gmres_restart=opts.ksp_gmres_restart,
        ksp_richardson_scale=opts.ksp_richardson_scale,
        mat_type=opts.mat_type,
        structure_detect=bool(opts.mat_structure_detect),
        aggregation=opts.pc_gamg_aggregation,
        precision=opts.precision,
        # -layout auto: padded, or plain for the options the padded
        # kernels cannot honour (driver docstring)
        layout=opts.layout,
        pc_dtype=opts.pc_dtype,
        mg_cycle=opts.pc_mg_cycle_type,
        # -devices p: p z-shards of the fine level on the one device
        n_devices=opts.devices,
        # computed for uniform-precision CG; elsewhere the driver warns
        compute_eigenvalues=opts.ksp_compute_eigenvalues,
        monitor=opts.ksp_monitor,
        view=opts.ksp_view,
    )


if __name__ == "__main__":
    raise SystemExit(main())
