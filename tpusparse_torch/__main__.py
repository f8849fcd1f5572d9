"""CLI driver — the reference's benchmark binary on the PyTorch port; port
of the Poisson branch and the file route of ``tpusparse/__main__.py``.

    python -m tpusparse_torch -da_grid_x 300 -da_grid_y 300 -da_grid_z 300 \
        -config configs/SolverOptions_GAMG.info
    python -m tpusparse_torch -da_grid_x 300 -da_grid_y 300 -da_grid_z 300 \
        -mat_view binary:p300.petsc
    python -m tpusparse_torch -f p300.petsc -ksp_view_solution binary:x300.petsc

Prints the reference's output block (``src/main_ksp.cpp:124-129``) plus a
JSON sidecar line prefixed with ``JSON:``, and what ``-ksp_view``,
``-ksp_monitor``, ``-ksp_converged_reason``, ``-ksp_compute_eigenvalues``,
``-log_view`` and ``-options_left`` ask for.  ``-mat_view
binary:<file>`` writes the assembled Poisson system (matrix, rhs, exact
solution) as PETSc binary objects before the solve; ``-f <file>`` solves
the system of a PETSc binary or MatrixMarket file instead (PETSc's ex10,
``bench/driver.py::solve_from_file``), and ``-ksp_view_solution
binary:<file>`` writes its solution.  ``-device cuda`` (the default) needs
a CUDA device; ``-device cpu`` runs every kernel's plain twin on the CPU.
"""

from __future__ import annotations

import sys
import time

import torch


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
        # would not be the system of the run (-problem diffusion is ROADMAP
        # queue 11)
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


def main(argv: list[str] | None = None) -> int:
    from tpusparse_torch.bench.driver import solve_from_file, solve_poisson
    from tpusparse_torch.config.options import help_text, load_options, options_left_report

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
    if opts.mat_view and not opts.f:
        _export(opts)
    if opts.f:
        rep = solve_from_file(
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
        )
    else:
        rep = solve_poisson(
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
    if opts.ksp_view and rep.solver_view:
        print(rep.solver_view)
    if opts.ksp_monitor and not opts.f:
        print(rep.monitor_block())
    if opts.ksp_converged_reason:
        print(rep.converged_reason_line())
    if opts.ksp_compute_eigenvalues and rep.eigenvalues:
        print(rep.eigenvalues_block())
    print(rep.reference_block())
    if opts.log_view and not opts.f:
        print(rep.log_view())
    print("JSON:", rep.json_sidecar())
    if opts.options_left:
        print(options_left_report(opts))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
