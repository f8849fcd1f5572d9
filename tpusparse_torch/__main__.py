"""CLI driver — the reference's benchmark binary on the PyTorch port; port
of the Poisson branch of ``tpusparse/__main__.py``.

    python -m tpusparse_torch -da_grid_x 300 -da_grid_y 300 -da_grid_z 300 \
        -config configs/SolverOptions_GAMG.info

Prints the reference's output block (``src/main_ksp.cpp:124-129``) plus a
JSON sidecar line prefixed with ``JSON:``, and what ``-ksp_view``,
``-ksp_monitor``, ``-ksp_converged_reason``, ``-ksp_compute_eigenvalues``,
``-log_view`` and ``-options_left`` ask for.  ``-device cuda`` (the
default) needs a CUDA device; ``-device cpu`` runs every kernel's plain
twin on the CPU.
"""

from __future__ import annotations

import sys

import torch


def main(argv: list[str] | None = None) -> int:
    from tpusparse_torch.bench.driver import solve_poisson
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
    if opts.ksp_monitor:
        print(rep.monitor_block())
    if opts.ksp_converged_reason:
        print(rep.converged_reason_line())
    if opts.ksp_compute_eigenvalues and rep.eigenvalues:
        print(rep.eigenvalues_block())
    print(rep.reference_block())
    if opts.log_view:
        print(rep.log_view())
    print("JSON:", rep.json_sidecar())
    if opts.options_left:
        print(options_left_report(opts))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
