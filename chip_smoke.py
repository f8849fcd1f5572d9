"""Smoke test of the PyTorch/CUDA port (``tpusparse_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed before the last line; any failure raises and the
script exits non-zero without the final line:

1. Require a CUDA device; print its name and power limit (nvidia-smi).
2. Build the CUDA kernels from ``tpusparse_torch/csrc`` (nvcc, sm_90a).
3. Hold every kernel of the stencil path (K1 star7_mv_padded, K2
   fused7_mvdot, K3 fused7_descent_rr, K4 fused7_ascent_rz) against its
   plain PyTorch twin on the card, at the ragged shape (40, 11, 13) and at
   300^3, on inputs made with numpy from a fixed seed; time both at 300^3
   with CUDA events.  K1's y = A x is also cuSPARSE's CSR matvec of the
   same pinned star (``csr @ x`` on the cropped field): held against the
   twin to the same tolerance and timed beside it.  Each output field must agree to rtol 1e-5, atol 1e-6
   of its own max|want| (tests/test_fused7.py:53-69 without its 1e-3 floor,
   which would exceed the whole range of K3's x1); dots to 1e-5 relative.
4. A 24^3 stencil solve must reproduce the JAX package's outcome at that
   size (24 +- 1 inner / 2 outer iterations, reason 2, Linf 1.117e-2).
5. The stencil path through the headline bench entry
   (``tpusparse_torch.bench.headline.run``: ``solve_poisson(300,
   rtol=1e-8, atol=1e-12, pc="gamg", device="cuda")``), with the launch
   counters reset just before it; its JSON line is printed.  It must
   converge with reason 2 in 2-3 outer and 34 +- 2 inner iterations, with
   Linf < 1e-4, and launch K1-K4 at least once each.
6. K5 (dia_mv, the general-matrix path's banded SpMV) against its plain
   twin on the card, on numpy inputs from the same seed: the 7 Poisson star
   offsets and a 27-band set with offsets that leave the matrix at the
   ragged n = 40*11*13, then n = 300^3 with K = 7 (the fine level) and
   n = 100^3 with K = 27 (level 1), both timed; rtol 1e-5, atol 1e-6 of
   max|want|.
7. A 24^3 aij solve (``mat_type="aij", structure_detect=False``, the
   structure-blind route) must
   reproduce the JAX package's CPU outcome (24 +- 1 inner / 2 outer,
   reason 2, Linf 1.117e-2 +- 1e-5).
8. The general-matrix path at full size: the same 300^3 solve with
   ``mat_type="aij", structure_detect=False``, launch counters reset just
   before it.  Reason 2,
   Linf < 1e-4, 35 +- 2 inner in 2-3 outer sweeps, K5 launched and K1-K4
   not (the structure-blind route ran).

9. The kernels of the reference config's smoother and of the non-CG
   solvers (K6 fused7_descent1_rr, K7 fused7_ascent1_rz and the dot-free
   K3' fused7_descent, K4' fused7_ascent, K6' fused7_descent1, K7'
   fused7_ascent1) against their twins as in phase 3, timed at 300^3.
   The z-marching kernels, one launch each (K3, K3', K4, K4', K6, K6', K7,
   K7', and K9 fused7_descentu, K15 fused7_restrict, K2 fused7_mvdot and
   K14 fused7_pre2, which phases 3, 13 and 17 time), first at ragged shapes
   of 1-3 cells a side and of several tiles and z-chunks
   (``ZMARCH_SHAPES``), pinned and not, with the operator's and (all but K2
   and K14, which have no P-smoothing stage) with filtered legs, and at
   300^3: K6's x1 bit-equal to the twin's, the other fields as in phase 3,
   the dots by ``_dot_agrees`` (K9's <r', r'>, a sum of squares, and K2's
   <x, A x> to 1e-5 of themselves), every face and pad cell exactly 0.
   Each time is printed with the field passes of its bound (K3, K6 4; K4,
   K7 5) and its share of that bound, and each z-marching kernel with its
   registers, spills, shared bytes and waves at 300^3.
10. The reference's own entry point at 300^3, in process:
   ``tpusparse_torch.__main__.main([... "-config",
   "configs/SolverOptions_GAMG.info", "-ksp_converged_reason",
   "-log_view"])`` (CG + GAMG with Richardson(1), rtol 1e-14), launch
   counters reset just before.  Its JSON sidecar must show a positive
   reason (CONVERGED_STALLED, 100, is one: the f64 true-residual floor),
   Linf < 1e-4 and the port's own counts (767 +- 40 inner in 4-6 sweeps);
   K6 and K7 launched, K3 and K4 not.
11. ``-ksp_type gmres`` through the CLI at 300^3, rtol 1e-8 (Chebyshev(2)):
   positive reason, Linf < 1e-4, K3'/K4' launched.
12. ``-ksp_type bcgs`` with the reference config at 48^3: positive reason,
   Linf < 3e-3 (the discretization error there is 2.84e-3), K6'/K7'
   launched.  Not 100^3: there BiCGStab over the Richardson(1) V-cycle
   fails in both packages (PERF.md).

13. The kernels of the full-fusion CG body (K8 fused7_cgmv, K9
   fused7_descentu) and of the plain layout (K1p star7_mv, on unpadded
   fields) against their twins as in phase 3, timed at 300^3; K1p beside
   the CSR matvec of its star, as K1 in phase 3.
14. The full-fusion CG body: ``solve_poisson(300, rtol=1e-8, atol=1e-12,
   pc="gamg", cg_fusion=True)``, counters reset just before.  Reason 2,
   Linf < 1e-4, 2-3 outer sweeps, inner within 2 of phase 5's; K8, K9 and
   K4 launched, K2, K3, K10 and K15 not.  One K9 call runs one kernel of
   ``csrc/fused7.cu`` on the card, its z-marching ``descent_kernel``
   (``torch.profiler``'s device events).
15. ``-layout plain`` through the CLI at 300^3, rtol 1e-8: positive
   reason, Linf < 1e-4, 34 +- 3 inner in 2-3 sweeps; K1p launched and no
   fused7 kernel.
16. ``-precision f64`` (rtol 1e-8) and ``-precision f32`` (rtol 1e-6)
   through the CLI at 100^3: positive reason, Linf < 1e-3 (the
   discretization error there is 6.57e-4); K1p launched by f32, not f64.

17. The single-step kernels of the unfused padded cycle (K10
   fused7_residual, K11 fused7_rich, K12 fused7_cheb0, K13 fused7_cheb,
   K14 fused7_pre2, K15 fused7_restrict, K16 fused7_prolong) against their
   twins as in phase 3, pinned and not at (40, 11, 13); and the filtered-leg
   forms (``flegs``, the threshold schedule's) of K3, K4, K15 and K16.
   Timed at 300^3; K10, K15 and K16 beside their one PyTorch call (K10:
   ``torch.addmm(b, A, x, alpha=-1)`` on the star's CSR; K15/K16: the CSR
   matvec of I - g A D^-1 and I - g D^-1 A), as K1 in phase 3.  Also the cuSPARSE CSR matvec of phase 6's 27-band
   100^3 matrix, timed beside K5 there.
18. Chebyshev(3) on the padded route at 300^3 through the CLI
   (``-mg_levels_ksp_max_it 3``, rtol 1e-8): reason 2, Linf < 1e-4, 2-3
   sweeps, inner at most phase 5's + 2; K14, K13, K12, K10, K15 and K16
   launched (the unfused padded cycle), K3 and K4 not.
19. Richardson(3) at 100^3 through the CLI (rtol 1e-8): a positive reason,
   Linf < 1e-3, K11 launched.
20. The W-cycle at 300^3 through the CLI (``-pc_mg_cycle_type w``, rtol
   1e-8): reason 2, Linf < 1e-4, inner at most phase 5's + 2; K3/K4
   launched.
21. ``-pc_gamg_threshold``: ``solve_poisson(300, extent=(1, 1, 3),
   amg_params=AMGParams(threshold=0.05), rtol=1e-8)`` beside the same
   solve at threshold 0.  The schedule's level 0 is (1, 3, 3); both reason
   2 with Linf within 1% of each other; K3/K4 launched on the filtered
   hierarchy (its ``-ksp_view`` names the (1, 3, 3) level and its filtered
   P smoother).  Both counts printed, their order not gated.
22. The plain-only options and the standalone PCs at 100^3 through the
   CLI (rtol 1e-8, atol 1e-12): ``-mg_levels_pc_type sor``,
   ``-mg_coarse_pc_type lu``, ``-pc_bjacobi_bs 100`` (x-line), ``-pc_type
   sor`` (each launching K1p and no fused7 kernel), ``-pc_type jacobi`` and
   ``none`` (the padded route: K2 and no V-cycle kernel), and ``-mat_type
   aij -mat_structure_detect 0 -mg_coarse_pc_type lu`` (K5).  Each: a
   positive reason and Linf < 1e-3; counts and ``t_solve`` printed.
23. The default aij route at 300^3: ``solve_poisson(300,
   mat_type="aij", rtol=1e-8, atol=1e-12, view=True)`` proves the matrix a
   star and solves it on the stencil route, counters reset just before.
   Reason 2, Linf < 1e-4, 34 +- 2 inner in 2-3 sweeps (whether the count
   equals phase 5's is printed), "star DETECTED" in its view and
   "star_lift" in its setup breakdown, K1-K4 launched and K5 not; its
   phases, the lift's time and its peak device memory are printed, and
   whether the lifted f32 fine operator is bitwise the stencil route's.
   Then the stencil and the lifted solve in turn, twice (each reason 2),
   their ``t_setup``/``t_solve`` printed beside phases 5, 23 and 8.
24. ``-mat_type aij -precision f64`` (rtol 1e-8) and ``-precision f32``
   (rtol 1e-6) through the CLI at 100^3 (the host assembly, lifted onto
   the plain route): positive reason, Linf < 1e-3, K1p launched by f32
   only, K5 by neither.
25. ``-precision f64 -ksp_compute_eigenvalues`` and ``-precision f64
   -ksp_monitor`` with CG and GMRES through the CLI at 100^3: as many Ritz
   values as iterations, the least positive; one monitored norm an
   iteration and the initial one.
26. ``-pc_dtype bf16 -layout plain`` (rtol 1e-8) and ``-pc_dtype bf16
   -precision f32`` (rtol 1e-6) through the CLI at 100^3, each beside the
   same solve with the f32 cycle: positive reason, Linf < 1e-3,
   "pc_dtype: bf16" in its view.
27. The z-sharded fine level (p z-shards on the one card): K3z
   fused7_descent_slab and K4z fused7_ascent_slab on the stacked layout
   (``dist/fused_sharded.py``, halos refreshed), in one launch over all p
   slabs and in one launch a slab, each against its twin, pinned and not,
   at (12, 11, 13) with p = 4 (nz_l = 3) and (40, 11, 13) with p = 2, and
   pinned at 300^3 with p = 4, as in phase 3, every face and pad cell
   exactly 0; the two bit-equal, and each slab's domain planes bit-equal to
   one unsharded K3'/K4' launch on the whole field (the same arithmetic on
   the same values).  At 300^3 the one stacked launch is timed beside its
   twin, the p single-slab launches and one unsharded launch, with its
   bound share, chunks and waves, and at 1-5 z-chunks a slab (the plan
   takes 3); registers and spills (at most 96, none) are gated.  Then
   ``solve_poisson(300, rtol=1e-8, atol=1e-12, pc="gamg", layout="padded",
   n_devices=4)``, counters reset just before: reason 2, Linf < 1e-4, 2-3
   sweeps, inner within 2 of phase 15's; K3z and K4z launched once a
   stroke (the calls of ``FusedSharded.descent`` / ``ascent``, one each a
   V-cycle), K1p launched, K2, K3, K4, K3' and K4' not; ``t_setup``,
   ``t_solve`` and peak memory printed beside phases 5 and 15 and the plain
   layout's peak memory.  And ``-devices 4`` through the CLI at 100^3: a
   positive reason, Linf < 1e-3, 4 z-shards in its JSON.
28. The object API (``tpusparse_torch.KSP``) and block solves.  K1p over a
   stack (``star7_mv_batched``, one launch for k columns) against its twin
   at (40, 11, 13) with k = 3 and at 300^3 with k = 4, as in phase 3, and
   each column bit-equal to one K1p launch on it; at 300^3 timed beside its
   twin, the k single K1p launches and cuSPARSE's SpMM of the star's CSR
   with the (n, k) block, with its bound share.  Then ``KSP(rtol=1e-8,
   atol=1e-12)`` on the f64 ``poisson_stencil_device`` system at 300^3
   (the padded route), counters reset just before: the first solve at
   phase 5's gates (reason 2, 34 +- 2 inner in 2-3 sweeps, Linf < 1e-4),
   K1-K4 launched; a second solve of 2b reusing the hierarchy (one build
   in all, counted) with x2 = 2 x1 to 1e-6; a solve from x0 = x1 in at most
   one sweep; ``t_setup``, the solve times and peak memory printed.
   ``mat_solve`` of the columns [b, 5b, b + 0.1 sin(7b), -b], counters
   reset just before: reason 2 in every column, each column's inner count
   within 2 of phase 15's, Linf < 1e-4 in column 0, column 1 equal to 5 x
   column 0 to 1e-5; ``star7_mv_batched`` launched and no fused7 kernel;
   time, peak memory and launches printed.  ``cg_checkpointed`` at 100^3
   (f32 K1p operator, plain GAMG cycle, a snapshot every 5 iterations)
   cut by ``maxiter`` and resumed: the uninterrupted run's iterations and
   reason, x within 1e-6.  And ``solve_poisson(100, precision="f64",
   ksp_norm_type="preconditioned")``: a positive reason.
29. The file route (PETSc's ex10) at 300^3 through the CLI, in one
   temporary directory removed after phase 31: ``-mat_view
   binary:<file>`` writes the assembled system (matrix, rhs, exact
   solution; 2.8 GB; it also runs the stencil solve), then ``-f <file>
   -ksp_rtol 1e-8 -ksp_atol 1e-12 -ksp_view_solution binary:<file>``,
   counters reset just before: reason 2, 35 +- 2 inner in 2-3 sweeps,
   Linf < 1e-4, K5 launched and no star7/fused7 kernel; the solution file
   read back holds the solve's x (its Linf against the file's exact
   vector is the report's, exactly).  The file's size, the assembly and
   write seconds, t_init's parts (read, diagonals, host_bands, upload), t_setup,
   t_solve and peak device memory are printed.
30. The structure-blind aij route in uniform precision through the CLI:
   ``-mat_structure_detect 0 -precision f32`` at 300^3 (rtol 1e-6; K5
   launched) and ``-precision f64`` at 100^3 (rtol 1e-8; no kernel), each
   a positive reason and Linf < 1e-3; and ``solve_poisson(100,
   mat_type="aij", structure_detect=False, pc="bjacobi", assembly="host",
   amg_params=AMGParams(bjacobi_bs=100))`` (the x-line blocks in their
   PCR form): a positive reason, Linf < 1e-3.
31. K5 over a stack (``dia_mv_batched``) against its twin on the Poisson
   bands at (40, 11, 13), pinned and not, with k = 3, on a 27-band set at
   the ragged n with k = 2 and on the pinned 300^3 bands with k = 4, as in
   phase 3, and each column bit-equal to one K5 launch on it; at 300^3
   timed beside its twin, the k single K5 launches and cuSPARSE's SpMM of
   the matrix's CSR with the (n, k) block, with its bound share.  Then
   ``KSP(rtol=1e-8, atol=1e-12)`` on the matrix read from phase 29's file,
   its hierarchy built before the counters are reset, and ``mat_solve``
   of the columns [b, 5b, b + 0.1 sin(7b), -b]: reason 2 in every column,
   each within 2 of phase 29's inner count, Linf < 1e-4 in columns 0, 1
   (/ 5) and 3; ``dia_mv_batched`` launched and the single ``dia_mv`` not;
   time and peak memory printed.
32. K5 past 48 bands (the cap is the DIA family's 192): K5 and the batched
   K5 at K = 49, 65 and 192 on n = 40*11*13 + 7 with random offsets past
   both ends and 3 columns: K5, the batched K5 and the twin each within the
   f32 sum's error bound (K u sum_k |b_k x|) of the f64 sum (K5 rounds once
   a term with ``__fmaf_rn``, the twin twice), each batched column bit for
   bit a K5 launch; at 1M rows with K = 65 and 192 contiguous bands, K5
   timed beside its twin, its bound ((K+2) n 4 bytes over 3.35 TB/s) and
   cuSPARSE's CSR matvec; and phase 6's K = 7 time at 300^3 within 5% of
   its 0.463 ms row.
33. Item 9.2's host routes at 1M rows, counters reset before each: the
   greedy route (``-mat_type aij -pc_gamg_aggregation greedy``, mixed, rtol
   1e-8) and GAMG's block-Jacobi level smoother (``-mat_type aij
   -mat_structure_detect 0 -pc_bjacobi_bs 100``) at 100^3 through the CLI:
   reason 2, Linf < 1e-3, K5 launched and no stencil kernel, the setup
   breakdown, the levels (``-ksp_view``) and peak memory printed; ``KSP``
   on the 61-diagonal matrix at 1M rows with GAMG and with Jacobi: reason
   2, true relative residual <= 1e-8, 8 +- 2 / 14 +- 2 inner (JAX's counts
   at 2000 rows), K5 launched; and the greedy, banded and block-Jacobi
   routes at 16^3 on the card and on the CPU: reason 2, outer equal, inner
   within 2.
34. The banded route at full size: ``-mat_type aij -mat_structure_detect 0
   -pc_gamg_aggregation banded`` at 300^3 (device assembly): reason 2,
   Linf < 1e-4, K5 launched; and ``bench.deviceaggbench`` at 27,000,000
   rows (the pinned wrap chain built on the card, setup cold and warm with
   its breakdown and peak memory, the mixed solve to rtol 1e-8): reason
   positive, true relative residual in f64 <= 1e-8, K5 launched; its JSON
   line printed.

Then one JSON line with each kernel's route, source, launches (K1-K4 from
phase 5, K5 from phase 8, K6/K7 from phase 10, K3'/K4' from phase 11,
K6'/K7' from phase 12, K8/K9 from phase 14, K1p from phase 15, K10 and
K12-K16 from phase 18, K11 from phase 19, K3z/K4z from phase 27, the
batched K1p from phase 28's ``mat_solve``, the batched K5 from phase 31's),
error,
times, its bound at the timed shape (the larger of its unique field bytes
over 3.35 TB/s and its operations over 67 TFLOP/s of f32, the H100 SXM's
published peaks) and the time of one PyTorch call computing the same
function where there is one (K1, K1p and K5: the cuSPARSE CSR matvec of
the same matrix; the batched K1p and K5: cuSPARSE's SpMM of that CSR with
the block; K10: ``torch.addmm`` of that CSR; K15/K16: the CSR matvec
of the matrix their pass applies; null for the other fused modes), and as
the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from tpusparse_torch import KSP, kernels
from tpusparse_torch import ksp as ksp_module
from tpusparse_torch.__main__ import main as cli_main
from tpusparse_torch.amg.hierarchy import AMGParams, gamg_setup, threshold_schedule, vcycle
from tpusparse_torch.bench import deviceaggbench, headline
from tpusparse_torch.bench.driver import solve_poisson
from tpusparse_torch.dist.fused_sharded import FusedSharded
from tpusparse_torch.dist.mesh import make_z_mesh
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import poisson_dia_device, poisson_stencil_device
from tpusparse_torch.kernels import _build
from tpusparse_torch.kernels.diaband import dia_mv, dia_mv_batched, dia_mv_torch
from tpusparse_torch.kernels.fused7 import (
    fused7_ascent,
    fused7_ascent1,
    fused7_ascent1_rz,
    fused7_ascent1_rz_torch,
    fused7_ascent1_torch,
    fused7_ascent_rz,
    fused7_ascent_rz_torch,
    fused7_ascent_slab,
    fused7_ascent_slab_torch,
    fused7_ascent_torch,
    fused7_cgmv,
    fused7_cgmv_torch,
    fused7_cheb,
    fused7_cheb0,
    fused7_cheb0_torch,
    fused7_cheb_torch,
    fused7_descent,
    fused7_descent1,
    fused7_descent1_rr,
    fused7_descent1_rr_torch,
    fused7_descent1_torch,
    fused7_descent_rr,
    fused7_descent_rr_torch,
    fused7_descent_slab,
    fused7_descent_slab_torch,
    fused7_descent_torch,
    fused7_descentu,
    fused7_descentu_torch,
    fused7_mvdot,
    fused7_mvdot_torch,
    fused7_pre2,
    fused7_pre2_torch,
    fused7_prolong,
    fused7_prolong_torch,
    fused7_residual,
    fused7_residual_torch,
    fused7_restrict,
    fused7_restrict_torch,
    fused7_rich,
    fused7_rich_torch,
    ZMARCH_WRAPPERS,
    zmarch_attributes,
    zmarch_plan,
    zmarch_slab_plan,
    _ASCENT_ARGS,
    _DESCENT_ARGS,
)
from tpusparse_torch.kernels.stencil7 import (
    FACE,
    launch_args,
    padded_shape,
    star7_mv,
    star7_mv_batched,
    star7_mv_padded,
    star7_mv_padded_torch,
    star7_mv_torch,
)
from tpusparse_torch.solve.cg import cg
from tpusparse_torch.solve.checkpoint import CheckpointConfig, cg_checkpointed
from tpusparse_torch.sparse.io import load_petsc_vec, read_petsc_objects
from tpusparse_torch.sparse.padded import PaddedStar, crop_field, pad_field
from tpusparse_torch.sparse.starlift import star_lift

SEED = 7
SHAPES = ((40, 11, 13), (300, 300, 300))
# the fused-kernel scalars of tests/test_fused7.py:32-36
G, AD, S0, GW, G2 = 0.731, 0.377, 1.618, 0.243, 0.519

KERNELS = {
    "star7_mv_padded": (
        "tpusparse_torch/csrc/stencil7.cu", "tpusparse/kernels/stencil7.py:108",
        star7_mv_padded, star7_mv_padded_torch,
    ),
    "fused7_mvdot": (
        "tpusparse_torch/csrc/fused7.cu", "tpusparse/kernels/fused7.py:515",
        fused7_mvdot, fused7_mvdot_torch,
    ),
    "fused7_descent_rr": (
        "tpusparse_torch/csrc/fused7.cu", "tpusparse/kernels/fused7.py:575",
        fused7_descent_rr, fused7_descent_rr_torch,
    ),
    "fused7_ascent_rz": (
        "tpusparse_torch/csrc/fused7.cu", "tpusparse/kernels/fused7.py:674",
        fused7_ascent_rz, fused7_ascent_rz_torch,
    ),
}
STENCIL_KERNELS = tuple(KERNELS)
KERNELS["dia_mv"] = (
    "tpusparse_torch/csrc/diaband.cu", "tpusparse/kernels/diaband.py:248",
    dia_mv, dia_mv_torch,
)
FUSED7_SRC = "tpusparse_torch/csrc/fused7.cu"
NEW_KERNELS = {
    "fused7_descent1_rr": (FUSED7_SRC, "tpusparse/kernels/fused7.py:632",
                           fused7_descent1_rr, fused7_descent1_rr_torch),
    "fused7_ascent1_rz": (FUSED7_SRC, "tpusparse/kernels/fused7.py:650",
                          fused7_ascent1_rz, fused7_ascent1_rz_torch),
    "fused7_descent": (FUSED7_SRC, "tpusparse/kernels/fused7.py:575",
                       fused7_descent, fused7_descent_torch),
    "fused7_ascent": (FUSED7_SRC, "tpusparse/kernels/fused7.py:674",
                      fused7_ascent, fused7_ascent_torch),
    "fused7_descent1": (FUSED7_SRC, "tpusparse/kernels/fused7.py:632",
                        fused7_descent1, fused7_descent1_torch),
    "fused7_ascent1": (FUSED7_SRC, "tpusparse/kernels/fused7.py:650",
                       fused7_ascent1, fused7_ascent1_torch),
}
KERNELS.update(NEW_KERNELS)
FUSION_KERNELS = {
    "fused7_cgmv": (FUSED7_SRC, "tpusparse/kernels/fused7.py:522", fused7_cgmv, fused7_cgmv_torch),
    "fused7_descentu": (FUSED7_SRC, "tpusparse/kernels/fused7.py:603",
                        fused7_descentu, fused7_descentu_torch),
    "star7_mv": ("tpusparse_torch/csrc/stencil7.cu", "tpusparse/kernels/stencil7.py:330",
                 star7_mv, star7_mv_torch),
}
KERNELS.update(FUSION_KERNELS)
# K10-K16, the single-step modes of the unfused padded cycle
STEP_KERNELS = {
    "fused7_residual": (FUSED7_SRC, "tpusparse/kernels/fused7.py:538",
                        fused7_residual, fused7_residual_torch),
    "fused7_rich": (FUSED7_SRC, "tpusparse/kernels/fused7.py:553", fused7_rich, fused7_rich_torch),
    "fused7_cheb0": (FUSED7_SRC, "tpusparse/kernels/fused7.py:559", fused7_cheb0, fused7_cheb0_torch),
    "fused7_cheb": (FUSED7_SRC, "tpusparse/kernels/fused7.py:561", fused7_cheb, fused7_cheb_torch),
    "fused7_pre2": (FUSED7_SRC, "tpusparse/kernels/fused7.py:566", fused7_pre2, fused7_pre2_torch),
    "fused7_restrict": (FUSED7_SRC, "tpusparse/kernels/fused7.py:541",
                        fused7_restrict, fused7_restrict_torch),
    "fused7_prolong": (FUSED7_SRC, "tpusparse/kernels/fused7.py:546",
                       fused7_prolong, fused7_prolong_torch),
}
KERNELS.update(STEP_KERNELS)
# K3z/K4z, fused7_call's z-slab form (z0, nzg) of modes descent and ascent
SLAB_KERNELS = {
    "fused7_descent_slab": (FUSED7_SRC, "tpusparse/kernels/fused7.py:575",
                            fused7_descent_slab, fused7_descent_slab_torch),
    "fused7_ascent_slab": (FUSED7_SRC, "tpusparse/kernels/fused7.py:674",
                           fused7_ascent_slab, fused7_ascent_slab_torch),
}
KERNELS.update(SLAB_KERNELS)
# K1p over a stack of k columns (KSP.mat_solve's fine-level apply, which the
# JAX package runs as the vmapped XLA form of K1p's function)
KERNELS["star7_mv_batched"] = (
    "tpusparse_torch/csrc/stencil7.cu", "tpusparse/kernels/stencil7.py:330", star7_mv_batched, star7_mv_torch,
)
# phase 28's (shape, columns) of the batched K1p; the last is timed
BATCHED_CASES = (((40, 11, 13), 3), ((300, 300, 300), 4))
# K5 over a stack of k columns (KSP.mat_solve's apply of a DIA operator,
# which the JAX package runs as the vmapped XLA form of DIA.mv)
KERNELS["dia_mv_batched"] = (
    "tpusparse_torch/csrc/diaband.cu", "tpusparse/kernels/diaband.py:248", dia_mv_batched, dia_mv_torch,
)
# phase 31's (label, grid shape, pinned, columns) of the batched K5 on the
# Poisson bands, and a 27-band set with offsets that leave the matrix at
# a ragged n; the last is timed
DIA_BATCHED_CASES = (("star7 (40, 11, 13) pinned", (40, 11, 13), True, 3),
                     ("star7 (40, 11, 13)", (40, 11, 13), False, 3),
                     ("27-band n=40*11*13", None, None, 2),
                     ("star7 300^3 pinned", (300, 300, 300), True, 4))
# phase 27's (global shape, z-shards, pinned) cases: nz_l = 3, the least a
# shard holds (its neighbours read FACE planes), and 20; the last is timed
SLAB_CASES = (((12, 11, 13), 4, True), ((12, 11, 13), 4, False), ((40, 11, 13), 2, True),
              ((40, 11, 13), 2, False), ((300, 300, 300), 4, True))
# the z-marching kernels (one launch each) and the ragged shapes phase 9
# holds them at: 1-3 cells a side (never one cell alone: its Neumann row is
# zero), x not a multiple of 4, several tiles and z-chunks
# (ny = 21 and 57 cut K3/K4's 26-row tile and K6/K7's 12-row one raggedly,
# and nz = 60, 75 and 100 their z-chunks)
ZMARCH = ZMARCH_WRAPPERS
ZMARCH_SHAPES = ((1, 2, 1), (3, 2, 5), (2, 3, 1), (2, 1, 3), (40, 13, 61), (70, 25, 3), (33, 25, 121),
                 (75, 21, 13), (100, 21, 61), (60, 57, 13))
# the z-marching kernels with no P-smoothing stage, which take no filtered
# legs, and those whose last output is a dot
ZMARCH_NO_FLEGS = ("fused7_mvdot", "fused7_pre2")
ZMARCH_DOTS = ("fused7_descent_rr", "fused7_ascent_rz", "fused7_descent1_rr", "fused7_ascent1_rz",
               "fused7_mvdot")
# the kernels held in their filtered-leg forms (the z legs dropped, as the
# threshold schedule's (1, 3, 3) level does)
FLEGS_KERNELS = ("fused7_descent_rr", "fused7_ascent_rz", "fused7_restrict", "fused7_prolong")
# the kernels whose function one PyTorch call computes over the star's CSR
# matrix A (``_star_csr``): y = A x (K1, K1p) as cuSPARSE's CSR matvec,
# b - A x (K10) as ``torch.addmm``, and the P smoothing passes
# (I - g A D^-1) r (K15) and (I - g D^-1 A) t (K16) as the CSR matvec of
# the matrix each applies (``_smoothing_csr``).  K11-K14 have none: each
# adds a D^-1 b term to a matvec (and K12-K14 write two fields)
LIBRARY_TWINNED = (
    "star7_mv_padded", "star7_mv", "fused7_residual", "fused7_restrict", "fused7_prolong",
)
# the kernels of csrc/fused7.cu by name, as the profiler reports them
FUSED7_KERNEL = re.compile(r"(?<![\w:])((?:descent1?|ascent1?|restrict|prolong|step|pre2|mvdot|cgmv)_kernel)\b")
# the CG scalars K8/K9 take, as 0-d device tensors (the solve's own form)
BETA, ALPHA_PREV, ALPHA = 0.61, 0.37, 0.519

# the H100 SXM's published peaks: HBM3 bytes/s and f32 FLOP/s outside the
# tensor cores
HBM_BYTES_S, F32_FLOP_S = 3.35e12, 67e12
# f32 operations per domain cell of each kernel's function, counted from
# its arithmetic (a star apply is 10: the centre product, three leg
# products, six sums; a fused dot 2); dia_mv's are 2 per band and row
STAR = 10
FLOPS_PER_CELL = {
    "star7_mv_padded": STAR, "star7_mv": STAR, "fused7_mvdot": STAR + 2,
    "fused7_descent": 4 * STAR + 2, "fused7_descent_rr": 4 * STAR + 4,
    "fused7_ascent": 3 * STAR + 14, "fused7_ascent_rz": 3 * STAR + 16,
    "fused7_descent1": 2 * STAR + 6, "fused7_descent1_rr": 2 * STAR + 8,
    "fused7_ascent1": 2 * STAR + 8, "fused7_ascent1_rz": 2 * STAR + 10,
    "fused7_cgmv": STAR + 6, "fused7_descentu": 4 * STAR + 6,
    "fused7_residual": STAR + 1, "fused7_rich": STAR + 4, "fused7_cheb0": STAR + 4,
    "fused7_cheb": STAR + 6, "fused7_pre2": STAR + 9, "fused7_restrict": STAR + 4,
    "fused7_prolong": STAR + 4,
    "fused7_descent_slab": 4 * STAR + 2, "fused7_ascent_slab": 3 * STAR + 14,
}
REF_CONFIG = str(pathlib.Path(__file__).resolve().parent / "configs" / "SolverOptions_GAMG.info")
# the port's own outcome of the 300^3 reference-config solve on the H100
# (PERF.md): 767 inner in 5 sweeps, CONVERGED_STALLED.  With Richardson(1)
# the inner count follows the dots' summation order (PERF.md): 5% of it,
# and a sweep either way
REF_INNER, REF_INNER_WINDOW, REF_OUTER = 767, 40, (4, 5, 6)
# the plain layout's 300^3 inner count (the padded route's 34: both run
# Chebyshev(2) over the same hierarchy)
PLAIN_INNER = 34


def _star_offsets(nz, ny, nx):
    return (-ny * nx, -nx, -1, 0, 1, nx, ny * nx)


def _box_offsets(nz, ny, nx):
    """The 27 offsets of a geometric Galerkin level, ascending."""
    return tuple(sorted(
        dz * ny * nx + dy * nx + dx
        for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
    ))


RAGGED = 40 * 11 * 13
# (label, n, offsets, timed): the star and a 27-band set with offsets that
# leave the matrix at both ends at a ragged n, then the aij path's fine
# level (300^3, K = 7) and level 1 (100^3, K = 27)
DIA_CASES = (
    ("star7 n=40*11*13", RAGGED, _star_offsets(40, 11, 13), False),
    ("27-band n=40*11*13", RAGGED,
     (-(RAGGED - 1),) + _box_offsets(40, 11, 13)[1:-1] + (RAGGED - 1,), False),
    ("star7 n=300^3", 300**3, _star_offsets(300, 300, 300), True),
    ("box27 n=100^3", 100**3, _box_offsets(100, 100, 100), True),
)


def _inputs(shape, device, pinned=True):
    """(args per kernel) at ``shape``: the f32 Poisson operator (pinned or
    not) and random padded fields from a fixed numpy seed."""
    grid = Grid3D(shape[2], shape[1], shape[0])
    star = poisson_stencil_device(grid, pin=pinned, dtype=torch.float32, device=device)[0]
    op = PaddedStar.from_star(star)
    rng = np.random.default_rng(SEED)

    def plain():
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device)

    def field():
        return pad_field(plain())

    x, b, t, x1 = field(), field(), field(), field()
    p, ap = field(), field()
    beta, alpha_prev, alpha = (
        torch.tensor(v, dtype=torch.float32, device=device) for v in (BETA, ALPHA_PREV, ALPHA)
    )
    legs = (op.diag, op.cx, op.cy, op.cz)
    pin = (shape, op.pinned)
    return {
        "star7_mv": (star.diag, star.cx, star.cy, star.cz, plain(), star.pinned),
        "fused7_cgmv": (*legs, t, p, x, beta, alpha_prev, *pin),
        "fused7_descentu": (*legs, b, ap, S0, AD, G, GW, alpha, *pin),
        "star7_mv_padded": (*legs, x, *pin),
        "fused7_mvdot": (*legs, x, *pin),
        "fused7_descent_rr": (*legs, b, S0, AD, G, GW, *pin),
        "fused7_ascent_rz": (*legs, t, b, x1, G, AD, G2, GW, *pin),
        "fused7_descent": (*legs, b, S0, AD, G, GW, *pin),
        "fused7_ascent": (*legs, t, b, x1, G, AD, G2, GW, *pin),
        "fused7_descent1_rr": (*legs, b, G, GW, *pin),
        "fused7_ascent1_rz": (*legs, t, b, x1, G, GW, *pin),
        "fused7_descent1": (*legs, b, G, GW, *pin),
        "fused7_ascent1": (*legs, t, b, x1, G, GW, *pin),
        "fused7_residual": (*legs, x, b, *pin),
        "fused7_rich": (*legs, x, b, G, *pin),
        "fused7_cheb0": (*legs, x, b, G, *pin),
        "fused7_cheb": (*legs, x, b, t, AD, G, *pin),
        "fused7_pre2": (*legs, b, S0, AD, G, *pin),
        "fused7_restrict": (*legs, x, GW, *pin),
        "fused7_prolong": (*legs, t, GW, *pin),
    }


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _compare(name, got, want) -> float:
    """Raise unless ``got`` matches ``want``; return the max abs field error."""
    err = 0.0
    for g, w in zip(_as_tuple(got), _as_tuple(want)):
        if w.dim() == 0:  # a fused dot
            rel = abs(g.item() - w.item()) / max(abs(w.item()), 1e-30)
            if rel > 1e-5:
                raise AssertionError(f"{name}: dot {g.item()} vs {w.item()} (rel {rel:.2e})")
            continue
        # atol from this output's own range, so that a small field such as
        # K3's x1 is held to its own scale
        atol = 1e-6 * w.abs().max().item()
        torch.testing.assert_close(g, w, rtol=1e-5, atol=atol, msg=lambda m: f"{name}: {m}")
        err = max(err, (g - w).abs().max().item())
    return err


def _time_ms(fn, args, reps=12, per=5) -> float:
    """Median over ``reps`` of the mean time of ``per`` back-to-back calls."""
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per):
            fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)


def _bound(args, out, flops: float) -> dict:
    """The least time the card could take for a function: the larger of its
    unique bytes (each tensor input read once, each output written once;
    0-d scalars left out) over the HBM rate and ``flops`` over the f32
    rate.  ``passes``: those bytes in fields of the largest tensor's size."""
    seen = {}
    for t in (*args, *_as_tuple(out)):
        if isinstance(t, torch.Tensor) and t.dim() > 0:
            seen[t.data_ptr()] = t.numel() * t.element_size()
    t_bytes, t_ops = sum(seen.values()) / HBM_BYTES_S, flops / F32_FLOP_S
    return {
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "passes": sum(seen.values()) / max(seen.values()),
    }


def _star_csr(diag, cx, cy, cz, pinned) -> torch.Tensor:
    """The 7-point star with these (plain) fields as a CSR tensor of its
    nonzeros: the matrix ``StarStencil3D.mv`` applies, with the legs that
    leave the domain dropped and, if ``pinned``, row and column 0 cut to
    the diagonal."""
    nz, ny, nx = diag.shape
    k, j, i = (torch.arange(m, device=diag.device).reshape(s)
               for m, s in ((nz, (-1, 1, 1)), (ny, (1, -1, 1)), (nx, (1, 1, -1))))

    def leg(c, keep):
        return torch.where(keep, c, 0.0).to(diag.dtype).expand(diag.shape)

    offsets = _star_offsets(nz, ny, nx)
    bands = torch.stack([
        leg(cz, k > 0), leg(cy, j > 0), leg(cx, i > 0), diag,
        leg(cx, i < nx - 1), leg(cy, j < ny - 1), leg(cz, k < nz - 1),
    ]).reshape(len(offsets), -1)
    if pinned:
        for band, off in enumerate(offsets):
            if off:
                bands[band, 0] = 0.0            # row 0
                if off < 0:
                    bands[band, -off] = 0.0     # the entry in column 0
    return _csr_of(bands, offsets)


def _smoothing_csr(csr: torch.Tensor, diag: torch.Tensor, g: float, restrict: bool) -> torch.Tensor:
    """The matrix a P smoothing pass applies, from the star's CSR ``csr``:
    I - g A D^-1 for ``restrict`` (K15), else I - g D^-1 A (K16)."""
    crow, col, val = csr.crow_indices(), csr.col_indices(), csr.values()
    row = torch.repeat_interleave(
        torch.arange(csr.shape[0], dtype=col.dtype, device=col.device), crow.diff(),
    )
    dinv = (1.0 / diag).reshape(-1)
    scaled = val * dinv[col if restrict else row]
    return torch.sparse_csr_tensor(crow, col, (row == col).to(val.dtype) - g * scaled, size=csr.shape)


def _library_call(csr: torch.Tensor, args: dict, name: str, want: torch.Tensor, shape) -> tuple:
    """The one PyTorch call that computes ``name``'s function (see
    ``LIBRARY_TWINNED``) over the star's CSR ``csr``, on the cropped
    fields, held against the twin's output ``want``: (the call, its
    arguments)."""
    a = args[name]
    matvec = (lambda m, v: m @ v)
    if name == "star7_mv":
        call, inputs = matvec, (csr, a[4].reshape(-1).contiguous())
    else:
        def flat(f):
            return crop_field(f, shape).reshape(-1).contiguous()

        want = crop_field(want, shape)
        if name == "star7_mv_padded":
            call, inputs = matvec, (csr, flat(a[4]))
        elif name == "fused7_residual":
            call = lambda m, v, c: torch.addmm(c, m, v, beta=1.0, alpha=-1.0)  # noqa: E731
            inputs = (csr, flat(a[4])[:, None], flat(a[5])[:, None])
        else:
            diag = args["star7_mv"][0]
            call, inputs = matvec, (_smoothing_csr(csr, diag, a[5], name == "fused7_restrict"), flat(a[4]))
    _compare(f"one PyTorch call {name} {shape}", call(*inputs).reshape(-1), want.reshape(-1))
    return call, inputs


def check_flegs(device) -> float:
    """Phase 17's filtered-leg forms: each kernel of ``FLEGS_KERNELS`` with
    the z legs dropped against its twin, at each shape; the max abs error."""
    err = 0.0
    for shape in SHAPES:
        args = _inputs(shape, device)
        for name in FLEGS_KERNELS:
            _src, _rep, kernel, twin = KERNELS[name]
            a = args[name]
            flegs = (a[1], a[2], 0.0)
            got = kernel(*a, flegs=flegs)
            want = twin(*a, flegs=flegs)
            torch.cuda.synchronize()
            e = _compare(f"{name} flegs {shape}", got, want)
            err = max(err, e)
            print(f"kernel {name} {shape} with filtered legs {flegs}: agrees with its twin,"
                  f" max abs err {e:.3e}")
        del args
        torch.cuda.empty_cache()
    return err


def _check_zmarch_fields(label, name, got, want, shape) -> None:
    """Phase 9's z-marching checks beyond ``_compare``: x1 bit-equal to the
    twin's, and every face and pad cell of each output exactly 0."""
    got, want = _as_tuple(got), _as_tuple(want)
    if name.startswith("fused7_descent1"):
        _require(torch.equal(got[0], want[0]), f"{label}: x1 is not bit-equal to the twin's")
    nz, _, nx = shape
    outside = torch.ones(padded_shape(shape), dtype=torch.bool, device=got[0].device)
    outside[FACE:FACE + nz, :, :nx] = False
    for field in got:
        if field.dim():   # a field, or stacked slabs of ``shape`` (K3z/K4z)
            _require(bool((field.reshape(-1, *outside.shape)[:, outside] == 0).all()),
                     f"{label}: a face or pad cell is not 0")


def _dot_agrees(name, got, want, args) -> bool:
    """A z-marching dot within 1e-5 of the twin's, relative to the sum of
    its terms' magnitudes: <b, b> has no cancellation, but <b, x3> (and <b,
    x4>) at a handful of cells can sum to 1% of its terms (-0.0134 from 6
    terms of ~0.3 at (2, 3, 1)), where two summation orders differ by 1e-7
    and a bound on |want| alone would hold rounding to 1e-9.  The other
    dots (<b, b>, K2's <x, A x>) are held to 1e-5 of themselves."""
    if name in ("fused7_ascent_rz", "fused7_ascent1_rz"):
        scale = (args[5] * want[0]).abs().sum().item()   # |b x4|, |b x3|; b = args[5]
    else:
        scale = abs(want[-1].item())
    return abs(got[-1].item() - want[-1].item()) <= 1e-5 * scale


def check_zmarch(device) -> float:
    """Phase 9's z-marching kernels at ``ZMARCH_SHAPES``, pinned and not,
    with the operator's and (those that take them) with filtered legs (z
    dropped), then at 300^3; the max abs field error.  Fields as in
    ``_compare``; dots by ``_dot_agrees``."""
    err, held = 0.0, 0
    cases = [(shape, pinned, flegs) for shape in ZMARCH_SHAPES for pinned in (True, False)
             for flegs in (False, True)] + [(SHAPES[-1], True, False)]
    for shape, pinned, flegs in cases:
        args = _inputs(shape, device, pinned)
        for name in ZMARCH:
            if flegs and name in ZMARCH_NO_FLEGS:
                continue
            _src, _rep, kernel, twin = KERNELS[name]
            a = args[name]
            legs = (a[1], a[2], 0.0) if flegs else None
            kw = {} if name in ZMARCH_NO_FLEGS else {"flegs": legs}
            got, want = kernel(*a, **kw), twin(*a, **kw)
            torch.cuda.synchronize()
            label = f"{name} {shape} pinned={pinned} flegs={legs}"
            fields = slice(None, -1) if name in ZMARCH_DOTS else slice(None)
            err = max(err, _compare(label, _as_tuple(got)[fields], _as_tuple(want)[fields]))
            if fields.stop is not None:
                _require(_dot_agrees(name, got, want, a),
                         f"{label}: dot {got[-1].item()} vs {want[-1].item()}")
            _check_zmarch_fields(label, name, got, want, shape)
            held += 1
        del args
    torch.cuda.empty_cache()
    print(f"z-marching {', '.join(ZMARCH)}: agree with their twins in {held} calls at {len(cases)} cases"
          f" ({len(ZMARCH_SHAPES)} ragged shapes pinned and not, with and without filtered legs, and"
          f" {SHAPES[-1]}), K6's x1 bit-equal, faces and pads 0; max abs err {err:.3e}")
    for name in ZMARCH:
        kind = name.removeprefix("fused7_").removesuffix("_rr").removesuffix("_rz")
        plan = zmarch_plan(SHAPES[-1], kind)
        attrs = zmarch_attributes(name)
        print(f"kernel {name}: {attrs['registers']} registers, {attrs['spilled_bytes']} spilled bytes a"
              f" thread, {plan.smem_bytes} + {attrs['static_smem_bytes']} shared bytes a block,"
              f" {plan.blocks_per_sm} blocks an SM; at {SHAPES[-1]} {plan.blocks} blocks of"
              f" {plan.tile[0]} x {plan.tile[1]} x {plan.zchunk} ({plan.waves():.2f} waves)")
    return err


def check_kernels(device, names=STENCIL_KERNELS, unpinned=False) -> dict:
    """Phases 3, 9, 13 and 17: each kernel of ``names`` vs its twin at each
    shape (with ``unpinned``, also on the unpinned operator at the first);
    times and bounds at the last.  The kernels of ``LIBRARY_TWINNED`` also
    have one PyTorch call over the star's CSR that computes their function:
    checked at each shape, timed at the last as their ``library_ms``; the
    other kernels' is null."""
    rows = {}
    if unpinned:
        args = _inputs(SHAPES[0], device, pinned=False)
        for name in names:
            _src, _rep, kernel, twin = KERNELS[name]
            got = kernel(*args[name])
            want = twin(*args[name])
            torch.cuda.synchronize()
            err = _compare(f"{name} {SHAPES[0]} unpinned", got, want)
            rows.setdefault(name, {"max_abs_err": 0.0, "library_ms": None})["max_abs_err"] = err
            print(f"kernel {name} {SHAPES[0]} unpinned: agrees with its twin, max abs err {err:.3e}")
        del args
    for shape in SHAPES:
        args = _inputs(shape, device)
        library, csr = {}, None
        for name in names:
            _src, _rep, kernel, twin = KERNELS[name]
            got = kernel(*args[name])
            want = twin(*args[name])
            torch.cuda.synchronize()
            err = _compare(f"{name} {shape}", got, want)
            row = rows.setdefault(name, {"max_abs_err": 0.0, "library_ms": None})
            row["max_abs_err"] = max(row["max_abs_err"], err)
            print(f"kernel {name} {shape}: agrees with its twin, max abs err {err:.3e}")
            if name in LIBRARY_TWINNED:
                if csr is None:
                    star = args["star7_mv"]
                    csr = _star_csr(*star[:4], star[5])
                library[name] = _library_call(csr, args, name, want, shape)
                print(f"one PyTorch call (cuSPARSE) {name} {shape}: agrees with the twin")
            if shape == SHAPES[-1]:
                row.update(_bound(args[name], got, FLOPS_PER_CELL[name] * math.prod(shape)))
        if shape == SHAPES[-1]:
            for name in names:
                _src, _rep, kernel, twin = KERNELS[name]
                rows[name]["ms"] = _time_ms(kernel, args[name])
                rows[name]["plain_ms"] = _time_ms(twin, args[name])
                if name in library:
                    rows[name]["library_ms"] = _time_ms(*library[name])
                print(
                    f"time {name} {shape}: kernel {rows[name]['ms']:.4f} ms,"
                    f" plain {rows[name]['plain_ms']:.4f} ms,"
                    f" bound {rows[name]['bound_ms']:.4f} ms ({rows[name]['bound_by']},"
                    f" {rows[name]['passes']:.2f} field passes;"
                    f" {100 * rows[name]['bound_ms'] / rows[name]['ms']:.0f}% of it),"
                    f" one PyTorch call {rows[name]['library_ms']} ms"
                )
        del args, library, csr
        torch.cuda.empty_cache()
    return rows


def _csr_of(bands: torch.Tensor, offsets) -> torch.Tensor:
    """The nonzeros of the DIA matrix (``bands``, ``offsets``) as a CSR
    tensor: the same function for the library call cuSPARSE runs (columns
    ascend in each row with the ascending offsets)."""
    k, n = bands.shape
    rows = torch.arange(n, device=bands.device)[:, None]
    cols = rows + torch.tensor(offsets, device=bands.device)[None, :]
    keep = (cols >= 0) & (cols < n) & (bands.t() != 0)
    crow = torch.zeros(n + 1, dtype=torch.int32, device=bands.device)
    crow[1:] = torch.cumsum(keep.sum(dim=1), 0)
    return torch.sparse_csr_tensor(
        crow, cols[keep].to(torch.int32), bands.t()[keep], size=(n, n),
    )


def check_dia(device) -> dict:
    """Phase 6: K5 against its twin at each case; at the timed ones its
    time, its bound and the time of the cuSPARSE CSR matvec of the same
    matrix (``torch.sparse_csr_tensor(...) @ x``), which must agree with
    the twin too.  The row keeps the first timed case's numbers."""
    row = {"max_abs_err": 0.0}
    rng = np.random.default_rng(SEED)
    for label, n, offsets, timed in DIA_CASES:
        bands = torch.from_numpy(rng.standard_normal((len(offsets), n), dtype=np.float32)).to(device)
        x = torch.from_numpy(rng.standard_normal(n, dtype=np.float32)).to(device)
        got = dia_mv(bands, x, offsets)
        want = dia_mv_torch(bands, x, offsets)
        torch.cuda.synchronize()
        err = _compare(f"dia_mv {label}", got, want)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        print(f"kernel dia_mv {label} (K={len(offsets)}): agrees with its twin, max abs err {err:.3e}")
        if timed:
            ms = _time_ms(dia_mv, (bands, x, offsets))
            plain_ms = _time_ms(dia_mv_torch, (bands, x, offsets))
            gbs = (len(offsets) + 2) * n * 4 / (ms * 1e-3) / 1e9
            print(f"time dia_mv {label} (K={len(offsets)}): kernel {ms:.4f} ms"
                  f" ({gbs:.1f} GB/s of (K+2)*n*4 bytes), plain {plain_ms:.4f} ms")
            # the cuSPARSE CSR matvec of the same matrix at each timed case;
            # the JSON line carries the fine level's numbers (the first)
            csr = _csr_of(bands, offsets)
            _compare(f"csr matvec {label}", csr @ x, want)
            library_ms = _time_ms(lambda a, v: a @ v, (csr, x))
            bound = _bound((bands, x), got, 2 * len(offsets) * n)
            print(f"time dia_mv {label}: cuSPARSE CSR matvec {library_ms:.4f} ms,"
                  f" bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})")
            if "ms" not in row:
                row.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bound)
            del csr
        del bands, x, got, want
        torch.cuda.empty_cache()
    return row


def _fused7_kernels(fn, args) -> list[str]:
    """The kernels of ``csrc/fused7.cu`` that one call of ``fn(*args)`` ran
    on the card, in order, from ``torch.profiler``'s device events."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return [m.group(1) for m in map(FUSED7_KERNEL.search, names) if m]


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def run_cli(argv: list[str]) -> tuple[dict, dict]:
    """The port's CLI in process with the launch counters reset just
    before: (its JSON sidecar, the launches it made).  Prints its output."""
    kernels.reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    launches = dict(kernels.LAUNCHES)
    text = out.getvalue()
    print(text, end="")
    print(f"launches: {json.dumps({k: v for k, v in launches.items() if v})}")
    _require(rc == 0, f"{argv}: exit code {rc}")
    side = [line for line in text.splitlines() if line.startswith("JSON: ")]
    _require(len(side) == 1, f"{argv}: no JSON sidecar")
    return json.loads(side[0][len("JSON: "):]), launches


def _grid(n: int) -> list[str]:
    return ["-da_grid_x", str(n), "-da_grid_y", str(n), "-da_grid_z", str(n)]


def check_lifted(device, production, blind) -> None:
    """Phase 23: the default aij route at 300^3 (the star proved, solved on
    K1-K4), gated as phase 5 and held beside its count; then the stencil
    and the lifted solve in turn, twice, to tell the route's time from its
    place in the script, beside phase 8's structure-blind ``t_solve``."""
    grid = Grid3D(300, 300, 300)
    torch.cuda.reset_peak_memory_stats(device)
    op_hi, op_lo, b, exact = poisson_dia_device(grid, device=device)
    peak_init = torch.cuda.max_memory_allocated(device) / 1e9
    torch.cuda.reset_peak_memory_stats(device)
    star_lo = star_lift(op_lo, op_hi, grid.shape)[1]
    peak_lift = torch.cuda.max_memory_allocated(device) / 1e9
    print(f"peak device memory at 300^3: the aij assembly {peak_init:.3f} GB, then the lift with the"
          f" system held {peak_lift:.3f} GB")
    ref = poisson_stencil_device(grid, dtype=torch.float32, device=device)[0]
    same = torch.equal(star_lo.diag, ref.diag) and (star_lo.cx, star_lo.cy, star_lo.cz) == (ref.cx, ref.cy, ref.cz)
    print(f"lifted f32 fine operator at 300^3 bitwise the stencil route's: {same}")
    del op_hi, op_lo, b, exact, star_lo, ref
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    rep = solve_poisson(300, mat_type="aij", rtol=1e-8, atol=1e-12, device=device, view=True)
    used = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    print(rep.solver_view)
    print(rep.converged_reason_line())
    print(rep.json_sidecar())
    print(f"launches (lifted aij): {json.dumps({k: v for k, v in used.items() if v})}")
    print(f"lifted aij 300^3: {rep.iters} inner + {rep.outer_iters} outer (phase 5: {production.iters} +"
          f" {production.outer_iters}; equal: {(rep.iters, rep.outer_iters) == (production.iters, production.outer_iters)}),"
          f" t_init {rep.t_init:.4f} s, t_setup {rep.t_setup:.4f} s (star_lift"
          f" {1e3 * rep.setup_breakdown.get('star_lift', math.nan):.3f} ms), t_solve {rep.t_solve:.4f} s"
          f" (phase 5: {production.t_solve:.4f} s), peak device memory {peak:.3f} GB")
    _require(rep.reason == 2, f"lifted aij: reason {rep.reason} != 2")
    _require(np.isfinite(rep.linf_error) and rep.linf_error < 1e-4, f"lifted aij: Linf {rep.linf_error} >= 1e-4")
    _require(rep.outer_iters in (2, 3), f"lifted aij: outer iterations {rep.outer_iters} not in 2-3")
    _require(abs(rep.iters - 34) <= 2, f"lifted aij: inner iterations {rep.iters} not within 34 +- 2")
    _require("star DETECTED" in rep.solver_view, "lifted aij: no star detected in its view")
    _require("star_lift" in rep.setup_breakdown, "lifted aij: no star_lift in its setup breakdown")
    for name in STENCIL_KERNELS:
        _require(used[name] > 0, f"the lifted aij route did not launch {name}")
    _require(used["dia_mv"] == 0, "the lifted aij route launched dia_mv")

    times = {"stencil": [], "lifted aij": []}
    for _ in range(2):
        for label, kw in (("stencil", {}), ("lifted aij", {"mat_type": "aij"})):
            again = solve_poisson(300, rtol=1e-8, atol=1e-12, device=device, **kw)
            _require(again.reason == 2, f"{label} in turn: reason {again.reason} != 2")
            times[label].append((again.t_setup, again.t_solve))
            print(f"in turn, {label} 300^3: {again.iters} inner + {again.outer_iters} outer,"
                  f" t_setup {again.t_setup:.4f} s, t_solve {again.t_solve:.4f} s")
    print(f"300^3 t_solve (t_setup) in turn: " + "; ".join(
        f"{label} " + ", ".join(f"{b:.4f} ({a:.4f})" for a, b in runs) for label, runs in times.items()
    ) + f"; phase 5 {production.t_solve:.4f}, phase 23 {rep.t_solve:.4f}, phase 8 (structure-blind)"
        f" {blind.t_solve:.4f} s")


def check_uniform_aij_and_records() -> None:
    """Phases 24-26 at 100^3 through the CLI: uniform precision on the aij
    route (the lift), the eigenvalues and monitor records of uniform
    precision, and the bf16 hierarchy."""
    tol = {"f64": "1e-8", "f32": "1e-6"}
    for precision in ("f64", "f32"):
        side, used = run_cli([*_grid(100), "-mat_type", "aij", "-precision", precision, "-ksp_rtol",
                              tol[precision], "-ksp_atol", "1e-12", "-ksp_converged_reason", "-ksp_view"])
        label = f"-mat_type aij -precision {precision}"
        print(f"{label} at 100^3: {side['iters']} iterations, reason {side['reason']}, Linf"
              f" {side['linf_error']:.6e}, t_init {side['t_init']:.4f} s, breakdown {side['setup_breakdown']}")
        _require(side["reason"] > 0, f"{label}: reason {side['reason']} is not positive")
        _require(np.isfinite(side["linf_error"]) and side["linf_error"] < 1e-3,
                 f"{label}: Linf {side['linf_error']} >= 1e-3")
        _require("star_lift" in side["setup_breakdown"], f"{label}: the matrix was not lifted")
        _require((used["star7_mv"] > 0) == (precision == "f32"),
                 f"{label}: star7_mv launched {used['star7_mv']} times")
        _require(used["dia_mv"] == 0, f"{label} launched dia_mv")

    side, _ = run_cli([*_grid(100), "-precision", "f64", "-ksp_compute_eigenvalues", "-ksp_rtol", "1e-8",
                       "-ksp_atol", "1e-12", "-ksp_converged_reason"])
    eigs = side["eigenvalues"] or []
    _require(side["reason"] > 0 and len(eigs) == side["iters"] and eigs[0] > 0,
             f"-ksp_compute_eigenvalues: {len(eigs)} Ritz values for {side['iters']} iterations,"
             f" least {eigs[:1]}")
    for ksp in ("cg", "gmres"):
        side, _ = run_cli([*_grid(100), "-precision", "f64", "-ksp_type", ksp, "-ksp_monitor", "-ksp_rtol",
                           "1e-8", "-ksp_atol", "1e-12", "-ksp_converged_reason"])
        hist = side["residual_history"] or []
        _require(side["reason"] > 0 and len(hist) == side["iters"] + 1,
                 f"-ksp_monitor {ksp}: {len(hist)} norms for {side['iters']} iterations")

    for argv, rtol in ((["-layout", "plain"], "1e-8"), (["-precision", "f32"], "1e-6")):
        base = [*_grid(100), *argv, "-ksp_rtol", rtol, "-ksp_atol", "1e-12", "-ksp_converged_reason"]
        f32, _ = run_cli(base)
        side, _ = run_cli([*base, "-pc_dtype", "bf16", "-ksp_view"])
        label = f"-pc_dtype bf16 {' '.join(argv)}"
        print(f"{label} at 100^3: {side['iters']} inner + {side['outer_iters']} outer, reason"
              f" {side['reason']}, Linf {side['linf_error']:.6e}, t_solve {side['t_solve']:.4f} s; the f32"
              f" cycle {f32['iters']} inner + {f32['outer_iters']} outer, t_solve {f32['t_solve']:.4f} s")
        _require(side["reason"] > 0, f"{label}: reason {side['reason']} is not positive")
        _require(np.isfinite(side["linf_error"]) and side["linf_error"] < 1e-3,
                 f"{label}: Linf {side['linf_error']} >= 1e-3")
        _require("pc_dtype: bf16" in side["solver_view"], f"{label}: no bf16 hierarchy in its view")


def _slab_inputs(shape, p, device, pinned):
    """Phase 27's inputs: the f32 operator's ``FusedSharded`` over p shards,
    b, t and x1 from a fixed numpy seed in the stacked layout with their
    halos refreshed (as ``FusedSharded.descent``/``ascent`` leave them), and
    the same fields unsharded in the padded layout with ``op``, the
    ``PaddedStar``."""
    grid = Grid3D(shape[2], shape[1], shape[0])
    star = poisson_stencil_device(grid, pin=pinned, dtype=torch.float32, device=device)[0]
    fs = FusedSharded.build(star, make_z_mesh(p, device))
    rng = np.random.default_rng(SEED)
    plain = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device) for _ in range(3)]
    stacked = [fs.exchange_(fs.to_stacked(f)) for f in plain]
    return fs, stacked, PaddedStar.from_star(star), [pad_field(f) for f in plain]


def _slab_args(fs, stacked, sl, z0):
    """(K3z args, K4z args) of the slabs ``sl`` (an index: one slab, q = 1;
    a slice: the stack) whose first domain plane is global plane ``z0``."""
    b, t, x1 = (f[sl] for f in stacked)
    legs = (fs.diag_st[sl], fs.cx, fs.cy, fs.cz)
    place = (fs.local_shape, fs.pinned, z0, fs.shape[0])
    return (*legs, b, S0, AD, G, GW, *place), (*legs, t, b, x1, G, AD, G2, GW, *place)


def check_slab(device, cases=SLAB_CASES) -> dict:
    """Phase 27's kernels: K3z/K4z in one launch over every slab of the
    stack (q = p) and in one launch a slab (q = 1), each against its twin
    (as ``_compare``, every face and pad cell 0); the two bit-equal, and the
    slabs' domain planes bit-equal to one unsharded K3'/K4' launch on the
    whole field.  At the last case the stacked launch is timed beside its
    twin, the p single-slab launches and one unsharded launch, with its
    bound over the stacked fields, waves and chunks, and the chunk counts
    around the plan's.  Registers and spills are gated.  The rows."""
    rows = {name: {"max_abs_err": 0.0, "library_ms": None} for name in SLAB_KERNELS}
    for shape, p, pinned in cases:
        fs, stacked, op, padded = _slab_inputs(shape, p, device, pinned)
        nz_l, ny, nx = fs.local_shape
        runs = {}
        for sl, z0 in ((slice(None), 0), *((i, i * nz_l) for i in range(p))):
            for name, a in zip(SLAB_KERNELS, _slab_args(fs, stacked, sl, z0)):
                _src, _rep, kernel, twin = KERNELS[name]
                before = kernels.LAUNCHES[name]
                got, want = kernel(*a), twin(*a)
                torch.cuda.synchronize()
                label = f"{name} {shape} p={p} {'stack' if sl == slice(None) else f'shard {sl}'} pinned={pinned}"
                _require(kernels.LAUNCHES[name] == before + 1, f"{label}: not one launch")
                e = _compare(label, got, want)
                rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], e)
                _check_zmarch_fields(label, name, got, want, fs.local_shape)
                runs.setdefault(name, []).append(_as_tuple(got))
        legs = (op.diag, op.cx, op.cy, op.cz)
        b, t, x1 = padded
        whole = {
            "fused7_descent_slab": fused7_descent(*legs, b, S0, AD, G, GW, shape, pinned),
            "fused7_ascent_slab": (fused7_ascent(*legs, t, b, x1, G, AD, G2, GW, shape, pinned),),
        }
        for name, (stack, *single) in runs.items():
            for k, field in enumerate(whole[name]):
                _require(torch.equal(stack[k], torch.stack([o[k] for o in single])),
                         f"{name} {shape} p={p} pinned={pinned}: output {k} of the stacked launch is not bit-equal"
                         " to the single-slab launches'")
                sharded = stack[k][:, FACE:FACE + nz_l, :, :nx].reshape(shape)
                _require(torch.equal(sharded, crop_field(field, shape)),
                         f"{name} {shape} p={p} pinned={pinned}: output {k} is not bit-equal to one unsharded"
                         f" launch's (max abs diff {(sharded - crop_field(field, shape)).abs().max().item():.3e})")
        print(f"K3z/K4z {shape} p={p} pinned={pinned}: one launch over the {p} slabs and one a slab agree with"
              f" their twins, faces and pads 0, bit-equal to each other and, on the domain planes, to one"
              f" unsharded K3'/K4' launch")
        if (shape, p, pinned) == cases[-1]:
            _time_slab(rows, fs, stacked, op, padded)
        del fs, stacked, op, padded, runs, whole
        torch.cuda.empty_cache()
    for name in SLAB_KERNELS:
        attrs = zmarch_attributes(name)
        print(f"kernel {name}: {attrs['registers']} registers, {attrs['spilled_bytes']} spilled bytes a thread,"
              f" {attrs['static_smem_bytes']} static shared bytes a block")
        _require(attrs["registers"] <= 96 and attrs["spilled_bytes"] == 0,
                 f"{name}: {attrs['registers']} registers, {attrs['spilled_bytes']} spilled bytes (96, 0 allowed)")
    return rows


# phase 27's sweep of z-chunk counts a slab at 300^3 over 4 shards, around
# the plan's 3: each timed as one launch of the entry point
SLAB_SWEEP_CHUNKS = (1, 2, 3, 4, 5)


def _slab_entry(name, fs, stacked, plan):
    """One launch of K3z's (K4z's) entry point over the whole stack with
    ``plan`` (any chunk count: the sweep), outside the wrappers' counts."""
    b_st, t_st, x1_st = stacked
    out = [torch.empty_like(b_st) for _ in range(2 if name == "fused7_descent_slab" else 1)]
    geom = launch_args(fs.local_shape, fs.cx, fs.cy, fs.cz, fs.cx, fs.cy, fs.cz)
    place = (int(fs.pinned), 0, fs.shape[0], fs.p, *plan.launch_args())
    if name == "fused7_descent_slab":
        entry = ("tps_descent", _DESCENT_ARGS, b_st.device, b_st.data_ptr(), fs.diag_st.data_ptr(),
                 out[0].data_ptr(), out[1].data_ptr(), None, *geom, S0, AD, G, GW, *place)
    else:
        entry = ("tps_ascent", _ASCENT_ARGS, b_st.device, t_st.data_ptr(), b_st.data_ptr(), x1_st.data_ptr(),
                 fs.diag_st.data_ptr(), out[0].data_ptr(), None, *geom, G, AD, G2, GW, *place)

    def run():
        _build.launch(*entry)
        return out   # the outputs live as long as the launcher
    return run


def _time_slab(rows, fs, stacked, op, padded) -> None:
    """The one stacked launch of each slab kernel at ``fs``'s shape timed
    beside its twin, the p single-slab launches (one a slab, timed as one
    call) and one unsharded K3'/K4' launch; the bound is the stacked
    fields' bytes (each slab's face planes included).  Then the stacked
    launch at each of ``SLAB_SWEEP_CHUNKS`` z-chunks a slab."""
    shape, p, nz_l = fs.shape, fs.p, fs.nz_l
    stack_args = _slab_args(fs, stacked, slice(None), 0)
    single_args = [_slab_args(fs, stacked, i, i * nz_l) for i in range(p)]
    legs = (op.diag, op.cx, op.cy, op.cz)
    b, t, x1 = padded
    unsharded = {
        "fused7_descent_slab": (fused7_descent, (*legs, b, S0, AD, G, GW, shape, fs.pinned)),
        "fused7_ascent_slab": (fused7_ascent, (*legs, t, b, x1, G, AD, G2, GW, shape, fs.pinned)),
    }
    b_st, t_st, x1_st = stacked
    inputs = {"fused7_descent_slab": (fs.diag_st, b_st), "fused7_ascent_slab": (fs.diag_st, t_st, b_st, x1_st)}
    for k, (name, kind) in enumerate(zip(SLAB_KERNELS, ("descent", "ascent"))):
        _src, _rep, kernel, twin = KERNELS[name]
        row = rows[name]
        row["ms"] = _time_ms(kernel, stack_args[k])
        row["plain_ms"] = _time_ms(twin, stack_args[k])
        single_ms = _time_ms(lambda: [kernel(*a[k]) for a in single_args], ())
        one_ms = _time_ms(*unsharded[name])
        out = kernel(*stack_args[k])
        row.update(_bound(inputs[name], out, FLOPS_PER_CELL[name] * math.prod(shape)))
        plan = zmarch_slab_plan(fs.local_shape, kind, p)
        print(f"time {name} {shape} p={p} (one launch, {plan.chunks} chunks of {plan.zchunk} a slab,"
              f" {plan.blocks} blocks, {plan.waves():.2f} waves): kernel {row['ms']:.4f} ms, plain"
              f" {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}, {row['passes']:.2f}"
              f" stacked-field passes; {100 * row['bound_ms'] / row['ms']:.0f}% of it); {p} single-slab launches"
              f" {single_ms:.4f} ms ({single_ms / row['ms']:.2f}x the one launch); one unsharded launch"
              f" {one_ms:.4f} ms ({row['ms'] / one_ms:.2f}x), one PyTorch call None")
        nzp = nz_l + 2 * FACE
        for n in SLAB_SWEEP_CHUNKS:
            zchunk = -(-nzp // n)
            swept = dataclasses.replace(plan, chunks=-(-nzp // zchunk), zchunk=zchunk)
            ms = _time_ms(_slab_entry(name, fs, stacked, swept), ())
            mark = " (the plan's)" if swept.chunks == plan.chunks else ""
            print(f"sweep {name} {shape} p={p}: {swept.chunks} chunks of {zchunk} a slab{mark}, {swept.blocks}"
                  f" blocks, {swept.waves():.2f} waves: {ms:.4f} ms ({100 * row['bound_ms'] / ms:.0f}% of the bound)")


def check_batched(device) -> dict:
    """Phase 28's kernel check: the batched K1p against its twin and, column
    by column, bit for bit against K1p at each case; timed at the last
    beside its twin, the k single K1p launches and cuSPARSE's SpMM."""
    row = {"max_abs_err": 0.0, "library_ms": None}
    for shape, k in BATCHED_CASES:
        nz, ny, nx = shape
        star = poisson_stencil_device(Grid3D(nx, ny, nz), dtype=torch.float32, device=device)[0]
        rng = np.random.default_rng(SEED)
        x = torch.from_numpy(rng.standard_normal((k, *shape), dtype=np.float32)).to(device)
        args = (star.diag, star.cx, star.cy, star.cz, x, star.pinned)
        got, want = star7_mv_batched(*args), star7_mv_torch(*args)
        torch.cuda.synchronize()
        err = _compare(f"star7_mv_batched {shape} k={k}", got, want)
        row["max_abs_err"] = max(row["max_abs_err"], err)

        def singles():
            return [star7_mv(*args[:4], x[c], star.pinned) for c in range(k)]

        one = singles()
        _require(all(torch.equal(got[c], one[c]) for c in range(k)),
                 f"star7_mv_batched {shape} k={k}: a column differs from its K1p launch")
        print(f"kernel star7_mv_batched {shape} k={k}: agrees with its twin, max abs err {err:.3e};"
              f" each column bit-equal to one star7_mv launch")
        if (shape, k) != BATCHED_CASES[-1]:
            continue
        csr = _star_csr(*args[:4], star.pinned)
        block = x.reshape(k, -1).T.contiguous()
        _compare(f"cuSPARSE SpMM {shape} k={k}", (csr @ block).T.reshape(got.shape), want)
        row.update(_bound(args, got, FLOPS_PER_CELL["star7_mv"] * k * math.prod(shape)))
        row["ms"] = _time_ms(star7_mv_batched, args)
        row["plain_ms"] = _time_ms(star7_mv_torch, args)
        row["library_ms"] = _time_ms(lambda m, v: m @ v, (csr, block))
        singles_ms = _time_ms(singles, ())
        print(f"time star7_mv_batched {shape} k={k}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms,"
              f" {k} single star7_mv launches {singles_ms:.4f} ms, one PyTorch call (cuSPARSE SpMM)"
              f" {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']},"
              f" {row['passes']:.2f} field passes; {100 * row['bound_ms'] / row['ms']:.0f}% of it)")
        del csr, block
    torch.cuda.empty_cache()
    return row


@contextlib.contextmanager
def _counting_setups():
    """Count the hierarchy builds of the KSP object (``gamg_setup`` as
    ``tpusparse_torch.ksp`` calls it) while the block runs."""
    builds = [0]
    saved = ksp_module.gamg_setup

    def counted(*args, **kw):
        builds[0] += 1
        return saved(*args, **kw)

    try:
        ksp_module.gamg_setup = counted
        yield builds
    finally:
        ksp_module.gamg_setup = saved


def _timed(device, fn, *args, **kw):
    """(fn's result, its seconds on the host clock, synchronized)."""
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def check_ksp(device, plain, n=300) -> int:
    """Phase 28's solves through the object API at n^3 = 300^3: a KSP
    solve, its reuse for 2b and from x0, and ``mat_solve`` of four columns;
    the batched K1p's launches in ``mat_solve`` returned."""
    op, b, exact = poisson_stencil_device(Grid3D(n, n, n), device=device)
    torch.cuda.reset_peak_memory_stats(device)
    with _counting_setups() as builds:
        kernels.reset_launches()
        ksp = KSP(rtol=1e-8, atol=1e-12)
        _, t_setup = _timed(device, lambda: ksp.set_operators(op).setup())
        first, t_first = _timed(device, ksp.solve, b)
        used = dict(kernels.LAUNCHES)
        second, t_second = _timed(device, ksp.solve, 2.0 * b)
        warm, t_warm = _timed(device, ksp.solve, b, x0=first.x)
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    linf = (first.x - exact).abs().max().item()
    print(f"launches (KSP solve): {json.dumps({k: v for k, v in used.items() if v})}")
    print(f"KSP {n}^3: t_setup {t_setup:.4f} s ({builds[0]} hierarchy build); solve(b) {first.iters} inner +"
          f" {first.outer_iters} outer, reason {first.reason}, Linf {linf:.6e}, {t_first:.4f} s; solve(2b)"
          f" {second.iters} + {second.outer_iters} in {t_second:.4f} s; solve(b, x0=x1) {warm.iters} +"
          f" {warm.outer_iters}, reason {warm.reason}, {t_warm:.4f} s; peak device memory {peak:.3f} GB")
    _require(first.reason == 2, f"KSP: reason {first.reason} != 2")
    _require(np.isfinite(linf) and linf < 1e-4, f"KSP: Linf {linf} >= 1e-4")
    _require(first.outer_iters in (2, 3), f"KSP: outer iterations {first.outer_iters} not in 2-3")
    _require(abs(first.iters - 34) <= 2, f"KSP: inner iterations {first.iters} not within 34 +- 2")
    for name in STENCIL_KERNELS:
        _require(used[name] > 0, f"the KSP solve did not launch {name}")
    _require(builds[0] == 1, f"KSP: {builds[0]} hierarchy builds for three solves, not one")
    scale = 2.0 * first.x.abs().max().item()
    _require((second.x - 2.0 * first.x).abs().max().item() <= 1e-6 * scale, "KSP: x(2b) != 2 x(b) to 1e-6")
    _require(warm.reason > 0 and warm.outer_iters <= 1,
             f"KSP from x0 = x1: reason {warm.reason}, {warm.outer_iters} sweeps, not at most 1")
    del first, second, warm

    cols = torch.stack([b, 5.0 * b, b + 0.1 * torch.sin(7.0 * b), -b])
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    res, t_mat = _timed(device, ksp.mat_solve, cols)
    used = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    iters, reasons = res.iters.tolist(), res.reason.tolist()
    linf = (res.x[0] - exact).abs().max().item()
    print(f"launches (mat_solve): {json.dumps({k: v for k, v in used.items() if v})}")
    print(f"mat_solve {n}^3, columns [b, 5b, b + 0.1 sin(7b), -b]: inner {iters}, outer"
          f" {res.outer_iters.tolist()}, reasons {reasons}, Linf (column 0) {linf:.6e}, {t_mat:.4f} s (the plain"
          f" twin hierarchy's build included), peak device memory {peak:.3f} GB; phase 15: {plain['iters']} +"
          f" {plain['outer_iters']}")
    _require(all(r == 2 for r in reasons), f"mat_solve: reasons {reasons}, not 2 in every column")
    _require(all(abs(i - plain["iters"]) <= 2 for i in iters),
             f"mat_solve: inner {iters}, not each within 2 of phase 15's {plain['iters']}")
    _require(np.isfinite(linf) and linf < 1e-4, f"mat_solve: Linf {linf} >= 1e-4 in column 0")
    _require((res.x[1] - 5.0 * res.x[0]).abs().max().item() <= 1e-5 * res.x[1].abs().max().item(),
             "mat_solve: column 1 != 5 x column 0 to 1e-5")
    _require(used["star7_mv_batched"] > 0, "mat_solve did not launch star7_mv_batched")
    for name, n in used.items():
        _require(not (name.startswith("fused7") and n), f"mat_solve launched {name}")
    return used["star7_mv_batched"]


def check_checkpointed(device, n=100) -> None:
    """Phase 28's checkpointed CG at n^3 = 100^3 (f32 K1p operator, plain
    GAMG cycle): cut by maxiter, resumed, held to one uninterrupted run;
    then a uniform-precision solve under the preconditioned norm."""
    op, b, _ = poisson_stencil_device(Grid3D(n, n, n), dtype=torch.float32, device=device)
    hier = gamg_setup(op, AMGParams())
    kw = dict(rtol=1e-6, m_mv=lambda r: vcycle(hier, r))
    direct = cg(op.mv, b, maxiter=200, **kw)
    with tempfile.TemporaryDirectory(dir=pathlib.Path(__file__).resolve().parent) as tmp:
        cfg = CheckpointConfig(path=pathlib.Path(tmp) / "cg.npz", every=5)
        cut, n_cut = cg_checkpointed(op.mv, b, cfg, maxiter=12, **kw)
        res, total = cg_checkpointed(op.mv, b, cfg, maxiter=200, **kw)
    rel = (res.x - direct.x).abs().max().item() / direct.x.abs().max().item()
    print(f"cg_checkpointed {n}^3 (every 5): cut at {n_cut} (reason {cut.reason}), resumed to {total}"
          f" iterations, reason {res.reason}; uninterrupted {direct.iters}, reason {direct.reason}; x within"
          f" {rel:.3e}")
    _require(not cut.converged() and n_cut == 12, f"cg_checkpointed: the cut run took {n_cut}, reason {cut.reason}")
    _require((total, res.reason) == (direct.iters, direct.reason),
             f"cg_checkpointed: {total} iterations, reason {res.reason}; uninterrupted {direct.iters},"
             f" reason {direct.reason}")
    _require(rel <= 1e-6, f"cg_checkpointed: x differs from the uninterrupted run's by {rel:.3e}")

    rep = solve_poisson(n, precision="f64", rtol=1e-8, atol=1e-12, ksp_norm_type="preconditioned",
                        device=device)
    print(f"ksp_norm_type preconditioned, precision f64 at {n}^3: {rep.iters} iterations, reason {rep.reason},"
          f" Linf {rep.linf_error:.6e}")
    _require(rep.reason > 0, f"ksp_norm_type preconditioned: reason {rep.reason} is not positive")


@contextlib.contextmanager
def _counting_strokes():
    """Count the calls of ``FusedSharded.descent`` and ``ascent`` (the
    sharded cycle's strokes) while the block runs."""
    strokes = {"descent": 0, "ascent": 0}
    saved = {name: getattr(FusedSharded, name) for name in strokes}

    def counted(name, fn):
        def stroke(self, *args):
            strokes[name] += 1
            return fn(self, *args)
        return stroke

    try:
        for name, fn in saved.items():
            setattr(FusedSharded, name, counted(name, fn))
        yield strokes
    finally:
        for name, fn in saved.items():
            setattr(FusedSharded, name, fn)


def check_sharded(device, production, plain) -> dict:
    """Phase 27's solves: the 300^3 ``n_devices=4`` solve (its launches
    returned), its peak memory beside the plain layout's, and ``-devices
    4`` through the CLI at 100^3."""
    torch.cuda.reset_peak_memory_stats(device)
    solve_poisson(300, rtol=1e-8, atol=1e-12, pc="gamg", layout="plain", device=device)
    plain_peak = torch.cuda.max_memory_allocated(device) / 1e9
    torch.cuda.reset_peak_memory_stats(device)
    with _counting_strokes() as strokes:
        kernels.reset_launches()
        rep = solve_poisson(300, rtol=1e-8, atol=1e-12, pc="gamg", layout="padded", n_devices=4, device=device,
                            view=True)
        used = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    print(rep.solver_view)
    print(rep.converged_reason_line())
    print(rep.json_sidecar())
    print(f"launches (n_devices=4): {json.dumps({k: v for k, v in used.items() if v})}")
    print(f"n_devices=4 300^3: {rep.iters} inner + {rep.outer_iters} outer, Linf {rep.linf_error:.6e},"
          f" t_setup {rep.t_setup:.4f} s, t_solve {rep.t_solve:.4f} s, peak device memory {peak:.3f} GB (the"
          f" plain layout's {plain_peak:.3f} GB);"
          f" phase 5 {production.iters} + {production.outer_iters} in {production.t_solve:.4f} s, phase 15"
          f" {plain['iters']} + {plain['outer_iters']} in {plain['t_solve']:.4f} s")
    _require(rep.reason == 2, f"n_devices=4: reason {rep.reason} != 2")
    _require(np.isfinite(rep.linf_error) and rep.linf_error < 1e-4, f"n_devices=4: Linf {rep.linf_error} >= 1e-4")
    _require(rep.outer_iters in (2, 3), f"n_devices=4: outer iterations {rep.outer_iters} not in 2-3")
    _require(abs(rep.iters - plain["iters"]) <= 2,
             f"n_devices=4: {rep.iters} inner, not within 2 of phase 15's {plain['iters']}")
    k3z, k4z = used["fused7_descent_slab"], used["fused7_ascent_slab"]
    print(f"n_devices=4: K3z / K4z {k3z} / {k4z} launches in {strokes['descent']} / {strokes['ascent']} strokes")
    _require(k3z > 0 and k3z == k4z == strokes["descent"] == strokes["ascent"],
             f"n_devices=4: K3z / K4z launched {k3z} / {k4z} times in {strokes['descent']} / {strokes['ascent']}"
             " strokes, not one a stroke")
    _require(used["star7_mv"] > 0, "n_devices=4 did not launch star7_mv")
    for name in ("fused7_mvdot", "fused7_descent_rr", "fused7_ascent_rz", "fused7_descent", "fused7_ascent"):
        _require(used[name] == 0, f"n_devices=4 launched {name}")

    side, _ = run_cli([*_grid(100), "-devices", "4", "-ksp_rtol", "1e-8", "-ksp_atol", "1e-12",
                       "-ksp_converged_reason"])
    _require(side["reason"] > 0, f"-devices 4: reason {side['reason']} is not positive")
    _require(np.isfinite(side["linf_error"]) and side["linf_error"] < 1e-3,
             f"-devices 4: Linf {side['linf_error']} >= 1e-3")
    _require(side["z_shards"] == 4, f"-devices 4: {side['z_shards']} z-shards in its JSON")
    return used


def _dia_batched_inputs(shape, pinned, k, device, rng):
    """Phase 31's operands: f32 Poisson bands on ``shape`` (pinned or not)
    or random bands of the 27-band set, and a random (k, n) stack."""
    if shape is None:
        n, offsets = DIA_CASES[1][1], DIA_CASES[1][2]
        bands = torch.from_numpy(rng.standard_normal((len(offsets), n), dtype=np.float32)).to(device)
    else:
        nz, ny, nx = shape
        op_lo = poisson_dia_device(Grid3D(nx, ny, nz), pin=pinned, device=device)[1]
        bands, offsets, n = op_lo.bands, op_lo.offsets, op_lo.n_rows
    x = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)).to(device)
    return bands, x, offsets


def check_dia_batched(device) -> dict:
    """Phase 31's kernel check: the batched K5 against its twin and, column
    by column, bit for bit against K5 at each case; timed at the last
    beside its twin, the k single K5 launches and cuSPARSE's SpMM of the
    matrix's CSR with the (n, k) block."""
    row = {"max_abs_err": 0.0}
    rng = np.random.default_rng(SEED)
    for label, shape, pinned, k in DIA_BATCHED_CASES:
        bands, x, offsets = _dia_batched_inputs(shape, pinned, k, device, rng)
        got, want = dia_mv_batched(bands, x, offsets), dia_mv_torch(bands, x, offsets)
        torch.cuda.synchronize()
        err = _compare(f"dia_mv_batched {label} k={k}", got, want)
        row["max_abs_err"] = max(row["max_abs_err"], err)

        def singles():
            return [dia_mv(bands, x[c], offsets) for c in range(k)]

        one = singles()
        _require(all(torch.equal(got[c], one[c]) for c in range(k)),
                 f"dia_mv_batched {label} k={k}: a column differs from its K5 launch")
        print(f"kernel dia_mv_batched {label} (K={len(offsets)}) k={k}: agrees with its twin, max abs err"
              f" {err:.3e}; each column bit-equal to one dia_mv launch")
        if label != DIA_BATCHED_CASES[-1][0]:
            continue
        n = bands.shape[1]
        csr = _csr_of(bands, offsets)
        block = x.T.contiguous()
        _compare(f"cuSPARSE SpMM {label} k={k}", (csr @ block).T.contiguous(), want)
        row.update(_bound((bands, x), got, 2 * len(offsets) * k * n))
        row["ms"] = _time_ms(dia_mv_batched, (bands, x, offsets))
        row["plain_ms"] = _time_ms(dia_mv_torch, (bands, x, offsets))
        row["library_ms"] = _time_ms(lambda m, v: m @ v, (csr, block))
        singles_ms = _time_ms(singles, ())
        one_ms = _time_ms(dia_mv, (bands, x[0], offsets))
        print(f"time dia_mv_batched {label} (K={len(offsets)}) k={k}: kernel {row['ms']:.4f} ms, plain"
              f" {row['plain_ms']:.4f} ms, {k} single dia_mv launches {singles_ms:.4f} ms (one {one_ms:.4f}"
              f" ms), one PyTorch call (cuSPARSE SpMM) {row['library_ms']:.4f} ms, bound"
              f" {row['bound_ms']:.4f} ms ({row['bound_by']}, {100 * row['bound_ms'] / row['ms']:.0f}% of it)")
        del csr, block
    torch.cuda.empty_cache()
    return row


def check_file_route(device, tmp) -> tuple[dict, str]:
    """Phase 29: the reference's ex10 workflow at 300^3 through the CLI:
    ``-mat_view`` writes the assembled system, ``-f`` solves it with
    ``-ksp_view_solution``; the solution file read back.  Returns the
    ``-f`` run's JSON sidecar and the matrix file."""
    mat, sol = f"{tmp}/p300.petsc", f"{tmp}/x300.petsc"
    run_cli([*_grid(300), "-mat_view", f"binary:{mat}", "-ksp_rtol", "1e-8", "-ksp_atol", "1e-12",
             "-ksp_converged_reason"])
    size = pathlib.Path(mat).stat().st_size
    torch.cuda.reset_peak_memory_stats(device)
    side, used = run_cli(["-f", mat, "-ksp_rtol", "1e-8", "-ksp_atol", "1e-12", "-ksp_converged_reason",
                          "-ksp_view", "-ksp_view_solution", f"binary:{sol}"])
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    init = side["init_breakdown"]
    print(f"-f 300^3: file {size / 1e9:.3f} GB; read {init['read']:.3f} s, diagonals {init['diagonals']:.3f} s,"
          f" host_bands {init['host_bands']:.3f} s,"
          f" upload {init['upload']:.3f} s; t_init {side['t_init']:.4f} s, t_setup {side['t_setup']:.4f} s,"
          f" t_solve {side['t_solve']:.4f} s; {side['iters']} inner + {side['outer_iters']} outer, reason"
          f" {side['reason']}, Linf {side['linf_error']:.6e}; peak device memory {peak:.3f} GB")
    _require(side["reason"] == 2, f"-f: reason {side['reason']} != 2")
    _require(np.isfinite(side["linf_error"]) and 0.0 <= side["linf_error"] < 1e-4,
             f"-f: Linf {side['linf_error']} not in [0, 1e-4)")
    _require(side["outer_iters"] in (2, 3), f"-f: outer iterations {side['outer_iters']} not in 2-3")
    _require(abs(side["iters"] - 35) <= 2, f"-f: inner iterations {side['iters']} not within 35 +- 2")
    _require(used["dia_mv"] > 0, "-f did not launch dia_mv")
    for name, count in used.items():
        _require(not (name.startswith(("star7", "fused7")) and count), f"-f launched {name}")
    t0 = time.perf_counter()
    x = load_petsc_vec(sol)
    exact = read_petsc_objects(mat)[2]
    linf = float(np.abs(x - exact).max())
    print(f"-ksp_view_solution: {pathlib.Path(sol).stat().st_size / 1e6:.1f} MB read back in"
          f" {time.perf_counter() - t0:.3f} s with the matrix file; its Linf against the file's exact vector"
          f" {linf:.6e} (the solve's {side['linf_error']:.6e})")
    _require(x.shape == exact.shape and linf == side["linf_error"],
             "-ksp_view_solution: the file's x is not the solve's (its Linf differs)")
    return side, mat


def check_uniform_blind(device) -> None:
    """Phase 30: the structure-blind aij route in uniform precision
    through the CLI (-precision f32 at 300^3 on K5, f64 at 100^3 in plain
    torch), and the standalone block Jacobi from the host CSR at 100^3
    (x-lines, bs = nx: the PCR form past the dense cap)."""
    blind = ["-mat_type", "aij", "-mat_structure_detect", "0", "-ksp_atol", "1e-12", "-ksp_converged_reason"]
    for n, precision, rtol in ((300, "f32", "1e-6"), (100, "f64", "1e-8")):
        side, used = run_cli([*_grid(n), *blind, "-precision", precision, "-ksp_rtol", rtol])
        label = f"-mat_type aij -mat_structure_detect 0 -precision {precision} at {n}^3"
        print(f"{label}: {side['iters']} iterations, reason {side['reason']}, Linf {side['linf_error']:.6e},"
              f" t_init {side['t_init']:.4f} s, t_setup {side['t_setup']:.4f} s, t_solve {side['t_solve']:.4f} s")
        _require(side["reason"] > 0, f"{label}: reason {side['reason']} is not positive")
        _require(np.isfinite(side["linf_error"]) and side["linf_error"] < 1e-3,
                 f"{label}: Linf {side['linf_error']} >= 1e-3")
        _require((used["dia_mv"] > 0) == (precision == "f32"), f"{label}: dia_mv launched {used['dia_mv']} times")
    kernels.reset_launches()
    rep = solve_poisson(100, mat_type="aij", structure_detect=False, pc="bjacobi", assembly="host",
                        amg_params=AMGParams(bjacobi_bs=100), rtol=1e-8, atol=1e-12, device=device)
    print(f"pc='bjacobi' bs=100 (x-lines, PCR) at 100^3: {rep.iters} inner + {rep.outer_iters} outer, reason"
          f" {rep.reason}, Linf {rep.linf_error:.6e}, t_init {rep.t_init:.4f} s, t_setup {rep.t_setup:.4f} s,"
          f" t_solve {rep.t_solve:.4f} s; dia_mv {kernels.LAUNCHES['dia_mv']} launches")
    _require(rep.reason > 0, f"bjacobi: reason {rep.reason} is not positive")
    _require(np.isfinite(rep.linf_error) and rep.linf_error < 1e-3, f"bjacobi: Linf {rep.linf_error} >= 1e-3")


def check_file_mat_solve(device, mat: str, inner: int) -> int:
    """Phase 31's block solve: ``KSP.mat_solve`` of four columns on the
    300^3 matrix read from the file, the hierarchy built before the counts
    are reset; returns the batched K5's launches in ``mat_solve``."""
    objs = read_petsc_objects(mat)
    ksp = KSP(rtol=1e-8, atol=1e-12).set_operators(objs[0], device=device)
    ksp.setup()
    b = torch.as_tensor(objs[1], device=device)
    exact = torch.as_tensor(objs[2], device=device)
    del objs
    cols = torch.stack([b, 5.0 * b, b + 0.1 * torch.sin(7.0 * b), -b])
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    res, t_mat = _timed(device, ksp.mat_solve, cols)
    used = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    iters, reasons = res.iters.tolist(), res.reason.tolist()
    linf = [(res.x[c] - s * exact).abs().max().item() / abs(s) for c, s in ((0, 1.0), (1, 5.0), (3, -1.0))]
    print(f"launches (mat_solve on the file matrix): {json.dumps({k: v for k, v in used.items() if v})}")
    print(f"mat_solve of the 300^3 file matrix, columns [b, 5b, b + 0.1 sin(7b), -b]: inner {iters}, outer"
          f" {res.outer_iters.tolist()}, reasons {reasons}, Linf of columns 0, 1 / 5, 3 {linf}, {t_mat:.4f} s,"
          f" peak device memory {peak:.3f} GB; phase 29: {inner} inner")
    _require(all(r == 2 for r in reasons), f"mat_solve (file): reasons {reasons}, not 2 in every column")
    _require(all(abs(i - inner) <= 2 for i in iters),
             f"mat_solve (file): inner {iters}, not each within 2 of phase 29's {inner}")
    _require(all(np.isfinite(v) and v < 1e-4 for v in linf), f"mat_solve (file): Linf {linf} not < 1e-4")
    _require(used["dia_mv_batched"] > 0, "mat_solve (file) did not launch dia_mv_batched")
    _require(used["dia_mv"] == 0, "mat_solve (file) launched the single dia_mv")
    return used["dia_mv_batched"]


# phase 32: band counts past the old cap of 48, to the DIA family's 192, on
# the ragged n; the timed ones at 1M rows as contiguous bands
WIDE_KS = (49, 65, 192)
WIDE_TIMED = (65, 192)
WIDE_N = 1_000_000
# K5's row at 300^3 with K = 7 in PERF.md section 6 (PRs 12-14): 0.459-0.463 ms
K7_ROW_MS = 0.463


def _within_f32_bound(name, out, bands, x, offsets) -> None:
    """Raise unless ``out`` is within the f32 sum's error bound, K u sum_k
    |b_k x|, of the f64 sum (K5 rounds once a term with __fmaf_rn, its twin
    twice, so the two agree to this bound, not bit for bit)."""
    exact = dia_mv_torch(bands.double(), x.double(), offsets)
    bound = len(offsets) * 2.0**-24 * dia_mv_torch(bands.abs().double(), x.abs().double(), offsets)
    _require(bool(((out.double() - exact).abs() <= bound).all()), f"{name}: outside the f32 sum's error bound")


def check_dia_wide(device, k7_ms: float) -> dict:
    """Phase 32 (K5 past 48 bands): K5 and the batched K5 at K = 49, 65
    and 192 on the ragged n with offsets past both ends, K5 and its twin
    within the f32 error bound of the f64 sum and each batched column bit
    for bit a K5 launch; at 1M rows with K = 65 and 192 (contiguous
    bands) K5 timed beside its twin, its bound and cuSPARSE's CSR matvec;
    and phase 6's K = 7 time at 300^3 within 5% of its row."""
    rng = np.random.default_rng(SEED)
    for k in WIDE_KS:
        n = RAGGED + 7
        offsets = tuple(sorted(rng.choice(np.arange(-n + 1, n), k, replace=False).tolist()))
        bands = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)).to(device)
        x = torch.from_numpy(rng.standard_normal((3, n), dtype=np.float32)).to(device)
        y, ys = dia_mv(bands, x[0], offsets), dia_mv_batched(bands, x, offsets)
        want = dia_mv_torch(bands, x, offsets)
        for label, out in (("dia_mv", y), ("dia_mv_batched", ys), ("twin", want)):
            _within_f32_bound(f"{label} K={k} n={n}", out, bands, x[0] if out.dim() == 1 else x, offsets)
        _require(all(torch.equal(ys[c], dia_mv(bands, x[c], offsets)) for c in range(3)),
                 f"dia_mv_batched K={k}: a column is not bit for bit a K5 launch")
        err = (ys - want).abs().max().item()
        print(f"kernel dia_mv / dia_mv_batched K={k} n={n}: within the f32 bound of the f64 sum, columns"
              f" bit-equal to K5, max abs err vs the twin {err:.3e}")
    out = {}
    for k in WIDE_TIMED:
        offsets = tuple(range(-(k // 2), k - k // 2))
        bands = torch.from_numpy(rng.standard_normal((k, WIDE_N), dtype=np.float32)).to(device)
        x = torch.from_numpy(rng.standard_normal(WIDE_N, dtype=np.float32)).to(device)
        got, want = dia_mv(bands, x, offsets), dia_mv_torch(bands, x, offsets)
        _within_f32_bound(f"dia_mv K={k} n=1M", got, bands, x, offsets)
        ms, plain_ms = _time_ms(dia_mv, (bands, x, offsets)), _time_ms(dia_mv_torch, (bands, x, offsets))
        csr = _csr_of(bands, offsets)
        _within_f32_bound(f"csr matvec K={k}", csr @ x, bands, x, offsets)
        library_ms = _time_ms(lambda a, v: a @ v, (csr, x))
        bound = _bound((bands, x), got, 2 * k * WIDE_N)
        print(f"time dia_mv K={k} n=1M: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cuSPARSE CSR matvec"
              f" {library_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']};"
              f" {100 * bound['bound_ms'] / ms:.0f}% of it)")
        out[k] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bound)
        del bands, x, got, want, csr
        torch.cuda.empty_cache()
    print(f"dia_mv K=7 at 300^3 (phase 6): {k7_ms:.4f} ms, its row {K7_ROW_MS} ms + 5% at most")
    _require(k7_ms <= 1.05 * K7_ROW_MS, f"dia_mv K=7 at 300^3: {k7_ms:.4f} ms, more than 5% over {K7_ROW_MS}")
    return out


def _band61(n: int):
    """The SPD matrix of 61 diagonals (offsets -30..30, diagonal 10,
    off-diagonals -1/(1+|o|)) as a scipy CSR; JAX's KSP solves it in 8
    iterations with GAMG (the greedy route) and 14 with Jacobi."""
    import scipy.sparse as sp

    offs = list(range(-30, 31))
    return sp.diags([np.full(n - abs(o), 10.0 if o == 0 else -1.0 / (1 + abs(o))) for o in offs], offs,
                    shape=(n, n), format="csr")


def _aij_cli(label: str, argv: list[str], linf: float, device) -> tuple[dict, dict]:
    """One aij CLI solve (counters reset just before it), gated: reason 2,
    Linf < ``linf``, K5 launched and no stencil kernel; its setup breakdown
    and peak memory printed."""
    torch.cuda.reset_peak_memory_stats(device)
    side, used = run_cli(argv)
    print(f"{label}: {side['iters']} inner + {side['outer_iters']} outer, reason {side['reason']}, Linf"
          f" {side['linf_error']:.6e}, t_init {side['t_init']:.3f} s, t_setup {side['t_setup']:.3f} s"
          f" {json.dumps(side['setup_breakdown'])}, t_solve {side['t_solve']:.4f} s, peak device memory"
          f" {torch.cuda.max_memory_allocated(device) / 1e9:.3f} GB")
    _require(side["reason"] == 2, f"{label}: reason {side['reason']} != 2")
    _require(np.isfinite(side["linf_error"]) and side["linf_error"] < linf,
             f"{label}: Linf {side['linf_error']} >= {linf}")
    _require(used["dia_mv"] > 0, f"{label} did not launch dia_mv")
    for name in STENCIL_KERNELS:
        _require(used[name] == 0, f"{label} launched the stencil kernel {name}")
    return side, used


def check_greedy(device) -> int:
    """Phase 33 (item 9.2's host routes at 1M rows): the greedy route and
    the block-Jacobi level smoother through the CLI at 100^3, KSP on the
    61-diagonal matrix at 1M rows with GAMG and Jacobi, and each route at
    16^3 on the card against the CPU.  Returns the greedy solve's K5
    launches."""
    tol = ["-ksp_rtol", "1e-8", "-ksp_atol", "1e-12", "-ksp_converged_reason", "-ksp_view"]
    _, used = _aij_cli("greedy 100^3", [*_grid(100), "-mat_type", "aij", "-pc_gamg_aggregation", "greedy", *tol],
                       1e-3, device)
    _aij_cli("aij -pc_bjacobi_bs 100 at 100^3",
             [*_grid(100), "-mat_type", "aij", "-mat_structure_detect", "0", "-pc_bjacobi_bs", "100", *tol],
             1e-3, device)
    n = 1_000_000
    a = _band61(n)
    b = torch.from_numpy(np.random.default_rng(SEED).standard_normal(n)).to(device)
    for pc, want in (("gamg", 8), ("jacobi", 14)):
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        solver = KSP(pc_type=pc, rtol=1e-8).set_operators(a, device=device)
        t1 = time.perf_counter()
        solver.setup()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        kernels.reset_launches()
        res = solver.solve(b)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        rel = (torch.linalg.vector_norm(b - solver._op.mv(res.x)) / torch.linalg.vector_norm(b)).item()
        levels = [(type(lev.op).__name__, lev.op.shape[0]) for lev in solver._pc_state.levels] if pc == "gamg" else []
        print(f"KSP {pc} on the 61-diagonal matrix at 1M rows: {res.iters} inner + {res.outer_iters} outer,"
              f" reason {res.reason}, true relative residual {rel:.3e}, set_operators {t1 - t0:.3f} s, setup"
              f" {t2 - t1:.3f} s, solve {t3 - t2:.4f} s, K5 launches {kernels.LAUNCHES['dia_mv']}, peak device"
              f" memory {torch.cuda.max_memory_allocated(device) / 1e9:.3f} GB, levels {levels}")
        _require(res.reason == 2 and rel <= 1e-8, f"KSP {pc} 61 diagonals: reason {res.reason}, residual {rel}")
        _require(abs(res.iters - want) <= 2, f"KSP {pc} 61 diagonals: {res.iters} inner, not {want} +- 2 (JAX's)")
        _require(kernels.LAUNCHES["dia_mv"] > 0, f"KSP {pc} 61 diagonals did not launch dia_mv")
        del solver, res
    del a, b
    torch.cuda.empty_cache()
    for label, kw in (("greedy", dict(aggregation="greedy")),
                      ("banded", dict(aggregation="banded", structure_detect=False)),
                      ("bjacobi", dict(structure_detect=False, amg_params=AMGParams(bjacobi_bs=16)))):
        kw = dict(rtol=1e-8, atol=1e-12, mat_type="aij", **kw)
        gpu, cpu = solve_poisson(16, device=device, **kw), solve_poisson(16, device="cpu", **kw)
        print(f"16^3 {label}: card {gpu.iters} + {gpu.outer_iters}, CPU {cpu.iters} + {cpu.outer_iters},"
              f" Linf {gpu.linf_error:.6e} / {cpu.linf_error:.6e}")
        _require(gpu.reason == cpu.reason == 2 and gpu.outer_iters == cpu.outer_iters
                 and abs(gpu.iters - cpu.iters) <= 2, f"16^3 {label}: the card's counts are not the CPU's")
    return used["dia_mv"]


def check_banded(device) -> None:
    """Phase 34 (the banded route at full size): -pc_gamg_aggregation
    banded at 300^3 with device assembly, and the deviceaggbench record at
    27M rows."""
    tol = ["-ksp_rtol", "1e-8", "-ksp_atol", "1e-12", "-ksp_converged_reason", "-ksp_view"]
    _aij_cli("banded 300^3", [*_grid(300), "-mat_type", "aij", "-mat_structure_detect", "0",
                              "-pc_gamg_aggregation", "banded", *tol], 1e-4, device)
    kernels.reset_launches()
    rec = deviceaggbench.run(27_000_000, device=device)
    print(f"deviceaggbench: {json.dumps(rec)}")
    print(f"deviceaggbench launches: {json.dumps({k: v for k, v in kernels.LAUNCHES.items() if v})}")
    _require(rec["reason"] > 0, f"deviceaggbench: reason {rec['reason']} is not positive")
    _require(rec["true_rel_residual"] <= 1e-8, f"deviceaggbench: true residual {rec['true_rel_residual']} > 1e-8")
    _require(kernels.LAUNCHES["dia_mv"] > 0, "deviceaggbench did not launch dia_mv")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip())
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s ({lib.name})")

    rows = check_kernels(device)

    small = solve_poisson(24, rtol=1e-8, atol=1e-12, pc="gamg", device=device)
    print(f"24^3: {small.json_sidecar()}")
    # inner within +-1: the card sums the dots in another order
    _require(
        (small.reason, small.outer_iters) == (2, 2)
        and abs(small.iters - 24) <= 1
        and abs(small.linf_error - 1.117e-2) < 1e-5,
        "24^3 solve differs from the JAX package's (24 inner, 2 outer, reason 2, Linf 1.117e-2)",
    )

    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats(device)
    rep, line = headline.run(300, device=device)
    launches = dict(kernels.LAUNCHES)
    print(f"peak device memory of the headline solve: {torch.cuda.max_memory_allocated(device) / 1e9:.3f} GB")
    print(rep.reference_block())
    print(rep.converged_reason_line())
    print(rep.json_sidecar())
    print(f"headline: {json.dumps(line)}")
    print(f"launches: {json.dumps(launches)}")
    _require(rep.reason == 2, f"reason {rep.reason} != 2")
    _require(np.isfinite(rep.linf_error) and rep.linf_error < 1e-4, f"Linf {rep.linf_error} >= 1e-4")
    # 2 or 3 sweeps: the outer count sits on a knife edge (PERF.md), which
    # the order the V-cycle kernels sum <b, b> and <b, z> in decides
    _require(rep.outer_iters in (2, 3), f"outer iterations {rep.outer_iters} not in 2-3")
    _require(abs(rep.iters - 34) <= 2, f"inner iterations {rep.iters} not within 34 +- 2")
    for name in STENCIL_KERNELS:
        _require(launches[name] > 0, f"kernel {name} was not launched by the stencil path")
    production = rep
    rows["dia_mv"] = check_dia(device)

    aij = dict(rtol=1e-8, atol=1e-12, pc="gamg", mat_type="aij", structure_detect=False)
    small = solve_poisson(24, device=device, **aij)
    print(f"24^3 aij: {small.json_sidecar()}")
    _require(
        (small.reason, small.outer_iters) == (2, 2)
        and abs(small.iters - 24) <= 1
        and abs(small.linf_error - 1.117e-2) < 1e-5,
        "24^3 aij solve differs from the JAX package's (24 inner, 2 outer, reason 2, Linf 1.117e-2)",
    )

    kernels.reset_launches()
    rep = solve_poisson(300, device=device, **aij)
    aij_launches = dict(kernels.LAUNCHES)
    print(rep.reference_block())
    print(rep.converged_reason_line())
    print(rep.json_sidecar())
    print(f"launches (aij): {json.dumps(aij_launches)}")
    _require(rep.reason == 2, f"aij reason {rep.reason} != 2")
    _require(np.isfinite(rep.linf_error) and rep.linf_error < 1e-4, f"aij Linf {rep.linf_error} >= 1e-4")
    # 35 + 2 in f32 (the TPU's 42 + 3 differs; the JAX package in f32 on
    # the CPU takes the port's counts at 100^3 and 200^3: PERF.md,
    # Findings).  The outer count sits on the rho start vector's knife edge.
    _require(rep.outer_iters in (2, 3), f"aij outer iterations {rep.outer_iters} not in 2-3")
    _require(abs(rep.iters - 35) <= 2, f"aij inner iterations {rep.iters} not within 35 +- 2")
    _require(aij_launches["dia_mv"] > 0, "dia_mv was not launched by the aij path")
    for name in STENCIL_KERNELS:
        _require(aij_launches[name] == 0, f"the aij path launched the stencil kernel {name}")
    launches["dia_mv"] = aij_launches["dia_mv"]
    blind = rep

    check_zmarch(device)
    rows.update(check_kernels(device, tuple(NEW_KERNELS)))

    t0 = time.perf_counter()
    ref, ref_launches = run_cli(
        [*_grid(300), "-config", REF_CONFIG, "-ksp_converged_reason", "-log_view"]
    )
    print(f"reference config 300^3: {time.perf_counter() - t0:.1f} s in all")
    _require(ref["reason"] > 0, f"reference config: reason {ref['reason']} is not positive")
    _require(np.isfinite(ref["linf_error"]) and ref["linf_error"] < 1e-4,
             f"reference config: Linf {ref['linf_error']} >= 1e-4")
    _require(abs(ref["iters"] - REF_INNER) <= REF_INNER_WINDOW and ref["outer_iters"] in REF_OUTER,
             f"reference config: {ref['iters']} inner + {ref['outer_iters']} outer, not"
             f" {REF_INNER} +- {REF_INNER_WINDOW} in {REF_OUTER}")
    for name in ("fused7_descent1_rr", "fused7_ascent1_rz"):
        _require(ref_launches[name] > 0, f"the reference config did not launch {name}")
    for name in ("fused7_descent_rr", "fused7_ascent_rz"):
        _require(ref_launches[name] == 0, f"the reference config launched {name}")

    gm, gm_launches = run_cli([*_grid(300), "-ksp_type", "gmres", "-ksp_rtol", "1e-8",
                               "-ksp_atol", "1e-12", "-ksp_converged_reason"])
    _require(gm["reason"] > 0, f"gmres: reason {gm['reason']} is not positive")
    _require(np.isfinite(gm["linf_error"]) and gm["linf_error"] < 1e-4,
             f"gmres: Linf {gm['linf_error']} >= 1e-4")
    for name in ("fused7_descent", "fused7_ascent"):
        _require(gm_launches[name] > 0, f"gmres did not launch {name}")

    bc, bc_launches = run_cli([*_grid(48), "-config", REF_CONFIG, "-ksp_type", "bcgs",
                               "-ksp_converged_reason"])
    _require(bc["reason"] > 0, f"bcgs: reason {bc['reason']} is not positive")
    _require(np.isfinite(bc["linf_error"]) and bc["linf_error"] < 3e-3,
             f"bcgs: Linf {bc['linf_error']} >= 3e-3")
    for name in ("fused7_descent1", "fused7_ascent1"):
        _require(bc_launches[name] > 0, f"bcgs did not launch {name}")
    for names, runs in (
        (("fused7_descent1_rr", "fused7_ascent1_rz"), ref_launches),
        (("fused7_descent", "fused7_ascent"), gm_launches),
        (("fused7_descent1", "fused7_ascent1"), bc_launches),
    ):
        for name in names:
            launches[name] = runs[name]

    rows.update(check_kernels(device, tuple(FUSION_KERNELS)))

    kernels.reset_launches()
    fu = solve_poisson(300, rtol=1e-8, atol=1e-12, pc="gamg", device=device, cg_fusion=True)
    fu_launches = dict(kernels.LAUNCHES)
    print(fu.converged_reason_line())
    print(fu.json_sidecar())
    print(f"launches (cg_fusion): {json.dumps({k: v for k, v in fu_launches.items() if v})}")
    print(f"300^3 t_solve: production body {production.t_solve:.4f} s"
          f" ({production.iters} inner + {production.outer_iters} outer),"
          f" full-fusion body {fu.t_solve:.4f} s ({fu.iters} inner + {fu.outer_iters} outer)")
    _require(fu.reason == 2, f"cg_fusion: reason {fu.reason} != 2")
    _require(np.isfinite(fu.linf_error) and fu.linf_error < 1e-4, f"cg_fusion: Linf {fu.linf_error} >= 1e-4")
    _require(fu.outer_iters in (2, 3), f"cg_fusion: outer iterations {fu.outer_iters} not in 2-3")
    _require(abs(fu.iters - production.iters) <= 2,
             f"cg_fusion: {fu.iters} inner, not within 2 of the production body's {production.iters}")
    for name in ("fused7_cgmv", "fused7_descentu", "fused7_ascent_rz"):
        _require(fu_launches[name] > 0, f"cg_fusion did not launch {name}")
    for name in ("fused7_mvdot", "fused7_descent_rr", "fused7_residual", "fused7_restrict"):
        _require(fu_launches[name] == 0, f"cg_fusion launched {name}")
    k9 = _fused7_kernels(fused7_descentu, _inputs(SHAPES[0], device)["fused7_descentu"])
    print(f"one fused7_descentu call runs {k9} of csrc/fused7.cu on the card")
    _require(k9 == ["descent_kernel"], f"one fused7_descentu call ran {k9}, not one descent_kernel")

    pl, pl_launches = run_cli([*_grid(300), "-layout", "plain", "-ksp_rtol", "1e-8",
                               "-ksp_atol", "1e-12", "-ksp_converged_reason"])
    _require(pl["reason"] > 0, f"-layout plain: reason {pl['reason']} is not positive")
    _require(np.isfinite(pl["linf_error"]) and pl["linf_error"] < 1e-4,
             f"-layout plain: Linf {pl['linf_error']} >= 1e-4")
    _require(abs(pl["iters"] - PLAIN_INNER) <= 3 and pl["outer_iters"] in (2, 3),
             f"-layout plain: {pl['iters']} inner + {pl['outer_iters']} outer, not"
             f" {PLAIN_INNER} +- 3 in 2-3")
    _require(pl_launches["star7_mv"] > 0, "-layout plain did not launch star7_mv")
    for name, n in pl_launches.items():
        _require(not (name.startswith("fused7") and n), f"-layout plain launched {name}")

    uniform = {}
    for precision, rtol in (("f64", "1e-8"), ("f32", "1e-6")):
        side, uniform[precision] = run_cli([*_grid(100), "-precision", precision, "-ksp_rtol", rtol,
                                            "-ksp_atol", "1e-12", "-ksp_converged_reason"])
        _require(side["reason"] > 0, f"-precision {precision}: reason {side['reason']} is not positive")
        _require(np.isfinite(side["linf_error"]) and side["linf_error"] < 1e-3,
                 f"-precision {precision}: Linf {side['linf_error']} >= 1e-3")
    _require(uniform["f32"]["star7_mv"] > 0, "-precision f32 did not launch star7_mv")
    _require(not any(uniform["f64"].values()), "-precision f64 launched a kernel")
    launches.update(fused7_cgmv=fu_launches["fused7_cgmv"], fused7_descentu=fu_launches["fused7_descentu"],
                    star7_mv=pl_launches["star7_mv"])

    rows.update(check_kernels(device, tuple(STEP_KERNELS), unpinned=True))
    flegs_err = check_flegs(device)
    print(f"filtered-leg forms of {', '.join(FLEGS_KERNELS)}: max abs err {flegs_err:.3e}")

    cheb3, cheb3_launches = run_cli([*_grid(300), "-mg_levels_ksp_max_it", "3", "-ksp_rtol", "1e-8",
                                     "-ksp_atol", "1e-12", "-ksp_converged_reason"])
    _require(cheb3["reason"] == 2, f"chebyshev(3): reason {cheb3['reason']} != 2")
    _require(np.isfinite(cheb3["linf_error"]) and cheb3["linf_error"] < 1e-4,
             f"chebyshev(3): Linf {cheb3['linf_error']} >= 1e-4")
    _require(cheb3["outer_iters"] in (2, 3) and cheb3["iters"] <= production.iters + 2,
             f"chebyshev(3): {cheb3['iters']} inner + {cheb3['outer_iters']} outer, not at most"
             f" {production.iters} + 2 in 2-3 sweeps")
    for name in ("fused7_pre2", "fused7_cheb", "fused7_cheb0", "fused7_residual", "fused7_restrict",
                 "fused7_prolong"):
        _require(cheb3_launches[name] > 0, f"chebyshev(3) did not launch {name}")
    for name in ("fused7_descent_rr", "fused7_ascent_rz"):
        _require(cheb3_launches[name] == 0, f"chebyshev(3) launched {name}")

    rich3, rich3_launches = run_cli([*_grid(100), "-mg_levels_ksp_type", "richardson",
                                     "-mg_levels_ksp_max_it", "3", "-ksp_rtol", "1e-8",
                                     "-ksp_converged_reason"])
    _require(rich3["reason"] > 0, f"richardson(3): reason {rich3['reason']} is not positive")
    _require(np.isfinite(rich3["linf_error"]) and rich3["linf_error"] < 1e-3,
             f"richardson(3): Linf {rich3['linf_error']} >= 1e-3")
    _require(rich3_launches["fused7_rich"] > 0, "richardson(3) did not launch fused7_rich")
    for name in STEP_KERNELS:
        launches[name] = (rich3_launches if name == "fused7_rich" else cheb3_launches)[name]

    wc, wc_launches = run_cli([*_grid(300), "-pc_mg_cycle_type", "w", "-ksp_rtol", "1e-8",
                               "-ksp_atol", "1e-12", "-ksp_converged_reason", "-ksp_view"])
    _require(wc["reason"] == 2, f"W-cycle: reason {wc['reason']} != 2")
    _require(np.isfinite(wc["linf_error"]) and wc["linf_error"] < 1e-4,
             f"W-cycle: Linf {wc['linf_error']} >= 1e-4")
    _require(wc["iters"] <= production.iters + 2,
             f"W-cycle: {wc['iters']} inner, more than phase 5's {production.iters} + 2")
    for name in ("fused7_descent_rr", "fused7_ascent_rz"):
        _require(wc_launches[name] > 0, f"the W-cycle did not launch {name}")

    box = Grid3D(300, 300, 300, lx=1.0, ly=1.0, lz=3.0)
    sched = threshold_schedule(poisson_stencil_device(box, dtype=torch.float32, device=device)[0], 0.05)
    print(f"threshold 0.05 schedule on the (1, 1, 3) box at 300^3: {sched}")
    _require(sched is not None and sched[0] == (1, 3, 3), f"schedule {sched}: level 0 is not (1, 3, 3)")
    thr = {}
    for threshold in (0.0, 0.05):
        kernels.reset_launches()
        rep = solve_poisson(300, extent=(1.0, 1.0, 3.0), amg_params=AMGParams(threshold=threshold),
                            rtol=1e-8, atol=1e-12, device=device, view=True)
        thr[threshold] = (rep, dict(kernels.LAUNCHES))
        print(rep.solver_view)
        print(f"threshold {threshold}: {rep.iters} inner + {rep.outer_iters} outer, reason {rep.reason},"
              f" Linf {rep.linf_error:.6e}, t_solve {rep.t_solve:.4f} s")
        _require(rep.reason == 2, f"threshold {threshold}: reason {rep.reason} != 2")
    (t0_rep, _), (t5_rep, t5_launches) = thr[0.0], thr[0.05]
    _require(abs(t5_rep.linf_error - t0_rep.linf_error) <= 0.01 * t0_rep.linf_error,
             f"threshold Linf {t5_rep.linf_error} vs {t0_rep.linf_error} at threshold 0: not within 1%")
    _require("coarsening (1, 3, 3) (filtered P smoother)" in t5_rep.solver_view
             and "fused fine level" in t5_rep.solver_view,
             "the threshold solve did not run the fused fine level on the filtered (1, 3, 3) level")
    for name in ("fused7_descent_rr", "fused7_ascent_rz"):
        _require(t5_launches[name] > 0, f"the threshold solve did not launch {name}")

    plain_only = {
        "-mg_levels_pc_type sor": ["-mg_levels_pc_type", "sor"],
        "-mg_coarse_pc_type lu": ["-mg_coarse_pc_type", "lu"],
        "-pc_bjacobi_bs 100": ["-pc_bjacobi_bs", "100"],
        "-pc_type sor": ["-pc_type", "sor"],
        "-pc_type jacobi": ["-pc_type", "jacobi"],
        "-pc_type none": ["-pc_type", "none"],
        "aij lu": ["-mat_type", "aij", "-mat_structure_detect", "0", "-mg_coarse_pc_type", "lu"],
    }
    vcycle_kernels = [name for name in kernels.LAUNCHES
                      if name.startswith("fused7") and name != "fused7_mvdot"]
    for label, argv in plain_only.items():
        side, used = run_cli([*_grid(100), *argv, "-ksp_rtol", "1e-8", "-ksp_atol", "1e-12",
                              "-ksp_converged_reason"])
        print(f"{label} at 100^3: {side['iters']} inner + {side['outer_iters']} outer, reason"
              f" {side['reason']}, Linf {side['linf_error']:.6e}, t_solve {side['t_solve']:.4f} s")
        _require(side["reason"] > 0, f"{label}: reason {side['reason']} is not positive")
        _require(np.isfinite(side["linf_error"]) and side["linf_error"] < 1e-3,
                 f"{label}: Linf {side['linf_error']} >= 1e-3")
        if label == "aij lu":
            _require(used["dia_mv"] > 0, f"{label} did not launch dia_mv")
        elif label in ("-pc_type jacobi", "-pc_type none"):
            _require(used["fused7_mvdot"] > 0, f"{label} did not launch fused7_mvdot")
            for name in vcycle_kernels:
                _require(used[name] == 0, f"{label} launched the V-cycle kernel {name}")
        else:
            _require(used["star7_mv"] > 0, f"{label} did not launch star7_mv")
            for name, n in used.items():
                _require(not (name.startswith("fused7") and n), f"{label} launched {name}")

    check_lifted(device, production, blind)
    check_uniform_aij_and_records()

    rows.update(check_slab(device))
    sharded = check_sharded(device, production, pl)
    for name in SLAB_KERNELS:
        launches[name] = sharded[name]

    rows["star7_mv_batched"] = check_batched(device)
    launches["star7_mv_batched"] = check_ksp(device, pl)
    check_checkpointed(device)

    # phases 29-31 share the 300^3 system file, removed at their end
    tmp = tempfile.mkdtemp(prefix="chip_smoke_", dir=pathlib.Path(__file__).resolve().parent)
    try:
        side, mat = check_file_route(device, tmp)
        check_uniform_blind(device)
        rows["dia_mv_batched"] = check_dia_batched(device)
        launches["dia_mv_batched"] = check_file_mat_solve(device, mat, side["iters"])
    finally:
        shutil.rmtree(tmp)

    t0 = time.perf_counter()
    check_dia_wide(device, rows["dia_mv"]["ms"])
    check_greedy(device)
    check_banded(device)
    print(f"phases 32-34: {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": [
        {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": rows[name]["max_abs_err"],
            "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
            "bound_ms": rows[name]["bound_ms"], "bound_by": rows[name]["bound_by"],
            "library_ms": rows[name]["library_ms"],
        }
        for name, (src, replaces, _k, _t) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
