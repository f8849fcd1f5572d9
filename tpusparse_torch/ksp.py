"""KSP — the PETSc-style reusable solver object; port of ``tpusparse/ksp.py``.

The reference's driver is seven API calls (``src/main_ksp.cpp:92-117``):
``KSPCreate``, ``KSPSetOperators(A, A)``, ``KSPSetType(KSPCG)``,
``KSPSetReusePreconditioner(PETSC_TRUE)``, ``KSPSetFromOptions``,
``KSPSetUp``, ``KSPSolve``, then ``KSPGetIterationNumber`` /
``KSPGetResidualNorm`` / ``KSPGetConvergedReason``.  ``KSP`` is that object:
construct it once (optionally from an ``Options``), attach an operator and
call ``solve(b)`` as often as needed.  The preconditioner built by
``setup()`` is reused across right-hand sides and, with
``reuse_preconditioner=True`` (the reference's own setting,
``main_ksp.cpp:95``), across operator swaps.

The work runs in the modules the driver uses (``amg/hierarchy.py``,
``amg/unstructured.py``, ``solve/refine.py``, ``bench/driver.py::
refined_solve`` on the padded layout), so the object and the CLI solve
alike.  The solve runs on the device of the operator's tensors: the
operators of ``grid/poisson.py`` are built on the ``device`` they are
given, and every kernel wrapper dispatches by tensor device.

Example::

    from tpusparse_torch import KSP, Grid3D
    from tpusparse_torch.grid.poisson import poisson_stencil_device

    op, b, exact = poisson_stencil_device(Grid3D(96, 96, 96), device="cuda")
    ksp = KSP(rtol=1e-8)              # CG + GAMG, mixed precision
    ksp.set_operators(op)
    x = ksp.solve(b).x                # KSPSetUp happens here, once
    x2 = ksp.solve(2.0 * b).x         # reuses the hierarchy
    xs = ksp.mat_solve(torch.stack([b, 5.0 * b])).x   # KSPMatSolve

A host matrix (``HostCSR``, or anything scipy can turn into a CSR) goes
to the device as the DIA family, as in the JAX package: under mixed
precision one f32 upload is both the hierarchy's fine operator and the hi
half of a ``DFDIA`` outer operator; under uniform precision one ``DIA`` in
the solve's dtype is both operators.  The host matrix is kept for
``pc_type="bjacobi"`` and for GAMG's greedy setup and block-Jacobi level
smoother (``amg/unstructured.py``), which take it where its pattern is no
3-D grid.  A host matrix with more than 192 diagonals and
``mat_reorder="rcm"`` (RCM and the banded-ELL executor, ROADMAP queue 1,
item 10) raise ``NotImplementedError``.  The JAX package's
``_solve_chunked`` (a libtpu workaround) and jit caches are not to port.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any

import numpy as np
import torch

from tpusparse_torch.amg.fused_cycle import fused_fine_supported, vcycle_fused
from tpusparse_torch.amg.hierarchy import (
    AMGParams,
    cast_coarse_coefs,
    cast_hierarchy,
    gamg_setup,
    plain_cycle_only,
    vcycle,
)
from tpusparse_torch.amg.unstructured import gamg_setup_unstructured
from tpusparse_torch.bench.driver import DivergedError, _pick_ksp, _ssor, _standalone_pc, refined_solve
from tpusparse_torch.solve.cg import cg
from tpusparse_torch.solve.multi import MultiResult, cg_multi, refined_multi
from tpusparse_torch.solve.refine import cg_refined
from tpusparse_torch.solve.spectrum import ritz_values
from tpusparse_torch.sparse.csr import HostCSR
from tpusparse_torch.sparse.dia import DFDIA, DIA, host_dia_operators
from tpusparse_torch.sparse.reorder import distinct_diagonals
from tpusparse_torch.sparse.padded import PaddedStar, crop_field, pad_field
from tpusparse_torch.sparse.stencil import StarStencil3D

__all__ = ["KSP", "KSPResult"]

_ITEM_10 = (
    "is not ported to tpusparse_torch yet (ROADMAP queue 1, item 10: RCM reordering and the"
    " banded-ELL executor)"
)


@dataclasses.dataclass
class KSPResult:
    """What ``KSPSolve`` leaves behind (the Get* accessors' data)."""

    x: torch.Tensor
    iters: int            # KSPGetIterationNumber
    resnorm: float        # KSPGetResidualNorm
    reason: int           # KSPGetConvergedReason (PETSc numbering)
    outer_iters: int = 0  # defect-correction sweeps (mixed precision only)

    @property
    def converged(self) -> bool:
        return self.reason > 0


def _op_kind(op) -> str:
    """'structured' (the star stencil), 'general' (the DIA family) or
    'opaque' (anything with an ``mv``)."""
    if isinstance(op, StarStencil3D):
        return "structured"
    if isinstance(op, (DIA, DFDIA)):
        return "general"
    return "opaque"


def _cast_floating(op, dtype: torch.dtype):
    """A same-structure twin of ``op`` with its floating fields in
    ``dtype`` (the JAX package's tree map over float leaves; the legs of a
    star, Python floats here, rounded to ``dtype``'s values).  An operator
    that is not a dataclass is its own twin."""
    if dataclasses.is_dataclass(op) and not isinstance(op, type):
        return cast_hierarchy(op, dtype)
    return op


class KSP:
    """Reusable Krylov solver object (PETSc ``KSP`` parity).

    Parameters mirror the options the CLI accepts (``config/options.py``):
    ``ksp_type`` (cg | pipecg | gmres | fgmres | bcgs | minres | chebyshev
    | richardson | preonly), ``pc_type`` (gamg | jacobi | sor | bjacobi |
    none), tolerances, and ``precision`` ("mixed" = f32 inner solves under
    f64 defect correction; "f64"/"f32" uniform).

    ``layout`` (structured operators under mixed precision with GAMG):
    "padded" runs the padded-resident fused route (K1-K4, as
    ``solve_poisson``); "plain" the plain cycle (K1p); "auto" takes the
    padded route unless the GAMG options ask for the plain cycle
    (``plain_cycle_only``), the JAX package's rule on its TPU
    (``tpusparse/ksp.py:383-389``) and the port driver's.

    ``reuse_preconditioner=True`` is ``KSPSetReusePreconditioner``: once
    ``setup()`` has built the preconditioner, later ``set_operators`` calls
    keep it (the new operator is applied, the old preconditioner
    preconditions).  ``error_if_not_converged`` is
    ``-ksp_error_if_not_converged``: raise ``DivergedError`` on a negative
    reason.  ``mat_reorder``: "auto" and "none" are accepted (no host
    matrix that the port takes needs a reordering); "rcm" raises
    ``NotImplementedError``.
    """

    def __init__(
        self,
        *,
        ksp_type: str = "cg",
        pc_type: str = "gamg",
        rtol: float = 1e-14,
        atol: float = 1e-12,
        divtol: float = 1e5,
        maxiter: int = 10000,
        precision: str = "mixed",
        amg_params: AMGParams | None = None,
        mg_cycle: str = "v",
        reuse_preconditioner: bool = True,
        gmres_restart: int = 30,
        richardson_scale: float = 1.0,
        layout: str = "auto",
        error_if_not_converged: bool = False,
        mat_reorder: str = "auto",
    ):
        if precision not in ("mixed", "f64", "f32"):
            raise ValueError(f"unknown precision {precision!r}")
        if pc_type not in ("gamg", "jacobi", "sor", "bjacobi", "none"):
            raise ValueError(f"unknown pc_type {pc_type!r}")
        if mg_cycle not in ("v", "w"):
            raise ValueError(f"unknown mg_cycle {mg_cycle!r}")
        if layout not in ("auto", "padded", "plain"):
            raise ValueError(f"unknown layout {layout!r}")
        if mat_reorder not in ("auto", "rcm", "none"):
            raise ValueError(f"unknown mat_reorder {mat_reorder!r}")
        if mat_reorder == "rcm":
            raise NotImplementedError(f"mat_reorder='rcm' {_ITEM_10}")
        self.ksp_type = ksp_type
        self.pc_type = pc_type
        self.rtol = rtol
        self.atol = atol
        self.divtol = divtol
        self.maxiter = maxiter
        self.precision = precision
        self.amg_params = amg_params or AMGParams()
        self.mg_cycle = mg_cycle
        self.reuse_preconditioner = reuse_preconditioner
        self.layout = layout
        self.error_if_not_converged = error_if_not_converged
        self.mat_reorder = mat_reorder
        # resolved eagerly, as KSPSetType validates the name
        self._ksp_solve = _pick_ksp(ksp_type, gmres_restart, richardson_scale, precision)
        self._op = None             # the A of A x = b (the outer operator)
        self._op_lo = None          # its f32 twin under mixed precision (inner solves, PC)
        self._host_a = None         # the host matrix set_operators took, or None
        self._pc_state = None       # hierarchy / inverse diagonal / SSOR apply / None
        self._op_lo_plain = None    # the pre-padding twin (mat_solve's plain hierarchy)
        self._pc_state_plain = None  # mat_solve's plain hierarchy on the padded layout
        self._m = None              # the preconditioner apply, or None
        self._encode = None         # the padded-layout translators
        self._decode = None
        self._last: KSPResult | None = None

    @classmethod
    def from_options(cls, opts) -> "KSP":
        """KSPSetFromOptions: build from a ``config.Options`` (file/CLI)."""
        return cls(
            ksp_type=opts.ksp_type,
            pc_type=opts.pc_type,
            rtol=opts.ksp_rtol,
            atol=opts.ksp_atol,
            divtol=opts.ksp_divtol,
            maxiter=opts.ksp_max_it,
            precision=opts.precision,
            amg_params=opts.amg_params(),
            mg_cycle=opts.pc_mg_cycle_type,
            gmres_restart=opts.ksp_gmres_restart,
            richardson_scale=opts.ksp_richardson_scale,
            layout=opts.layout,
            mat_reorder=opts.mat_reorder,
        )

    @property
    def _gamma(self) -> int:
        return 1 if self.mg_cycle == "v" else 2

    def _drop_pc(self) -> None:
        """Forget the preconditioner and everything derived from it."""
        self._pc_state = None
        self._m = None
        self._pc_state_plain = None
        self._op_lo_plain = None
        self._encode = None
        self._decode = None

    # -- KSPSetOperators ---------------------------------------------------

    def set_operators(self, a: Any, a_lo: Any = None, *, device="cuda", timings: dict | None = None) -> "KSP":
        """KSPSetOperators(ksp, A, A): attach the operator.

        ``a`` may be a ``StarStencil3D`` (the structured route), a
        ``DFDIA`` or ``DIA`` (the general route: under mixed precision a
        ``DFDIA`` with its f32 ``DIA`` as ``a_lo`` or, by default, a ``DIA``
        of its hi bands; under uniform precision a ``DIA`` in the solve's
        dtype), a host matrix (``HostCSR``, or anything scipy makes a CSR
        of), which goes to ``device`` as the DIA family, or any object with
        an ``mv`` method (``pc_type`` jacobi also needs ``diagonal()``, sor
        ``gs_color_masks()``).  ``a_lo``: the low-precision twin for mixed
        precision (default: an f32 cast of ``a``).  ``timings``: a dict that
        receives the seconds of a host matrix's diagonal count
        (``diagonals``), band extraction (``host_bands``) and upload
        (``upload``).  With
        ``reuse_preconditioner`` an existing preconditioner is kept; on the
        padded layout the new twin is padded too when it is a star on the
        same grid, and otherwise the preconditioner is dropped.
        """
        mixed = self.precision == "mixed"
        self._host_a = None
        if isinstance(a, HostCSR) or not hasattr(a, "mv"):
            a, a_lo = self._upload_host(a, device, timings)
        self._op = a
        if a_lo is not None:
            self._op_lo = a_lo
        elif mixed and isinstance(a, DFDIA):
            self._op_lo = DIA(bands=a.hi, offsets=a.offsets, shape=a.shape)
        elif mixed:
            self._op_lo = _cast_floating(a, torch.float32)
        else:
            self._op_lo = a
        if not self.reuse_preconditioner:
            # the whole preconditioner goes, mat_solve's plain twin with it:
            # else it would precondition the new operator with the old one's
            self._drop_pc()
        elif self._encode is not None and self._pc_state is not None:
            # reuse on the PADDED layout: the kept hierarchy works on padded
            # fields, so the swapped-in twin must be padded too (same grid)
            old = getattr(self._op_lo_plain, "grid_shape", None)
            if isinstance(self._op_lo, StarStencil3D) and self._op_lo.grid_shape == old:
                self._op_lo_plain = self._op_lo
                self._op_lo = PaddedStar.from_star(self._op_lo)
            else:
                self._drop_pc()
        return self

    def _upload_host(self, a, device, timings: dict | None):
        """A host matrix as the DIA family on ``device``: (outer operator,
        inner operator).  Keeps the HostCSR for ``pc_type="bjacobi"``."""
        if not isinstance(a, HostCSR):
            import scipy.sparse as sp

            a = HostCSR.from_scipy(sp.csr_matrix(a))
        t0 = time.perf_counter()
        diagonals = distinct_diagonals(a)
        if timings is not None:
            timings["diagonals"] = time.perf_counter() - t0
        if diagonals > 192:  # DIA.host_bands' gate
            raise NotImplementedError(f"a host matrix with {diagonals} diagonals (> 192) {_ITEM_10}")
        self._host_a = a
        return host_dia_operators(a, self.precision, device=device, timings=timings)

    # -- KSPSetUp ----------------------------------------------------------

    def setup(self) -> "KSP":
        """KSPSetUp: build the preconditioner (idempotent; with
        ``reuse_preconditioner`` an existing one is kept)."""
        if self._op is None:
            raise RuntimeError("call set_operators before setup/solve")
        if self._pc_state is not None and self.reuse_preconditioner:
            return self
        self._drop_pc()
        kind = _op_kind(self._op_lo)
        gamma = self._gamma
        if self.pc_type == "gamg":
            if kind == "structured":
                self._setup_structured(gamma)
            elif kind == "general":
                # the router's "auto" rule, as the JAX package's KSP takes it:
                # geometric on a grid, greedy on the host matrix kept, banded
                # without one or past GREEDY_ROW_LIMIT rows
                self._pc_state = gamg_setup_unstructured(
                    self._host_a, self.amg_params, fine_op=self._op_lo,
                    dtype=np.float32 if self.precision == "mixed" else None,
                )
                # the hierarchy's fine level is the inner operator
                self._op_lo = self._pc_state.levels[0].op
                self._m = functools.partial(self._cycle, self._pc_state)
            else:
                raise ValueError(
                    "pc_type='gamg' needs a StarStencil3D, DIA-family or HostCSR/scipy operator — got"
                    f" {type(self._op).__name__}"
                )
        elif self.pc_type == "jacobi":
            op = self._op_lo
            self._pc_state = 1.0 / (op.diagonal_field() if hasattr(op, "diagonal_field") else op.diagonal())
            self._m = functools.partial(torch.mul, self._pc_state)
        elif self.pc_type == "sor":
            # standalone PCSOR in the CG-compatible SSOR form, the driver's
            if not hasattr(self._op_lo, "gs_color_masks"):
                raise ValueError(
                    "pc_type='sor' needs a colorable grid operator (gs_color_masks);"
                    f" {type(self._op_lo).__name__} has none"
                )
            self._pc_state = self._m = _ssor(self._op_lo)
        elif self.pc_type == "bjacobi":
            # from the host matrix set_operators kept: bs = bjacobi_bs, or
            # point Jacobi for bs 0 or 1, in the inner operator's dtype
            self._pc_state = self._m = _standalone_pc(
                "bjacobi", self._op_lo, self._host_a, self.amg_params.bjacobi_bs,
            )
        else:  # none
            self._pc_state = ()
        return self

    def _cycle(self, hier, r: torch.Tensor) -> torch.Tensor:
        return vcycle(hier, r, gamma=self._gamma)

    def _setup_structured(self, gamma: int) -> None:
        """GAMG on a star: the padded fused route or the plain cycle."""
        op_lo = self._op_lo
        self._op_lo_plain = op_lo  # the pre-padding twin (mat_solve)
        plain_only = plain_cycle_only(self.amg_params)
        if self.layout == "padded" and plain_only:
            # the CLI driver's contract: an explicit layout the fused
            # kernels cannot honour is an error, never a substitution
            raise ValueError(
                "layout='padded' is point-Jacobi + jacobi-coarse only; drop bjacobi_bs /"
                " smoother='sor' / coarse_solve='lu' or use layout='plain'/'auto'"
            )
        padded = self.precision == "mixed" and not plain_only and self.layout != "plain"
        if not padded:
            self._pc_state = gamg_setup(op_lo, self.amg_params)
            self._m = functools.partial(self._cycle, self._pc_state)
            return
        self._op_lo = PaddedStar.from_star(op_lo)
        self._encode = pad_field
        self._decode = functools.partial(crop_field, shape=op_lo.grid_shape)
        # bf16 coarse coefficient stacks, vectors in f32 (the driver's)
        self._pc_state = cast_coarse_coefs(gamg_setup(self._op_lo, self.amg_params))
        self._m = functools.partial(self._padded_cycle, self._pc_state)

    def _padded_cycle(self, hier, r: torch.Tensor) -> torch.Tensor:
        """The dot-free padded cycle (``compute_eigenvalues``' PC)."""
        if fused_fine_supported(hier):
            return vcycle_fused(hier, r, self._gamma)
        return vcycle(hier, r, gamma=self._gamma)

    # -- KSPSolve ----------------------------------------------------------

    def _run(self, b: torch.Tensor, rtol: float, atol: float):
        """The solve of A x = b from zero with the gate max(rtol*||b||, atol)."""
        limits = dict(max_outer=min(12, self.maxiter), inner_maxiter=min(200, self.maxiter))
        if self.precision != "mixed":
            return self._ksp_solve(
                self._op.mv, b, rtol=rtol, atol=atol, maxiter=self.maxiter, divtol=self.divtol,
                m_mv=self._m,
            )
        if self._encode is not None:
            # the padded route, as solve_poisson runs it: CG on K2 and the
            # dot-fused cycle (K3/K4), other methods on the dot-free one
            return refined_solve(
                self._op, self._op_lo, self._pc_state, b, rtol=rtol, atol=atol,
                divtol=self.divtol, ksp_solve=self._ksp_solve, gamma=self._gamma, **limits,
            )
        return cg_refined(
            self._op.mv, self._op_lo.mv, b, rtol=rtol, atol=atol, divtol=self.divtol,
            m_lo_mv=self._m, solver=self._ksp_solve, **limits,
        )

    def _check(self, reasons) -> None:
        if self.error_if_not_converged and min(reasons) < 0:
            raise DivergedError(
                f"Diverged reason: {reasons[0]}" if len(reasons) == 1 else f"Diverged reasons: {reasons}"
            )

    def solve(self, b: torch.Tensor, x0: torch.Tensor | None = None) -> KSPResult:
        """KSPSolve: solve A x = b, reusing the preconditioner.

        ``x0``: a nonzero initial guess (``KSPSetInitialGuessNonzero``),
        solved as the defect system A dx = b - A x0 with the gate kept at
        max(rtol*||b||, atol) of the ORIGINAL right-hand side, so a good
        warm start exits at once.  A structured operator takes flat vectors
        too, and answers in kind.
        """
        self.setup()
        gshape = getattr(self._op, "grid_shape", None)
        flat_in = gshape is not None and b.dim() == 1
        if flat_in:
            b = b.reshape(gshape)
            if x0 is not None:
                x0 = x0.reshape(gshape)
        if x0 is None:
            res = self._run(b, self.rtol, self.atol)
            x = res.x
        else:
            bnorm_ref = torch.linalg.vector_norm(b).item()  # the ORIGINAL rhs norm
            res = self._run(b - self._op.mv(x0), 0.0, max(self.rtol * bnorm_ref, self.atol))
            x = res.x + x0
        out = KSPResult(
            x=x.reshape(-1) if flat_in else x,
            iters=int(res.iters),
            resnorm=float(res.resnorm),
            reason=int(res.reason),
            outer_iters=int(getattr(res, "outer_iters", 0)),
        )
        self._last = out
        self._check([out.reason])
        return out

    def mat_solve(self, b_block: torch.Tensor) -> MultiResult:
        """KSPMatSolve parity: solve A X = B for a block of right-hand sides,
        ``b_block`` stacking the columns on axis 0 ((k, n) flat or (k, nz,
        ny, nx) fields), with one batched apply an operator use: the f32
        star's is one ``star7_mv_batched`` launch over the stack, an f32
        DIA's one ``dia_mv_batched`` launch, and the V-cycle's levels take
        the stack whole (``solve/multi.py``).
        Converged columns are frozen while the rest finish.  Returns a
        ``MultiResult`` with per-column iterations, residuals and reasons.

        Runs the plain V-cycle (``ksp_type='cg'`` only): when setup chose the
        padded layout, a plain twin hierarchy is built once from the
        pre-padding operator, as the JAX package does.  The preconditioner
        is GAMG, Jacobi, or none for every other ``pc_type``, as there.
        """
        if self.ksp_type != "cg":
            raise ValueError(f"mat_solve supports ksp_type='cg' (block CG); got {self.ksp_type!r}")
        self.setup()
        gshape = getattr(self._op, "grid_shape", None)
        flat_in = gshape is not None and b_block.dim() == 2
        if flat_in:
            b_block = b_block.reshape((b_block.shape[0], *gshape))
        op_lo, pc_state = self._op_lo, self._pc_state
        if self._encode is not None:
            if self._pc_state_plain is None:
                self._pc_state_plain = gamg_setup(self._op_lo_plain, self.amg_params)
            op_lo, pc_state = self._op_lo_plain, self._pc_state_plain
        if self.pc_type == "gamg":
            m = functools.partial(self._cycle, pc_state)
        elif self.pc_type == "jacobi":
            m = functools.partial(torch.mul, pc_state)
        else:
            m = None
        limits = dict(rtol=self.rtol, atol=self.atol, divtol=self.divtol, batched_ops=True)
        if self.precision == "mixed":
            res = refined_multi(
                self._op.mv, op_lo.mv, b_block, max_outer=min(12, self.maxiter),
                inner_maxiter=min(200, self.maxiter), m_lo_mv=m, **limits,
            )
        else:
            res = cg_multi(self._op.mv, b_block, maxiter=self.maxiter, m_mv=m, **limits)
        if flat_in:
            res = dataclasses.replace(res, x=res.x.reshape((res.x.shape[0], -1)))
        self._check(res.reason.tolist())
        return res

    def compute_eigenvalues(
        self, b: torch.Tensor | None = None, rtol: float = 1e-12, maxiter: int = 300,
    ) -> np.ndarray:
        """KSPComputeEigenvalues parity: Ritz values of the preconditioned
        operator M A, ascending, from a CG run's own Lanczos scalars
        (``solve/spectrum.py``), on the PC's home operator (the f32 twin
        under mixed precision, with the preconditioner of the solves).
        ``b`` seeds the Krylov space (default: the non-smooth ramp
        sin(0.7 i + 0.3)); more iterations, more converged Ritz values."""
        self.setup()
        op = self._op_lo
        gshape = getattr(self._op, "grid_shape", None)
        if b is None:
            n = int(np.prod(gshape)) if gshape is not None else self._op.shape[0]
            dev = _device_of(self._op_lo)
            b = torch.sin(torch.arange(n, dtype=torch.float64, device=dev) * 0.7 + 0.3)
        if gshape is not None and b.dim() == 1:
            b = b.reshape(gshape)
        b = b.to(op.dtype)
        if self._encode is not None:
            b = self._encode(b)
        res, (al, be) = cg(op.mv, b, rtol=rtol, maxiter=maxiter, m_mv=self._m, spectrum=True)
        return ritz_values(al, be, res.iters)

    # -- Get* accessors (main_ksp.cpp:114-117) ------------------------------

    @property
    def iterations(self) -> int:
        """KSPGetIterationNumber (of the most recent solve)."""
        self._require_solved()
        return self._last.iters

    @property
    def residual_norm(self) -> float:
        """KSPGetResidualNorm (of the most recent solve)."""
        self._require_solved()
        return self._last.resnorm

    @property
    def converged_reason(self) -> int:
        """KSPGetConvergedReason (of the most recent solve)."""
        self._require_solved()
        return self._last.reason

    def _require_solved(self):
        if self._last is None:
            raise RuntimeError("no solve has run yet")


def _device_of(op) -> torch.device:
    """The device of an operator's first tensor field."""
    for name in getattr(op, "__dataclass_fields__", {}):
        v = getattr(op, name)
        if isinstance(v, torch.Tensor):
            return v.device
    raise ValueError(f"{type(op).__name__} holds no tensor: pass b")
