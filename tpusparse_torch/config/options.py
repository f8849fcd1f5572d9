"""Typed runtime options — the PETSc options database; port of
``tpusparse/config/options.py``.

The reference configures everything through PETSc's flat option database:
an options file ingested via ``-config <file>`` (``src/main_ksp.cpp:74-77``,
format of ``configs/PETSc_SolverOptions_GAMG.info``) plus CLI flags such as
``-da_grid_x 300``.  The option names, defaults, parsing, per-level
``-mg_levels_<N>_ksp_{type,max_it}`` overrides and the degrade-with-warning
policy are the JAX package's, so both packages parse a file into the same
fields.  Later occurrences win (CLI after file), PETSc's insert order.

The port adds ``-device`` (``cuda`` by default; ``cpu`` runs the kernels'
plain twins) and refuses, with ``NotImplementedError`` naming the ROADMAP
item, every value whose route it has not ported yet (``unported``).
"""

from __future__ import annotations

import dataclasses
import re
import shlex
import warnings
from pathlib import Path

from tpusparse_torch.amg.hierarchy import AMGParams
from tpusparse_torch.dist.fused_sharded import sharded_route_refusal


@dataclasses.dataclass
class Options:
    """All knobs the reference exposes, with its defaults."""

    # -da_grid_{x,y,z}; reference default 100 (main_ksp.cpp:33-35)
    da_grid_x: int = 100
    da_grid_y: int = 100
    da_grid_z: int = 100

    # KSP (configs/PETSc_SolverOptions_GAMG.info:1-4)
    ksp_type: str = "cg"
    ksp_rtol: float = 1e-5          # PETSc default; the config file sets 1e-14
    ksp_atol: float = 1e-50
    ksp_divtol: float = 1e5         # ||r|| >= divtol*||b||: DIVERGED_DTOL
    ksp_max_it: int = 10000
    ksp_monitor: bool = False       # per-sweep true residual norms
    ksp_view: bool = False          # KSPView + PCView text
    ksp_converged_reason: bool = False
    ksp_compute_eigenvalues: bool = False  # uniform-precision CG only
    log_view: bool = False          # phase times + flop accounting
    ksp_richardson_scale: float = 1.0  # top-level KSPRICHARDSON damping
    # -ksp_norm_type: parsed and validated, but the CLI does not hand it to
    # solve_poisson's ksp_norm_type (as in the JAX CLI, ROADMAP section 3)
    ksp_norm_type: str = "default"
    ksp_gmres_restart: int = 30

    # -mat_type: "stencil" (structured fast path) or "aij" (general banded)
    mat_type: str = "stencil"

    # PC
    pc_type: str = "gamg"           # gamg | jacobi | sor | bjacobi | none
    pc_gamg_type: str = "agg"
    pc_gamg_agg_nsmooths: int = 1
    pc_gamg_threshold: float = 0.0
    pc_gamg_aggressive_coarsening: int = 1
    pc_gamg_coarse_eq_limit: int = 200
    mg_levels_ksp_type: str = "chebyshev"  # the reference config: richardson
    mg_levels_ksp_max_it: int = 2          # sweeps / chebyshev degree
    mg_levels_pc_type: str = "bjacobi"
    mg_levels_sub_pc_type: str = "jacobi"
    pc_bjacobi_bs: int = 0
    mg_levels_ksp_richardson_scale: float = 1.0
    pc_mg_cycle_type: str = "v"
    mg_coarse_ksp_type: str = "preonly"
    mg_coarse_pc_type: str = "bjacobi"
    mg_coarse_sub_pc_type: str = "jacobi"

    # extensions without a PETSc counterpart (the JAX package's)
    pc_gamg_aggregation: str = "auto"   # aij: auto | geometric | greedy | banded
    mat_structure_detect: int = 1       # aij: prove a star, run the stencil route
    mat_reorder: str = "auto"
    options_left: int = 0
    dtype: str = "float64"
    devices: int = 1
    precision: str = "mixed"
    pc_dtype: str = "f32"
    layout: str = "auto"
    profile: str = ""
    f: str = ""
    mat_view: str = ""
    ksp_view_solution: str = ""
    problem: str = "poisson"
    diffusion_contrast: float = 100.0

    # the port's own: the torch device of the solve
    device: str = "cuda"

    def amg_params(self) -> AMGParams:
        smoother = (
            "sor" if self.mg_levels_pc_type == "sor"
            else self.mg_levels_ksp_type
        )
        return AMGParams(
            nsmooths=self.pc_gamg_agg_nsmooths,
            threshold=self.pc_gamg_threshold,
            coarse_eq_limit=self.pc_gamg_coarse_eq_limit,
            smoother=smoother,
            degree=self.mg_levels_ksp_max_it,
            smooth_damping=self.mg_levels_ksp_richardson_scale,
            bjacobi_bs=self.pc_bjacobi_bs,
            aggressive_coarsening=self.pc_gamg_aggressive_coarsening,
            coarse_solve=(
                "lu" if self.mg_coarse_pc_type == "lu" else "jacobi"
            ),
            level_spec=getattr(self, "_mg_level_overrides", ()),
        )

    def validate(self) -> "Options":
        """Check option values, as the JAX package does.

        A known option carrying a legal-PETSc but unimplemented value
        degrades to the nearest supported value with a warning where the
        substitution keeps the solve's meaning; values that would change
        what is solved (-ksp_type, -precision, -mat_type) raise.  Then
        ``unported`` raises for the values the port has no route for.
        """
        def degrade(field: str, supported: tuple, to: str):
            val = getattr(self, field)
            if val not in supported:
                warnings.warn(
                    f"-{field} {val!r} is not implemented; using {to!r} "
                    f"(supported: {', '.join(supported)}) — PETSc-style "
                    f"degradation, the solution is unchanged",
                    stacklevel=3,
                )
                setattr(self, field, to)

        if self.ksp_type not in KSP_TYPES:
            raise ValueError(
                f"-ksp_type {self.ksp_type} is not implemented (supported:"
                f" {', '.join(KSP_TYPES)}); not substituting because the"
                f" Krylov method changes the algorithm, not just its speed"
            )
        if self.precision not in ("mixed", "tf", "f64", "f32"):
            raise ValueError(f"-precision {self.precision} not supported")
        if self.mat_type not in ("stencil", "aij"):
            raise ValueError(
                f"-mat_type {self.mat_type}: 'stencil' (structured fast"
                f" path) or 'aij' (general assembled CSR, MATAIJ parity)"
            )
        degrade("pc_type", ("gamg", "jacobi", "sor", "bjacobi", "none"), "gamg")
        degrade("mat_reorder", ("auto", "rcm", "none"), "auto")
        degrade(
            "ksp_norm_type",
            ("default", "unpreconditioned", "preconditioned", "none"),
            "default",
        )
        if self.ksp_norm_type not in ("default", "unpreconditioned") and \
                self.ksp_type != "cg":
            raise ValueError(
                f"-ksp_norm_type {self.ksp_norm_type} is wired for"
                f" -ksp_type cg (got {self.ksp_type}); other KSPs keep"
                f" their natural norm"
            )
        degrade("pc_gamg_aggregation",
                ("auto", "geometric", "greedy", "banded"), "auto")
        degrade("pc_gamg_type", ("agg",), "agg")
        degrade("mg_levels_ksp_type", ("richardson", "chebyshev"),
                "chebyshev")
        degrade("mg_levels_pc_type", ("bjacobi", "jacobi", "sor"),
                "jacobi")
        if (
            self.mg_levels_pc_type == "sor"
            and self.mg_levels_ksp_type == "chebyshev"
            and "mg_levels_ksp_type" in getattr(self, "_provided", ())
        ):
            warnings.warn(
                "-mg_levels_ksp_type chebyshev with -mg_levels_pc_type"
                " sor: chebyshev-wrapped SOR is not implemented; using"
                " plain SSOR sweeps (richardson+sor semantics)",
                stacklevel=3,
            )
            self.mg_levels_ksp_type = "richardson"
        degrade("pc_mg_cycle_type", ("v", "w"), "v")
        degrade("mg_coarse_ksp_type", ("preonly",), "preonly")
        degrade("mg_coarse_pc_type", ("bjacobi", "jacobi", "lu"), "jacobi")
        self.unported()
        return self

    def unported(self) -> None:
        """Raise ``NotImplementedError`` for the first value this port has
        no route for, naming the ROADMAP item that brings it, and for
        ``-precision tf``, which is not to port."""
        if self.precision == "tf":
            raise NotImplementedError(
                "-precision tf (the two-float outer) is not to port: it exists"
                " because the TPU lacks f64 (ROADMAP, Not to port)"
            )
        # -devices p runs on the z-sharded route only (p shards on one
        # device); the rest of -devices is the JAX package's GSPMD routes
        sharded = None if self.devices <= 1 else sharded_route_refusal(
            mat_type=self.mat_type, precision=self.precision, pc=self.pc_type, layout=self.layout,
            pc_dtype=self.pc_dtype, params=self.amg_params(),
        )
        refused = (
            (self.problem != "poisson", f"-problem {self.problem}", "queue 11"),
            (sharded is not None, f"-devices {self.devices} with {sharded}", "queue 12"),
            (self.profile, "-profile (the trace)", "queue 13"),
        )
        for cond, what, item in refused:
            if cond:
                raise NotImplementedError(
                    f"{what} is not ported to tpusparse_torch yet (ROADMAP {item})"
                )


KSP_TYPES = (
    "cg", "pipecg", "gmres", "fgmres", "bcgs", "minres", "chebyshev",
    "richardson", "preonly",
)
_FIELDS = {f.name: f for f in dataclasses.fields(Options)}
# parsed but deliberately ignored (degenerate on one process): bjacobi is
# jacobi with one block, sub-KSP preonly(1) is the only shape built
_ACCEPTED_NOOPS = {
    "mg_coarse_ksp_max_it",
    "mg_coarse_sub_ksp_type",
    "mg_coarse_sub_ksp_max_it",
    "mg_levels_sub_ksp_type",
    "mg_levels_sub_ksp_max_it",
    "config",
}


def _is_option(tok: str) -> bool:
    """'-key' is an option; '-3', '-1e-8', '-.5' are (negative) values."""
    return (
        tok.startswith("-")
        and len(tok) > 1
        and not (tok[1].isdigit() or tok[1] == ".")
    )


def _parse_tokens(tokens: list[str]) -> dict:
    """Parse '-key value' pairs; bare '-key' means boolean true (PETSc style)."""
    out: dict[str, str] = {}
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        if not _is_option(tok):
            raise ValueError(f"expected an option starting with '-', got {tok!r}")
        key = tok.lstrip("-")
        if i + 1 < len(tokens) and not _is_option(tokens[i + 1]):
            out[key] = tokens[i + 1]
            i += 2
        else:
            out[key] = "true"
            i += 1
    return out


def parse_options_file(path: str | Path) -> dict:
    """Flat PETSc options file: '-key value' per line, '#' comments
    (PetscOptionsInsertFile, the format of configs/*.info)."""
    tokens: list[str] = []
    for line in Path(path).read_text().splitlines():
        line = line.split("#", 1)[0].strip()
        if line:
            tokens.extend(shlex.split(line))
    return _parse_tokens(tokens)


def _coerce(name: str, raw: str):
    typ = _FIELDS[name].type
    if typ in ("int", int):
        # flag-style booleans on int-typed toggles such as -options_left
        if raw.lower() in ("true", "yes", "on"):
            return 1
        if raw.lower() in ("false", "no", "off"):
            return 0
        return int(raw)
    if typ in ("float", float):
        return float(raw)
    if typ in ("bool", bool):
        if raw.lower() in ("true", "1", "yes", "on"):
            return True
        if raw.lower() in ("false", "0", "no", "off"):
            return False
        raise ValueError(f"-{name}: expected a boolean, got {raw!r}")
    return raw


def help_text() -> str:
    """PETSc ``-help``: every option the database accepts, with its type
    and default (generated from ``Options``)."""
    lines = [
        "tpusparse_torch options database (PETSc names kept where they exist):",
        f"  {'-option':<34}{'type':<8}default",
    ]
    for f in dataclasses.fields(Options):
        t = getattr(f.type, "__name__", None) or str(f.type)
        lines.append(f"  -{f.name:<33}{t:<8}{f.default!r}")
    lines.append(
        "  -config <file>                    str     ''   "
        "(options file, PETSc format; CLI flags override it)"
    )
    return "\n".join(lines)


def load_options(argv: list[str] | None = None) -> Options:
    """Build Options from CLI argv, with a '-config file' read first so
    that CLI flags override it (PETSc insert order)."""
    argv = list(argv or [])
    cli = _parse_tokens(argv)
    merged: dict[str, str] = {}
    if "config" in cli:
        merged.update(parse_options_file(cli["config"]))
    merged.update(cli)

    kwargs = {}
    unused: dict[str, str] = {}
    level_overrides: dict[int, dict] = {}
    for key, raw in merged.items():
        if key in _FIELDS:
            kwargs[key] = _coerce(key, raw)
        elif key in _ACCEPTED_NOOPS:
            continue
        else:
            # -mg_levels_<N>_ksp_type / -mg_levels_<N>_ksp_max_it: PETSc
            # per-level smoother specs
            m = re.fullmatch(r"mg_levels_(\d+)_ksp_(type|max_it)", key)
            if m:
                slot = level_overrides.setdefault(int(m.group(1)), {})
                if m.group(2) == "type":
                    if raw not in ("chebyshev", "richardson", "sor"):
                        raise ValueError(
                            f"-{key} {raw}: per-level smoother must be"
                            f" chebyshev | richardson | sor"
                        )
                    slot["smoother"] = raw
                else:
                    slot["degree"] = int(raw)
                continue
            unused[key] = raw
    if unused:
        # PETSc ignores unused options (and reports them under
        # -options_left); warn so that typos stay visible
        warnings.warn(
            f"ignoring unused options (PETSc semantics): {sorted(unused)}",
            stacklevel=2,
        )
    opts = Options(**kwargs)
    object.__setattr__(opts, "_provided", frozenset(kwargs))
    object.__setattr__(opts, "_unused", dict(unused))
    object.__setattr__(
        opts, "_mg_level_overrides",
        tuple(
            (lv, d.get("smoother", ""), d.get("degree", 0))
            for lv, d in sorted(level_overrides.items())
        ),
    )
    return opts.validate()


def options_left_report(opts) -> str:
    """PetscOptionsLeft: the end-of-run report of options set but never
    used."""
    unused = getattr(opts, "_unused", None) or {}
    if not unused:
        return "There are no unused options."
    lines = [f"There are {len(unused)} unused database options. They are:"]
    for k in sorted(unused):
        v = unused[k]
        lines.append(
            f"Option left: name:-{k}"
            + (f" value: {v}" if v != "true" else " (no value)")
        )
    return "\n".join(lines)
