"""The port's public API is the JAX package's.

For every module of ``tpusparse/`` (but those the port leaves out on
purpose), its public names are read from the source with ``ast``: the
top-level ``def``, ``class`` and UPPER_CASE assignments not starting with
``_``, plus ``__all__`` of a package ``__init__``.  Each must exist in the
counterpart module of ``tpusparse_torch``; each public function's and
class's parameter names must be a subset of the port's; each public method
or property of a class must exist on the port's class.  What the port
deliberately lacks stands in ``ALLOW`` with its reason and, where there is
one, its counterpart, which must exist.

Run alone: ``python -m pytest tests/test_torch_api.py -q`` (a few seconds;
it imports the port's modules, never the JAX package's).
"""

import ast
import importlib
import inspect
import pathlib

import pytest


ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "tpusparse"

# ROADMAP's "Not to port" modules
SKIPPED_MODULES = {
    "bench/ovprobe.py", "sparse/bandell.py", "utils/hlostats.py", "utils/twofloat.py",
}

# operator dunders that are part of a class's public surface
DUNDERS = {"__matmul__", "__call__", "__len__", "__getitem__", "__iter__"}

REASONS = {"not_to_port", "jax_only", "renamed"}

# What the port deliberately lacks: "module:Name", "module:Class.member" or
# "module:func(param)" (module paths of tpusparse/, without .py) ->
# (reason, counterpart "tpusparse_torch.module:attr.path" or None).
#   not_to_port: ROADMAP's "Not to port" list and the TPU backend switches
#                (the port dispatches by tensor device);
#   jax_only:    JAX's sharding and runtime objects;
#   renamed:     the kernel entry points and a moved helper.
_NTP, _JAX, _REN = "not_to_port", "jax_only", "renamed"
ALLOW: dict[str, tuple[str, str | None]] = {
    # the Mosaic slab-depth ladder and the one-jit setups
    "amg/fused_cycle:preflight": (_NTP, None),
    "kernels/fused7:preflight_tz": (_NTP, None),
    "dist/fused_sharded:preflight_sharded": (_NTP, None),
    "amg/geo:gamg_setup_geo_compiled": (_NTP, "tpusparse_torch.amg.geo:gamg_setup_geo"),
    "amg/hierarchy:gamg_setup_compiled": (_NTP, "tpusparse_torch.amg.hierarchy:gamg_setup"),
    # libtpu gather caps and the Pallas DIA
    "amg/unstructured:gamg_setup_unstructured(gather_row_cap)": (_NTP, None),
    "amg/unstructured:lift_pallas_levels": (_NTP, None),
    "sparse/dia:GATHER_ROW_CAP": (_NTP, None),
    "sparse/dia:auto_container(gather_row_cap)": (_NTP, None),
    "sparse/dia:PallasDIA": (_NTP, "tpusparse_torch.sparse.dia:DIA"),
    "sparse/__init__:PallasDIA": (_NTP, "tpusparse_torch.sparse:DIA"),
    "kernels/diaband:LANE": (_NTP, None),
    "kernels/diaband:SUB": (_NTP, None),
    "kernels/diaband:stack_bands": (_NTP, None),
    "kernels/diaband:n_padded": (_NTP, None),
    "kernels/diaband:supported": (_NTP, None),
    # XLA's compiled collectives (utils/hlostats.py)
    "bench/scaling:hlo_validate": (_NTP, None),
    # the TPU's missing f64 and its libtpu workarounds
    "solve/cg:cg_hostloop": (_NTP, "tpusparse_torch.solve.cg:cg"),
    "solve/__init__:cg_hostloop": (_NTP, "tpusparse_torch.solve:cg"),
    "solve/refine:cg_refined_tf": (_NTP, "tpusparse_torch.solve.refine:cg_refined"),
    "solve/__init__:cg_refined_tf": (_NTP, "tpusparse_torch.solve:cg_refined"),
    "sparse/stencil:StarStencilDF": (_NTP, None),
    "sparse/__init__:StarStencilDF": (_NTP, None),
    "sparse/stencil:StarStencil3D.to_df": (_NTP, None),
    # TPU backend switches and the Pallas interpreter
    "kernels/stencil7:is_tpu_backend": (_NTP, None),
    "kernels/__init__:is_tpu_backend": (_NTP, None),
    "kernels/stencil7:star7_supported": (_NTP, None),
    "kernels/__init__:star7_supported": (_NTP, None),
    "kernels/stencil7:star7_mv_padded(interpret)": (_NTP, None),
    "dist/fused_sharded:FusedSharded(interpret)": (_NTP, None),
    "sparse/stencil:StarStencil3D(backend)": (_NTP, None),
    "sparse/padded:PaddedStar(backend)": (_NTP, None),
    # JAX's sharding and runtime objects
    "dist/__init__:field_sharding": (_JAX, None),
    "dist/__init__:replicated": (_JAX, None),
    "dist/mesh:field_sharding": (_JAX, None),
    "dist/mesh:replicated": (_JAX, None),
    "dist/mesh:dataclass_replace_levels": (_JAX, None),
    "dist/mesh:AXES": (_JAX, None),
    "dist/fused_sharded:ZAXIS": (_JAX, None),
    "dist/general:ROW_AXIS": (_JAX, None),
    "dist/multihost:initialize(coordinator_address)": (_JAX, "tpusparse_torch.dist.multihost:initialize"),
    "dist/multihost:initialize(num_processes)": (_JAX, "tpusparse_torch.dist.multihost:initialize"),
    "dist/multihost:initialize(process_id)": (_JAX, "tpusparse_torch.dist.multihost:initialize"),
    # the port calls the stroke methods (descent, ascent) one by one
    "dist/fused_sharded:FusedSharded.call": (_JAX, "tpusparse_torch.dist.fused_sharded:FusedSharded.descent"),
    # a budget of the widened DIA, which belongs to the gather cap
    "sparse/dia:auto_container(dia_budget_bytes)": (_JAX, None),
    # jit timers; the port times with CUDA events
    "bench/bwprobe:timeit": (_JAX, "tpusparse_torch.bench.bwprobe:run"),
    "bench/itprof:timeit": (_JAX, "tpusparse_torch.bench.itprof:time_ms"),
    # the kernel entry points
    "kernels/stencil7:star7_mv_pallas": (_REN, "tpusparse_torch.kernels.stencil7:star7_mv"),
    "kernels/__init__:star7_mv_pallas": (_REN, "tpusparse_torch.kernels.stencil7:star7_mv"),
    # one wrapper a mode (fused7_mvdot, fused7_descent_rr, ...) and its twin
    "kernels/fused7:fused7_call": (_REN, "tpusparse_torch.kernels.fused7:fused7_descent_rr"),
    "kernels/fused7:fused7_xla": (_REN, "tpusparse_torch.kernels.fused7:fused7_descent_rr_torch"),
    "kernels/fused7:MODES": (_REN, "tpusparse_torch.kernels:LAUNCHES"),
    "kernels/diaband:dia_mv_pallas": (_REN, "tpusparse_torch.kernels.diaband:dia_mv"),
    "dist/fused_sharded:make_z_mesh": (_REN, "tpusparse_torch.dist.mesh:make_z_mesh"),
}


def _jax_modules():
    return sorted(
        str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py")
        if str(p.relative_to(JAX_PKG)) not in SKIPPED_MODULES
    )


def _port_module_name(rel: str) -> str:
    """The port's module of ``tpusparse/<rel>`` (``native/__init__.py`` is
    ``native.py`` there)."""
    parts = rel[:-3].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(["tpusparse_torch", *parts])


def _params(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return [n for n in names if n not in ("self", "cls")]


def _is_dataclass(cls: ast.ClassDef) -> bool:
    for d in cls.decorator_list:
        node = d.func if isinstance(d, ast.Call) else d
        name = node.attr if isinstance(node, ast.Attribute) else getattr(node, "id", "")
        if name == "dataclass":
            return True
    return False


def _class_params(cls: ast.ClassDef) -> list[str] | None:
    for node in cls.body:
        if isinstance(node, ast.FunctionDef) and node.name == "__init__":
            return _params(node)
    if _is_dataclass(cls):
        return [
            n.target.id for n in cls.body
            if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)
            and "ClassVar" not in ast.unparse(n.annotation)
        ]
    return None


def _members(cls: ast.ClassDef) -> list[str]:
    return [
        n.name for n in cls.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        and (not n.name.startswith("_") or n.name in DUNDERS)
    ]


def _public(rel: str):
    """(names, {name: params}, {class: members}) of a JAX module."""
    tree = ast.parse((JAX_PKG / rel).read_text())
    names, params, members = [], {}, {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                names.append(node.name)
                params[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            if not node.name.startswith("_"):
                names.append(node.name)
                cp = _class_params(node)
                if cp is not None:
                    params[node.name] = cp
                members[node.name] = _members(node)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    if t.id == "__all__" and rel.endswith("__init__.py"):
                        names.extend(ast.literal_eval(node.value))
                    elif t.id.isupper() and not t.id.startswith("_"):
                        names.append(t.id)
    return list(dict.fromkeys(names)), params, members


def _port_params(obj) -> set[str] | None:
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return None
    return {p.name for p in sig.parameters.values()}


def _resolve(ref: str):
    mod, _, path = ref.partition(":")
    obj = importlib.import_module(mod)
    for part in filter(None, path.split(".")):
        obj = getattr(obj, part)
    return obj


def _gaps(rel: str) -> list[str]:
    """Every public name, member and parameter of ``tpusparse/<rel>`` that
    the port lacks, in ``ALLOW``'s key form."""
    mod_name = _port_module_name(rel)
    key = rel[:-3]
    try:
        port = importlib.import_module(mod_name)
    except ImportError:
        return [f"{key}: module {mod_name} missing"]
    names, params, members = _public(rel)
    out = []
    for name in names:
        if not hasattr(port, name):
            out.append(f"{key}:{name}")
            continue
        obj = getattr(port, name)
        if name in params:
            have = _port_params(obj)
            if have is not None:
                out += [f"{key}:{name}({p})" for p in params[name] if p not in have]
        out += [f"{key}:{name}.{m}" for m in members.get(name, ()) if not hasattr(obj, m)]
    return out


@pytest.mark.parametrize("rel", _jax_modules())
def test_port_has_the_jax_modules_public_names(rel):
    gaps = [g for g in _gaps(rel) if g not in ALLOW]
    assert not gaps, f"missing from the port without an ALLOW entry: {gaps}"


@pytest.mark.parametrize("entry", sorted(ALLOW))
def test_allow_list_entry_is_well_formed(entry):
    reason, counterpart = ALLOW[entry]
    assert reason in REASONS, entry
    if reason == "renamed":
        assert counterpart, f"{entry}: a renamed entry names its counterpart"
    if counterpart is not None:
        _resolve(counterpart)  # raises if the counterpart is missing


def test_allow_list_holds_only_what_the_port_lacks():
    """An entry for a name the port has would let the check pass whatever
    became of that name."""
    lacking = {g for rel in _jax_modules() for g in _gaps(rel)}
    stale = sorted(set(ALLOW) - lacking)
    assert not stale, f"ALLOW entries for names the port has: {stale}"
