"""The options database: the port's ``config/options.py`` against the JAX
package's on the reference's own options file and on CLI flags, and the
values the port refuses."""

import dataclasses
import pathlib
import warnings

import pytest

from tpusparse.config.options import load_options as j_load_options
from tpusparse.config.options import options_left_report as j_options_left_report
from tpusparse_torch.amg.hierarchy import AMGParams
from tpusparse_torch.config import Options, load_options, parse_options_file
from tpusparse_torch.config.options import help_text, options_left_report

REF = str(pathlib.Path(__file__).parent.parent / "configs" / "SolverOptions_GAMG.info")


def _fields(opts) -> dict:
    return {f.name: getattr(opts, f.name) for f in dataclasses.fields(opts)}


def _both(argv):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return j_load_options(argv), load_options(argv)


def test_reference_file_parses_to_the_same_fields():
    want, got = _both(["-config", REF])
    fields = _fields(got)
    assert fields.pop("device") == "cuda"
    assert fields == _fields(want)
    assert dataclasses.asdict(got.amg_params()) == dataclasses.asdict(want.amg_params())
    # what the file selects (configs/SolverOptions_GAMG.info)
    assert (got.ksp_type, got.ksp_rtol, got.ksp_atol, got.ksp_max_it) == ("cg", 1e-14, 1e-12, 10000)
    assert (got.mg_levels_ksp_type, got.mg_levels_ksp_max_it) == ("richardson", 1)
    assert got.mg_coarse_ksp_type == "preonly" and got.pc_gamg_threshold == 0.0


def test_file_tokens_are_the_jax_packages():
    from tpusparse.config.options import parse_options_file as j_parse_options_file

    assert parse_options_file(REF) == j_parse_options_file(REF)


def test_cli_flags_override_the_file():
    argv = ["-da_grid_x", "30", "-config", REF, "-ksp_rtol", "1e-8",
            "-mg_levels_ksp_max_it", "2", "-ksp_monitor", "-device", "cpu"]
    want, got = _both(argv)
    assert (got.da_grid_x, got.ksp_rtol, got.mg_levels_ksp_max_it) == (30, 1e-8, 2)
    assert got.ksp_monitor is True and got.device == "cpu"
    fields = _fields(got)
    fields.pop("device")
    assert fields == _fields(want)


def test_per_level_overrides():
    argv = ["-config", REF, "-mg_levels_0_ksp_type", "chebyshev",
            "-mg_levels_0_ksp_max_it", "2", "-mg_levels_2_ksp_max_it", "3"]
    want, got = _both(argv)
    spec = ((0, "chebyshev", 2), (2, "", 3))
    assert got.amg_params().level_spec == want.amg_params().level_spec == spec
    with pytest.raises(ValueError):
        load_options(["-mg_levels_1_ksp_type", "gmres"])


def test_unknown_options_warn_and_are_left():
    argv = ["-config", REF, "-pc_gamg_sym_graph", "true", "-my_typo", "3", "-options_left"]
    with pytest.warns(UserWarning, match="ignoring unused options"):
        got = load_options(argv)
    want, _ = _both(argv)
    assert options_left_report(got) == j_options_left_report(want) == (
        "There are 2 unused database options. They are:\n"
        "Option left: name:-my_typo value: 3\n"
        "Option left: name:-pc_gamg_sym_graph (no value)"
    )
    assert options_left_report(load_options(["-config", REF])) == "There are no unused options."


def test_known_names_degrade_with_a_warning():
    argv = ["-pc_type", "ilu", "-mg_levels_ksp_type", "gmres"]
    with pytest.warns(UserWarning, match="is not implemented; using"):
        got = load_options(argv)
    want, _ = _both(argv)
    assert (got.pc_type, got.mg_levels_ksp_type) == (want.pc_type, want.mg_levels_ksp_type) == (
        "gamg", "chebyshev"
    )


@pytest.mark.parametrize(
    "argv, err",
    [
        (["-ksp_type", "lsqr"], ValueError),
        (["-precision", "half"], ValueError),
        (["-mat_type", "csr"], ValueError),
        (["-ksp_type", "gmres", "-ksp_norm_type", "preconditioned"], ValueError),
        (["-da_grid_x", "ten"], ValueError),
        (["300"], ValueError),                   # a value without its option
    ],
)
def test_malformed_values_raise_in_both(argv, err):
    with pytest.raises(err):
        j_load_options(argv)
    with pytest.raises(err):
        load_options(argv)


@pytest.mark.parametrize(
    "argv",
    [
        # the item-9.2 values that stood here (-pc_gamg_aggregation greedy
        # and banded, -pc_bjacobi_bs with GAMG on aij) are ported: ACCEPTED
        ["-problem", "diffusion", "-mat_type", "aij"],
        ["-mat_type", "aij", "-devices", "2"],
        ["-problem", "diffusion"],
        ["-devices", "4"],
        ["-precision", "tf"],                    # not to port
        ["-profile", "trace_dir", "-mat_type", "aij"],
        ["-profile", "trace_dir"],
        ["-mat_type", "aij", "-mat_structure_detect", "0", "-devices", "2"],
        ["-problem", "diffusion", "-pc_gamg_aggregation", "greedy"],
    ],
)
def test_unported_values_raise(argv):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_options(["-config", REF, *argv])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert j_load_options(["-config", REF, *argv])  # the JAX package takes them


# the preconditioner, aij and pc_dtype values the port took last: each
# parses to the JAX package's fields
ACCEPTED = [
    ["-pc_type", "sor"],
    ["-pc_type", "jacobi"],
    ["-pc_type", "none"],
    ["-pc_bjacobi_bs", "4"],
    ["-mg_levels_pc_type", "sor"],
    ["-mg_coarse_pc_type", "lu"],
    ["-pc_gamg_threshold", "0.05"],
    ["-pc_mg_cycle_type", "w"],
    ["-mg_levels_ksp_max_it", "3"],
    ["-mat_type", "aij"],                    # -mat_structure_detect 1 by default
    ["-mat_type", "aij", "-precision", "f32"],
    ["-pc_dtype", "bf16", "-layout", "plain"],
    ["-pc_dtype", "bf16", "-precision", "f64"],
    # the file route and uniform precision on the structure-blind aij route
    ["-f", "system.bin", "-ksp_view_solution", "binary:x.bin"],
    ["-mat_view", "binary:out.bin"],
    ["-mat_type", "aij", "-mat_structure_detect", "0", "-precision", "f64"],
    ["-mat_type", "aij", "-mat_structure_detect", "0", "-pc_type", "bjacobi", "-pc_bjacobi_bs", "4"],
    # item 9.2: greedy and banded GAMG, and GAMG's block-Jacobi levels on aij
    ["-f", "system.bin", "-pc_bjacobi_bs", "4"],
    ["-mat_type", "aij", "-pc_gamg_aggregation", "greedy"],
    ["-mat_type", "aij", "-mat_structure_detect", "0", "-pc_gamg_aggregation", "banded"],
    ["-mat_type", "aij", "-mat_structure_detect", "0", "-pc_bjacobi_bs", "4"],
    ["-mat_type", "aij", "-mat_structure_detect", "0", "-pc_gamg_aggregation", "greedy"],
]


@pytest.mark.parametrize("argv", ACCEPTED)
def test_accepted_values_parse_as_in_jax(argv):
    got = load_options(["-config", REF, *argv])
    want = j_load_options(["-config", REF, *argv])
    for f in ("pc_type", "pc_mg_cycle_type", "layout", "mat_type", "mat_structure_detect", "precision",
              "pc_dtype", "f", "mat_view", "ksp_view_solution", "pc_gamg_aggregation"):
        assert getattr(got, f) == getattr(want, f), f
    for f in dataclasses.fields(AMGParams):
        assert getattr(got.amg_params(), f.name) == getattr(want.amg_params(), f.name), f.name


def test_ported_values_parse():
    for argv in (
        ["-mat_type", "aij", "-mat_structure_detect", "0"],
        ["-layout", "padded"],
        ["-layout", "plain"],
        ["-precision", "f64"],
        ["-precision", "f32"],
        ["-pc_dtype", "bf16"],
        ["-ksp_norm_type", "preconditioned"],
        ["-ksp_compute_eigenvalues"],
        *ACCEPTED,
        *(["-ksp_type", k] for k in ("pipecg", "gmres", "fgmres", "bcgs", "minres",
                                     "chebyshev", "richardson", "preonly")),
    ):
        assert isinstance(load_options(["-config", REF, *argv]), Options)


def test_help_lists_every_option():
    text = help_text()
    for f in dataclasses.fields(Options):
        assert f"-{f.name} " in text
    assert "-device" in text and "-config <file>" in text
