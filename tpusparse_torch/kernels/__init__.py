"""Hand-written Hopper kernels and their plain PyTorch twins.

``LAUNCHES`` counts kernel launches per wrapper.  A wrapper adds one where
it launches its CUDA kernel and nowhere else (a CPU tensor runs the twin
and counts nothing), so a run can show that the main path went through
every kernel: reset the counts, drive the path, read them.
"""

LAUNCHES = {
    "star7_mv_padded": 0,
    "star7_mv": 0,
    "star7_mv_batched": 0,
    "fused7_mvdot": 0,
    "fused7_descent_rr": 0,
    "fused7_ascent_rz": 0,
    "fused7_descent": 0,
    "fused7_ascent": 0,
    "fused7_descent_slab": 0,
    "fused7_ascent_slab": 0,
    "fused7_descent1_rr": 0,
    "fused7_ascent1_rz": 0,
    "fused7_descent1": 0,
    "fused7_ascent1": 0,
    "fused7_cgmv": 0,
    "fused7_descentu": 0,
    "fused7_residual": 0,
    "fused7_rich": 0,
    "fused7_cheb0": 0,
    "fused7_cheb": 0,
    "fused7_pre2": 0,
    "fused7_restrict": 0,
    "fused7_prolong": 0,
    "dia_mv": 0,
    "dia_mv_batched": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
