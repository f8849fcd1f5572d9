"""The benchmark of ``tpusparse_torch`` on NVIDIA GPUs.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` once and prints one JSON line last.
Everything that belongs to one configuration, traffic mix, metric or
kernel sits in a file of its own that the harness finds by name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``metrics/<metric>.py``,
``kernel_models/<kernel>.json`` and ``problems/<family>.py``, a
configuration's ``build`` and plain reference (``problems/__init__.py``).
``reference/`` holds the plain references that decide ``correct``.
Nothing here imports JAX or the JAX package ``tpusparse``.
"""
