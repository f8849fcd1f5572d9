"""Plot generation — port of ``tpusparse/bench/plots.py``, parity with the
reference's ``scripts/generate_plots.py``.

The reference regex-scrapes PBS logs and emits two figure families: log-log
strong-scaling time-vs-cores lines (``generate_plots.py:104-145``) and
speedup bar charts (``:148-203``).  Here the inputs are the JSON records of
``bench/scaling.py`` — the port's (``runs/torch_scaling_*.json``) or the
JAX package's (``runs/scaling_*.json``), which share one format — and the
same two figures are produced.  matplotlib is imported only to draw.

    python -m tpusparse_torch.bench.plots runs/torch_scaling_strong.json [more.json ...] \
        --out results/torch/

The default ``--out``, ``results/torch/``, keeps the JAX package's figures
in ``results/`` as they are.
"""

from __future__ import annotations

import argparse
import json
import pathlib


def load(path: str | pathlib.Path) -> dict:
    return json.loads(pathlib.Path(path).read_text())


def _watermark_emulated(ax, records: list[dict]) -> None:
    """Watermark figures fed by emulated records (every shard on one
    device, or the JAX package's host-emulated mesh): their wall times
    validate code paths, not hardware scaling."""
    if any(
        rec.get("emulated", rec.get("backend") == "cpu") for rec in records
    ):
        ax.text(
            0.5, 0.5, "EMULATED MESH\n(code-path validation,\nnot hardware scaling)",
            transform=ax.transAxes, fontsize=18, color="red", alpha=0.25,
            ha="center", va="center", rotation=20, zorder=0,
        )


def plot_scaling(records: list[dict], out: pathlib.Path) -> pathlib.Path:
    """Log-log solve-time vs device count, one line per record (plus the
    ideal-scaling guide line the reference draws)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    for rec in records:
        pts = rec["points"]
        xs = [p["n_devices"] for p in pts]
        ys = [p["t_solve"] for p in pts]
        label = f"{rec.get('label', rec['mode'])} ({rec['backend']})"
        ax.loglog(xs, ys, "o-", label=label)
        if rec["mode"] == "strong" and len(xs) > 1:
            ideal = [ys[0] * xs[0] / x for x in xs]
            ax.loglog(xs, ideal, "k--", alpha=0.4, label="ideal")
    ax.set_xlabel("devices")
    ax.set_ylabel("solve time [s]")
    ax.set_title("Strong scaling — solve wall time")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    _watermark_emulated(ax, records)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def plot_efficiency(records: list[dict], out: pathlib.Path) -> pathlib.Path:
    """Bar chart of scaling efficiency per device count — the analogue of the
    reference's speedup bars (its baseline was the CPU build; ours is the
    smallest device count in each sweep)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    width = 0.8 / max(len(records), 1)
    for i, rec in enumerate(records):
        eff = rec["efficiency"]
        xs = list(range(len(eff)))
        ax.bar(
            [x + i * width for x in xs],
            [100 * v for v in eff.values()],
            width=width,
            label=f"{rec.get('label', rec['mode'])} ({rec['backend']})",
        )
        ax.set_xticks([x + 0.4 for x in xs])
        ax.set_xticklabels(list(eff.keys()))
    ax.axhline(100, color="k", ls="--", alpha=0.4)
    ax.axhline(70, color="r", ls=":", alpha=0.5, label="70% target")
    ax.set_xlabel("devices")
    ax.set_ylabel("efficiency [%]")
    ax.set_title("Scaling efficiency")
    ax.legend()
    ax.grid(True, axis="y", alpha=0.3)
    _watermark_emulated(ax, records)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("records", nargs="+", help="scaling JSON files")
    ap.add_argument("--out", default="results/torch")
    args = ap.parse_args(argv)

    records = [load(p) for p in args.records]
    for rec, p in zip(records, args.records):
        rec.setdefault("label", pathlib.Path(p).stem)
    out = pathlib.Path(args.out)
    print("wrote", plot_scaling(records, out / "strong_scaling.png"))
    print("wrote", plot_efficiency(records, out / "scaling_efficiency.png"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
