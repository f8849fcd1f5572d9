"""Raw HBM bandwidth probes — what is this card's real elementwise ceiling?
Port of ``tpusparse/bench/bwprobe.py``.

    python -m tpusparse_torch.bench.bwprobe [--device cpu] [--sizes-mb 64,143,512]

The JAX package's rows and pass counts: copy-ish ``x + 1`` (2 passes), axpy
(3), triad (4) and reduce (1) at 64, 143 and 512 MB; axpy over the 3-D
fields of the padded solver (``kernels/stencil7.py::padded_shape`` of 300^3,
the port's padded layout) and of the plain one; axpy in bf16 at 512 MB.
Each row is ONE PyTorch call a step (``torch.add(c, x, alpha=)``,
``torch.addcmul``, ``torch.sum``), so it moves exactly its pass count of
bytes; ``reps`` steps are chained and timed as whole chains
(``utils/metrics.py::chain_seconds``: CUDA events on the card).

``main`` prints each row in the JAX package's format, then one summary
line: the best 2-, 3- and 4-pass GB/s, the best of them as the card's
measured copy ceiling, its share of NVIDIA's published 3.35 TB/s (the H100
SXM's HBM3), and the card's name and power limit (``nvidia-smi``).  The
published rate stays the roofline denominator of ``PERF.md``; the ceiling
is printed beside it.  It needs a CUDA device unless given ``--device cpu``
(the tests run it so at a few MB).
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess

import torch

from tpusparse_torch.kernels.stencil7 import padded_shape
from tpusparse_torch.utils.metrics import chain_seconds

HBM_BYTES_S = 3.35e12    # NVIDIA's data sheet: H100 SXM, HBM3
SIZES_MB = (64, 143, 512)
SHAPES = (padded_shape((300, 300, 300)), (300, 300, 300))
BF16_MB = 512


@dataclasses.dataclass
class Probe:
    """One timed row: ``passes`` passes of ``size`` bytes in ``seconds``."""

    name: str
    passes: int
    size: int
    seconds: float

    @property
    def bytes(self) -> int:
        return self.passes * self.size

    @property
    def gb_s(self) -> float:
        return self.bytes / self.seconds / 1e9

    def line(self) -> str:
        return f"{self.name:44s} {self.seconds * 1e3:8.3f} ms   {self.gb_s:7.1f} GB/s"


def _rows(mb: int, dtype, device) -> torch.Tensor:
    """A (rows, 512) field of ``mb`` MiB of ones."""
    item = torch.empty((), dtype=dtype).element_size()
    return torch.ones((mb * 1024 * 1024 // (item * 512), 512), dtype=dtype, device=device)


def run(sizes_mb=SIZES_MB, shapes=SHAPES, bf16_mb=BF16_MB, *, device="cuda", reps: int = 30,
        chains: int = 5) -> list[Probe]:
    """Every row, in the JAX package's order."""
    out = []

    def probe(name, passes, fn, *args):
        a = args[-1]
        sec = chain_seconds(fn, args, reps, chains)
        out.append(Probe(name, passes, a.numel() * a.element_size(), sec))

    def axpy(c, x):
        return torch.add(c, x, alpha=1.5)

    for mb in sizes_mb:
        a = _rows(mb, torch.float32, device)
        probe(f"copy-ish x+1 ({mb} MB, 2-pass)", 2, lambda x: x + 1.0, a)
        probe(f"axpy a+1.5x ({mb} MB, 3-pass)", 3, axpy, a * 2, a)
        probe(f"triad a+b*x ({mb} MB, 4-pass)", 4, torch.addcmul, a * 2, a * 3, a)
        # the chain carries the scalar; each step reads the whole field once
        probe(f"reduce sum ({mb} MB, 1-pass)", 1, lambda x, s: torch.sum(x), a, a)
        del a

    # 3-D layouts like the padded and plain solver fields
    for shape in shapes:
        a = torch.ones(shape, dtype=torch.float32, device=device)
        probe(f"axpy 3-D {tuple(shape)} (3-pass)", 3, axpy, a * 2, a)
        del a

    a16 = _rows(bf16_mb, torch.bfloat16, device)
    probe(f"axpy bf16 ({bf16_mb} MB, 3-pass)", 3, axpy, a16 * 2, a16)
    return out


def ceiling(probes: list[Probe]) -> dict[int, float]:
    """The best GB/s of the 2-, 3- and 4-pass rows, by pass count."""
    best = {}
    for p in probes:
        if p.passes in (2, 3, 4):
            best[p.passes] = max(best.get(p.passes, 0.0), p.gb_s)
    return best


def card(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "-i", str(dev.index or 0), "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return smi.stdout.strip()


def summary(probes: list[Probe], device) -> str:
    """The ceiling line; its share of the published rate on the card only."""
    best = ceiling(probes)
    top = max(best.values())
    share = ""
    if torch.device(device).type == "cuda":
        share = f" = {100 * top * 1e9 / HBM_BYTES_S:.1f}% of the published {HBM_BYTES_S / 1e12:.2f} TB/s"
    return (
        "measured ceiling: " + ", ".join(f"{k}-pass {v:.1f}" for k, v in sorted(best.items()))
        + f" GB/s; best {top:.1f} GB/s{share}; {card(device)}"
    )


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes-mb", default=",".join(map(str, SIZES_MB)),
                    help="the 1-D rows' sizes and, the last, the bf16 row's")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bwprobe on cuda needs a CUDA device (--device cpu runs it on the host)")
    sizes = [int(s) for s in args.sizes_mb.split(",")]
    probes = run(sizes, SHAPES, sizes[-1], device=args.device)
    for p in probes:
        print(p.line())
    print(summary(probes, args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
