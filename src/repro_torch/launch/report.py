"""Fill EXPERIMENTS.md sections from the port's dry-run records (a port of
the reference's `launch/report.py`, with its markers and target file).

  python -m repro_torch.launch.report     # updates DRYRUN + ROOFLINE

The repository has no EXPERIMENTS.md (neither package writes one), so
`main` raises FileNotFoundError until one with the markers exists. The
port runs on one card: only the single-card records are reported.
"""
from __future__ import annotations

import json
import pathlib
import re

from . import roofline as R

ROOT = pathlib.Path(__file__).resolve().parents[3]


def replace_section(text: str, tag: str, body: str) -> str:
    begin, end = f"<!-- {tag}:BEGIN -->", f"<!-- {tag}:END -->"
    pattern = re.compile(
        re.escape(begin) + r".*?" + re.escape(end), re.DOTALL
    )
    return pattern.sub(lambda _m: begin + "\n" + body + "\n" + end, text)


def main():
    md = (ROOT / "EXPERIMENTS.md").read_text()
    single = R.load("single")
    md = replace_section(md, "DRYRUN", "### One card\n\n" + R.dryrun_table(single))
    roof = (
        "One card (the table of record). `roofline frac` = ideal "
        "useful-compute time (MODEL_FLOPS / the card's bf16 peak) ÷ dominant "
        "term — the fraction of roofline the eager program achieves if "
        "perfectly overlapped.\n\n" + R.roofline_table(single)
    )
    md = replace_section(md, "ROOFLINE", roof)
    base_dir = ROOT / "artifacts" / "dryrun_torch_baseline"
    if base_dir.is_dir():
        md = replace_section(md, "GLOBAL_DELTA", global_delta())
    (ROOT / "EXPERIMENTS.md").write_text(md)
    print("EXPERIMENTS.md updated:", len(single), "single cells")


def global_delta() -> str:
    """Baseline vs optimized dominant-term comparison per cell."""
    base_dir = ROOT / "artifacts" / "dryrun_torch_baseline"
    rows = [
        "| arch | shape | baseline bound | optimized bound | speedup | frac before→after |",
        "|---|---|---|---|---|---|",
    ]
    for f in sorted(base_dir.glob("*__single.json")):
        b = json.loads(f.read_text())
        if b.get("skipped") or b.get("error"):
            continue
        opt_f = R.ART / f.name
        if not opt_f.exists():
            continue
        o = json.loads(opt_f.read_text())
        if o.get("skipped") or o.get("error"):
            continue

        def bound(r):
            return max(r["t_compute_s"], r["t_memory_s"], r["t_collective_s"])

        bb, ob = bound(b), bound(o)
        rows.append(
            f"| {b['arch']} | {b['shape']} | {R.fmt_s(bb)} {b['dominant']} | "
            f"{R.fmt_s(ob)} {o['dominant']} | {bb / ob:.2f}× | "
            f"{R.frac(b):.3f}→{R.frac(o):.3f} |"
        )
    return "\n".join(rows)


if __name__ == "__main__":
    main()
