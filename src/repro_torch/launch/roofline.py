"""Roofline reporting over the port's dry-run records (a port of the
reference's `launch/roofline.py`): artifacts/dryrun_torch/*.json into the
dry-run and roofline tables.

  python -m repro_torch.launch.roofline [--mesh single]

The roofline fraction divides the model's FLOPs by the card's bf16 peak
as the record names it (`bf16_flops_per_s`, from the card's data sheet),
where the reference divides by its TPU's 197 TFLOP/s.
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import List

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(mesh: str = "single") -> List[dict]:
    recs = []
    for f in sorted(ART.glob(f"*__{mesh}.json")):
        recs.append(json.loads(f.read_text()))
    recs.sort(
        key=lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"]))
        if r["shape"] in SHAPE_ORDER
        else (r["arch"], 99)
    )
    return recs


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def dryrun_table(recs: List[dict]) -> str:
    """The reference's dry-run table; "compile" is the port's trace."""
    out = [
        "| arch | shape | compile | bytes/dev (arg+tmp) | FLOPs/dev | "
        "coll. bytes/dev | collectives |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("skipped"):
            out.append(
                f"| {r['arch']} | {r['shape']} | SKIP | — | — | — | "
                f"{r['reason'][:60]} |"
            )
            continue
        if r.get("error"):
            out.append(f"| {r['arch']} | {r['shape']} | ERROR | | | | |")
            continue
        coll = r.get("collective_bytes_per_device", {})
        ctypes = ",".join(
            f"{k}:{v / 1e9:.2f}GB"
            for k, v in sorted(coll.items(), key=lambda kv: -kv[1])[:3]
        )
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compile_s']:.0f}s | "
            f"{(r['argument_size_in_bytes']) / 1e9:.2f}+"
            f"{r['temp_size_in_bytes'] / 1e9:.2f}GB | "
            f"{r['flops_per_device'] / 1e12:.2f}T | "
            f"{r['collective_bytes_per_device_total'] / 1e9:.2f}GB | "
            f"{ctypes} |"
        )
    return "\n".join(out)


def frac(r: dict) -> float:
    """Ideal useful-compute time (the model's FLOPs at the card's bf16
    peak) over the dominant term."""
    bound = max(r["t_compute_s"], r["t_memory_s"], r["t_collective_s"])
    ideal = r["model_flops"] / (r["n_devices"] * r["bf16_flops_per_s"])
    return ideal / bound if bound > 0 else 0.0


def roofline_table(recs: List[dict]) -> str:
    """Per cell: counted FLOPs and HBM bytes, the peak of live bytes and
    whether it fits the card, the roofline terms, the model's FLOPs, the
    useful share of the counted FLOPs, and the roofline fraction."""
    out = [
        "| arch | shape | FLOPs | HBM bytes | peak GB | fits | t_compute | "
        "t_memory | t_collective | dominant | MODEL_FLOPS | useful ratio | "
        "roofline frac |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("skipped") or r.get("error"):
            continue
        t = [r["t_compute_s"], r["t_memory_s"], r["t_collective_s"]]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['flops_per_device']:.3e} | "
            f"{r['hbm_bytes_per_device']:.3e} | {r['peak_bytes'] / 1e9:.2f} | "
            f"{'yes' if r['fits'] else 'no'} | {fmt_s(t[0])} | {fmt_s(t[1])} | "
            f"{fmt_s(t[2])} | **{r['dominant']}** | "
            f"{r['model_flops'] / 1e12:.0f}T | "
            f"{r['useful_flop_ratio']:.2f} | {frac(r):.3f} |"
        )
    return "\n".join(out)


def pick_hillclimb(recs: List[dict]) -> List[dict]:
    """The cell with the worst roofline fraction and the most
    collective-bound one."""
    live = [r for r in recs if not r.get("skipped") and not r.get("error")]
    worst = min(live, key=frac)
    coll = max(live, key=lambda r: r["t_collective_s"] / max(
        r["t_compute_s"], r["t_memory_s"], 1e-12))
    return [worst, coll]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)
    recs = load(args.mesh)
    print("## Dry-run (mesh =", args.mesh, ")\n")
    print(dryrun_table(recs))
    print("\n## Roofline\n")
    print(roofline_table(recs))


if __name__ == "__main__":
    main()
