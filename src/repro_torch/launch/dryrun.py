"""Dry run of every (arch × shape) cell on one card (a port of the
reference's `launch/dryrun.py`): the work, bytes and memory of a train
step, a prefill or a decode step at the published size, with nothing
allocated, into artifacts/dryrun_torch/*.json.

The reference lowers and compiles each cell on a 256- or 512-chip TPU
mesh, which proves its sharding coherent, and reads the roofline inputs
from the compiled HLO. The port runs the cell's own entry point —
`train/step.make_train_step` with `AdamWConfig()`, `models/model.prefill`
or `decode_step` — on `meta` tensors (`launch/specs`) under the dispatch
counter (`launch/hlo`), and records the same fields: FLOPs, HBM bytes and
collective bytes, the memory sizes, and the roofline terms against the
card's peaks, beside the card's name, power limit and memory, and whether
the cell's peak fits it (the counterpart of the compile that proves a
cell coherent). `compile_s` holds the seconds of the trace: nothing is
compiled. One card has no mesh: `--mesh multi` and `both` raise until
`launch/mesh` is ported.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--arch A] [--shape S] [--skip-existing]
(--all runs one subprocess a cell, optionally only those of --arch /
--shape; the entry point reads the card's properties and needs one.)
"""
import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time
import traceback

import torch

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
_SRC = pathlib.Path(__file__).resolve().parents[2]

# NVLink between the cards of one host, each way (NVIDIA's H100 data
# sheet); no collective runs on one card
LINK_BYTES_PER_S = 450e9


def cell_path(arch: str, shape: str, mesh: str) -> pathlib.Path:
    safe = arch.replace(".", "_")
    return ART / f"{safe}__{shape}__{mesh}.json"


def _check_mesh(mesh_kind: str) -> None:
    if mesh_kind != "single":
        raise ValueError(
            f"--mesh {mesh_kind}: the port runs on one card; a mesh of "
            "several cards waits for launch/mesh, which is not ported yet")


def card_envelope() -> dict:
    """The card this process runs on (device 0): its name and power limit
    as nvidia-smi gives them, its memory, and the peaks of
    `kernels/autotune` (NVIDIA's data sheet). Raises without a card."""
    from ..kernels import autotune

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the dry run reads the card's "
                           "properties; pass an envelope to run_cell instead")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name, power = (x.strip() for x in out.rsplit(",", 1))
    return {
        "card": name,
        "power_limit": power,
        "memory_bytes": int(torch.cuda.get_device_properties(0).total_memory),
        "hbm_bytes_per_s": autotune.HBM_BW,
        "bf16_flops_per_s": autotune.PEAK_FLOPS[torch.bfloat16],
        "f32_flops_per_s": autotune.PEAK_FLOPS[torch.float32],
        "link_bytes_per_s": LINK_BYTES_PER_S,
    }


def _trace(cfg, shape):
    """The cell's call on meta tensors, counted (`hlo.Trace`)."""
    from ..models import model as model_lib
    from ..train import optimizer as opt_lib
    from ..train.step import make_train_step
    from . import hlo, specs

    if shape.kind == "train":
        model = specs.param_specs(cfg, torch.float32).requires_grad_(True)
        opt = specs.opt_specs(model)
        batch = specs.batch_specs(cfg, shape)
        step_fn = make_train_step(cfg, opt_lib.AdamWConfig())
        return hlo.trace(step_fn, model, opt, batch)
    model = specs.param_specs(cfg)
    if shape.kind == "prefill":
        tokens = specs.batch_specs(cfg, shape)["inputs"]
        return hlo.trace(lambda m, x: model_lib.prefill(m, x, cache_len=shape.seq),
                         model, tokens)
    cache = specs.cache_specs(cfg, shape)
    tok, pos = specs.decode_token_specs(cfg, shape)
    return hlo.trace(lambda m, c, x: model_lib.decode_step(m, c, x, pos),
                     model, cache, tok)


def run_cell(arch: str, shape_name, mesh_kind: str = "single", *,
             envelope: dict = None, cfg=None) -> dict:
    """The record of one cell. `shape_name` names one of `configs.shapes.
    SHAPES` or is a `Shape`; `envelope` defaults to the card's
    (`card_envelope`); `cfg` to the arch's published config, with
    REPRO_OVERRIDES applied as the reference applies them."""
    from .. import configs
    from ..configs.shapes import SHAPES, applicable
    from ..models import model as model_lib

    _check_mesh(mesh_kind)
    env = envelope if envelope is not None else card_envelope()
    cfg = cfg if cfg is not None else configs.get(arch)
    # perf-iteration knobs without code edits, e.g.
    #   REPRO_OVERRIDES="attn_chunk=512,remat=none"
    overrides = os.environ.get("REPRO_OVERRIDES", "")
    if overrides:
        kv = {}
        for item in overrides.split(","):
            key, val = item.split("=")
            cur = getattr(cfg, key)
            kv[key] = type(cur)(int(val)) if not isinstance(cur, str) else val
        cfg = dataclasses.replace(cfg, **kv)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    ok, why = applicable(cfg, shape.name) if shape.name in SHAPES else (True, "")
    if not ok:
        return {"arch": arch, "shape": shape.name, "mesh": mesh_kind,
                "skipped": True, "reason": why}

    n_dev = 1
    rec = {
        "arch": arch, "shape": shape.name, "mesh": mesh_kind,
        "n_devices": n_dev, "kind": shape.kind,
        "seq": shape.seq, "batch": shape.batch,
        "overrides": overrides, "remat": cfg.remat,
        **env,
    }
    t0 = time.time()
    tr = _trace(cfg, shape)
    rec["compile_s"] = round(time.time() - t0, 2)

    cost = tr.cost
    rec["ops"] = cost.ops
    rec["flops_per_device"] = cost.flops
    rec["product_flops_per_device"] = cost.product_flops
    rec["hbm_bytes_per_device"] = cost.hbm_bytes
    rec["collective_bytes_per_device"] = dict(cost.collective_bytes)
    rec["collective_bytes_per_device_total"] = cost.collective_total
    rec["total_flops"] = cost.flops * n_dev
    rec["total_bytes"] = cost.hbm_bytes * n_dev
    rec["collective_bytes_total"] = cost.collective_total * n_dev
    rec["argument_size_in_bytes"] = tr.argument_bytes
    rec["output_size_in_bytes"] = tr.output_bytes
    rec["temp_size_in_bytes"] = tr.temp_bytes
    rec["alias_size_in_bytes"] = tr.alias_bytes
    rec["peak_bytes"] = tr.peak_bytes
    rec["fits"] = tr.peak_bytes <= env["memory_bytes"]

    # model flops: 6·N_active·D train; 2·N_active·D inference
    n_active = model_lib.active_param_count(cfg)
    n_total = model_lib.param_count(cfg)
    tokens = shape.batch * (shape.seq if shape.kind in ("train", "prefill") else 1)
    factor = 6 if shape.kind == "train" else 2
    rec["params_total"] = n_total
    rec["params_active"] = n_active
    rec["tokens_per_step"] = tokens
    rec["model_flops"] = float(factor * n_active * tokens)

    # roofline terms on the card: products at the bf16 tensor-core rate,
    # every other counted FLOP at the f32 rate
    rec["t_compute_s"] = (cost.product_flops / env["bf16_flops_per_s"]
                          + (cost.flops - cost.product_flops) / env["f32_flops_per_s"])
    rec["t_memory_s"] = cost.hbm_bytes / env["hbm_bytes_per_s"]
    rec["t_collective_s"] = cost.collective_total / env["link_bytes_per_s"]
    dom = max(
        ("compute", rec["t_compute_s"]),
        ("memory", rec["t_memory_s"]),
        ("collective", rec["t_collective_s"]),
        key=lambda kv: kv[1],
    )
    rec["dominant"] = dom[0]
    rec["useful_flop_ratio"] = rec["model_flops"] / max(rec["total_flops"], 1.0)
    return rec


def summary(rec: dict) -> str:
    """One line of a record."""
    head = f"{rec['arch']} {rec['shape']} {rec['mesh']}"
    if rec.get("skipped"):
        return f"{head}: skipped ({rec['reason']})"
    if rec.get("error"):
        return f"{head}: ERROR"
    return (f"{head}: {rec['ops']} ops in {rec['compile_s']} s, "
            f"{rec['flops_per_device']:.4e} FLOP ({rec['product_flops_per_device']:.4e} "
            f"in products), {rec['hbm_bytes_per_device']:.4e} B, peak "
            f"{rec['peak_bytes'] / 1e9:.3f} GB (fits {rec['memory_bytes'] / 1e9:.1f} GB: "
            f"{rec['fits']}), t_compute {rec['t_compute_s']:.4e} s, t_memory "
            f"{rec['t_memory_s']:.4e} s, {rec['dominant']}; {rec['card']}, "
            f"{rec['power_limit']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--timeout", type=int, default=2400)
    args = ap.parse_args(argv)
    _check_mesh(args.mesh)
    ART.mkdir(parents=True, exist_ok=True)

    if args.all:
        from ..configs import ARCH_IDS
        from ..configs.shapes import SHAPES

        cells = [(a, s, args.mesh) for a in ARCH_IDS for s in SHAPES
                 if args.arch in (None, a) and args.shape in (None, s)]
        failures = 0
        for a, s, m in cells:
            out = cell_path(a, s, m)
            if args.skip_existing and out.exists():
                print(f"[skip] {a} {s} {m}", flush=True)
                continue
            t0 = time.time()
            try:
                proc = subprocess.run(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", a, "--shape", s, "--mesh", m],
                    capture_output=True, text=True, timeout=args.timeout,
                    env={**os.environ, "PYTHONPATH": str(_SRC)},
                )
                rc, err = proc.returncode, proc.stderr
            except subprocess.TimeoutExpired:
                rc, err = -1, f"timed out after {args.timeout} s"
            status = "ok" if rc == 0 else "FAIL"
            if rc != 0:
                failures += 1
                out.write_text(json.dumps({
                    "arch": a, "shape": s, "mesh": m, "error": True,
                    "stderr": err[-4000:],
                }, indent=1))
            print(f"[{status}] {a} {s} {m} ({time.time() - t0:.0f}s)", flush=True)
        print(f"done, failures={failures}")
        sys.exit(1 if failures else 0)

    try:
        rec = run_cell(args.arch, args.shape, args.mesh)
    except Exception:
        rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "error": True, "stderr": traceback.format_exc()[-4000:]}
        cell_path(args.arch, args.shape, args.mesh).write_text(
            json.dumps(rec, indent=1))
        print(json.dumps(rec, indent=1))
        sys.exit(1)
    cell_path(args.arch, args.shape, args.mesh).write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec, indent=1))
    print(summary(rec))


if __name__ == "__main__":
    main()
