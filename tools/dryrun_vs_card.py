#!/usr/bin/env python3
"""Where the dry run's counted memory and the card's allocator part, for
chip_smoke's phase 10 cell (qwen2-0.5b training, 4 x 2,048, remat
"full", AdamW), on one card.

    python3 tools/dryrun_vs_card.py

Runs the step on the card twice to warm up, then once more under
`launch/hlo`'s counter (the tensors are the card's): after every aten op
it reads the counter's live storage bytes and
`torch.cuda.memory_allocated()`, both from their values just before the
step. Prints the peak of each, the dry run's count of the same cell on
meta tensors (`launch/dryrun.run_cell`), the step's
`max_memory_allocated()` unobserved, and the ops around which the two
timelines part most, then the card's name and power limit. Exits
non-zero where there is no card.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("dryrun_vs_card: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import configs
    from repro_torch.configs.shapes import Shape
    from repro_torch.data import tokens as data_lib
    from repro_torch.launch import dryrun, hlo
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step

    dev = torch.device("cuda:0")
    cfg = configs.get(cs.TRAIN_ARCH)
    B, S = cs.TRAIN_BATCH
    model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                          param_dtype=torch.float32).requires_grad_(True)
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(cfg, opt.AdamWConfig())
    data = data_lib.stream(data_lib.DataConfig(vocab=cfg.vocab, seq=S, global_batch=B,
                                               seed=0), device=dev)
    for _ in range(2):
        model, state, met = step(model, state, next(data))
        float(met["loss"])
    del met
    batch = next(data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model, state, met = step(model, state, batch)
    float(met["loss"])
    plain_peak = torch.cuda.max_memory_allocated()
    base = torch.cuda.memory_allocated()
    del met

    timeline = []

    class Sampled(hlo.Counter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            timeline.append((hlo._name(func), self.live,
                             torch.cuda.memory_allocated()))
            return out

    counter = Sampled()
    counter.track((model, state, batch))
    live0 = counter.live
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with counter:
        model, state, met = step(model, state, batch)
    float(met["loss"])
    traced_peak = torch.cuda.max_memory_allocated()
    rec = dryrun.run_cell(cs.TRAIN_ARCH, Shape("train_phase10", "train", S, B), "single")
    gaps = [(i, name, live - live0, alloc - base, (live - live0) - (alloc - base))
            for i, (name, live, alloc) in enumerate(timeline)]
    top_live = max(gaps, key=lambda x: x[2])
    top_alloc = max(gaps, key=lambda x: x[3])
    worst = sorted(gaps, key=lambda x: -abs(x[4]))[:8]
    out = {
        "meta_peak_bytes": rec["peak_bytes"],
        "meta_argument_bytes": rec["argument_size_in_bytes"],
        "card_counter_peak_bytes": counter.peak,
        "card_counter_argument_bytes": live0,
        "card_allocated_at_start": base,
        "card_max_allocated_traced_step": traced_peak,
        "card_max_allocated_plain_step": plain_peak,
        "ops": len(timeline),
        "counter_peak_op": top_live,
        "allocator_peak_op": top_alloc,
        "largest_gaps": worst,
    }
    print(json.dumps(out))
    for i, name, live, alloc, gap in worst:
        lo, hi = max(0, i - 3), min(len(timeline), i + 4)
        print(f"gap {gap:,} B at op {i} ({name}): "
              + ", ".join(f"{timeline[j][0]}" for j in range(lo, hi)))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
