#!/usr/bin/env python3
"""Which collectives the gloo backend carries for CUDA tensors, four
ranks on one card: the reason chip_smoke's phase 12 (b) runs its live
mesh as 1 x 1 through NCCL (`chip_smoke.MESH_BACKEND`).

    python3 tools/gloo_cuda_probe.py

Each check runs in a fresh group of four gloo ranks, with a time limit:
the c10d calls (`all_gather_into_tensor`, `reduce_scatter_tensor`,
`all_reduce`, `all_to_all_single`), the functional collectives that
DTensor issues (`torch.distributed._functional_collectives`), and the
port's reduced qwen2-0.5b loss and gradients on a 2 x 2 mesh. Prints one
line a check ("ok", "FAIL" with the error, or the exit signal), then the
card's name and power limit. Exits non-zero without a card.
"""
from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CHECKS = ("c10d all_gather_into_tensor", "c10d reduce_scatter_tensor",
          "c10d all_reduce", "c10d all_to_all_single", "funcol all_gather",
          "funcol all_reduce", "mesh qwen2-0.5b step")


def _run(rank: int, check: str, port: int) -> None:
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    x = torch.full((8,), float(rank + 1), device=dev)
    kind, name = check.split(" ", 1)
    if kind == "c10d":
        out = {"all_gather_into_tensor": torch.empty(32, device=dev),
               "reduce_scatter_tensor": torch.empty(2, device=dev),
               "all_reduce": x.clone(),
               "all_to_all_single": torch.empty(8, device=dev)}[name]
        if name == "all_reduce":
            dist.all_reduce(out)
        else:
            getattr(dist, name)(out, x)
    elif kind == "funcol":
        import torch.distributed._functional_collectives as funcol

        group = dist.group.WORLD
        out = (funcol.all_gather_tensor(x, 0, group) if name == "all_gather"
               else funcol.all_reduce(x, "sum", group))
        out = out.wait() if hasattr(out, "wait") else out
    else:
        import numpy as np
        from torch.distributed.tensor.experimental import implicit_replication

        sys.path.insert(0, os.path.join(ROOT, "src"))
        from repro_torch import configs
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import model as M
        from repro_torch.models import sharding

        rules = sharding.train_rules(make_host_mesh(2, 2, device_type="cuda"))
        cfg = configs.get(name.split()[0]).reduced()
        model = M.init_params(cfg, 0, device=dev, param_dtype=torch.float32)
        sharding.shard_model(model, rules).requires_grad_(True)
        tok = np.random.default_rng(0).integers(0, cfg.vocab, (4, 32)).astype(np.int32)
        tok = sharding.place(torch.from_numpy(tok).to(dev), rules, ("batch", None))
        with sharding.axis_rules(rules), implicit_replication():
            loss, _ = M.loss_fn(model, {"inputs": tok, "labels": tok})
            torch.autograd.grad(loss, list(model.parameters()))
        out = loss.full_tensor()
    torch.cuda.synchronize()
    if rank == 0:
        print(f"{check}: ok {float(out.float().sum()):.6g}", flush=True)
    dist.destroy_process_group()


def main() -> int:
    import torch

    if len(sys.argv) == 3:  # one check, four ranks
        import torch.multiprocessing as mp

        mp.spawn(_run, args=(sys.argv[1], int(sys.argv[2])), nprocs=4)
        return 0
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    print(sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
    for check in CHECKS:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        proc = subprocess.Popen([sys.executable, __file__, check, str(port)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True, start_new_session=True)
        try:
            out, err = proc.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)  # the ranks with it
            proc.communicate()
            print(f"{check}: FAIL (no answer in 180 s)", flush=True)
            continue
        lines = [ln for ln in out.splitlines() if ln.startswith(check)]
        why = [ln for ln in err.splitlines() if "Error" in ln or "signal" in ln][-1:]
        print(lines[0] if lines else f"{check}: FAIL (exit {proc.returncode}) "
              f"{' '.join(why)[:300]}", flush=True)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(out.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
