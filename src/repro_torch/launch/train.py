"""Training launcher (a port of the reference's `launch/train.py`), with
its options plus `--device` (default "cuda"; no card raises).

  python -m repro_torch.launch.train --arch qwen2-0.5b --steps 100 \\
      --global-batch 32 --seq 512 [--smoke] [--fail-at 50] \\
      [--ckpt-dir artifacts/ckpt/run1] [--device cpu]
  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen2-0.5b --data-par 2 --model-par 2 [--device cpu] ...

With --data-par D --model-par M and D·M > 1 the process is one rank of a
group of D·M ranks that `torchrun` (or any launcher setting RANK,
WORLD_SIZE and MASTER_ADDR) started: NCCL with one rank a card
(LOCAL_RANK) for --device cuda, gloo for --device cpu. The ranks form a
(data, model) `DeviceMesh`, and the same program runs on it under
`train_rules`, its parameters placed by those rules (the reference's
launcher leaves parameter placement to XLA and constrains only
activations). A group of another size, or more NCCL ranks than cards,
raises. --smoke uses the reduced config, so a full train / checkpoint /
restore cycle runs in seconds.
"""
import argparse
import os
import time


def _mesh_rules(data_par: int, model_par: int, device: str):
    """Join the launcher's process group and return the (data, model)
    mesh's `train_rules`; raises where the group cannot be what was asked
    for (nothing switches backend or size by itself)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.sharding import train_rules

    n = data_par * model_par
    world = int(os.environ.get("WORLD_SIZE", "0"))
    if not dist.is_initialized() and world != n:
        raise RuntimeError(
            f"--data-par {data_par} --model-par {model_par} runs as one rank "
            f"of {n}: start it with torchrun --nproc-per-node {n} (this "
            f"process has WORLD_SIZE={world or 'unset'})")
    kind = torch.device(device).type
    if kind == "cuda":
        cards = torch.cuda.device_count()
        if cards < n:
            raise RuntimeError(
                f"NCCL takes one rank a card: {n} ranks need {n} cards, "
                f"this host has {cards}")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        dist.init_process_group("nccl" if kind == "cuda" else "gloo")
    if dist.get_world_size() != n:
        raise RuntimeError(f"the group has {dist.get_world_size()} ranks, "
                           f"the mesh {data_par} x {model_par} needs {n}")
    return train_rules(make_host_mesh(data_par, model_par, device_type=kind))


def main(argv=None) -> dict:
    """Run the launcher; returns what it printed: {"line", "losses",
    "stragglers", "seconds"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt/default")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rules = None
    if args.data_par * args.model_par > 1:
        rules = _mesh_rules(args.data_par, args.model_par, args.device)

    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.train import loop as loop_lib
    from repro_torch.train import optimizer as opt_lib

    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    dev = M.resolve_device(args.device)
    if rules is not None and dev.type == "cuda":
        import torch

        dev = torch.device("cuda", torch.cuda.current_device())
    loop = loop_lib.LoopConfig(
        steps=args.steps,
        ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir,
        fail_at_step=args.fail_at,
        seed=args.seed,
    )
    opt = opt_lib.AdamWConfig(lr=args.lr, total_steps=args.steps)
    t0 = time.time()
    out = loop_lib.train(cfg, loop, opt_cfg=opt, global_batch=args.global_batch,
                         seq=args.seq, device=dev, rules=rules)
    dt = time.time() - t0
    losses = [h["loss"] for h in out["history"]]
    mesh = "" if rules is None else f" on a {args.data_par} x {args.model_par} mesh"
    line = (f"done in {dt:.1f}s{mesh}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
            f"stragglers={out['stragglers']}")
    if rules is None or rules.mesh.get_rank() == 0:
        print(line, flush=True)
    if rules is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return {"line": line, "losses": losses, "stragglers": out["stragglers"],
            "seconds": dt}


if __name__ == "__main__":
    main()
