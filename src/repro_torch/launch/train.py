"""Training launcher (a port of the reference's `launch/train.py`), with
its options plus `--device` (default "cuda"; no card raises).

  python -m repro_torch.launch.train --arch qwen2-0.5b --steps 100 \\
      --global-batch 32 --seq 512 [--smoke] [--fail-at 50] \\
      [--ckpt-dir artifacts/ckpt/run1] [--device cpu]

The port trains on one device. The reference's --data-par / --model-par
build a mesh of several devices; one card cannot show data or model
parallelism, so a value above 1 raises `ValueError`. --smoke uses the
reduced config, so a full train / checkpoint / restore cycle runs in
seconds.
"""
import argparse
import time


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
    if args.data_par > 1 or args.model_par > 1:
        raise ValueError(
            f"--data-par {args.data_par} --model-par {args.model_par}: the "
            "port trains on one device; data and model parallelism need a "
            "mesh of several cards")

    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.train import loop as loop_lib
    from repro_torch.train import optimizer as opt_lib

    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    dev = M.resolve_device(args.device)
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
                         seq=args.seq, device=dev)
    dt = time.time() - t0
    losses = [h["loss"] for h in out["history"]]
    line = (f"done in {dt:.1f}s: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
            f"stragglers={out['stragglers']}")
    print(line)
    return {"line": line, "losses": losses, "stragglers": out["stragglers"],
            "seconds": dt}


if __name__ == "__main__":
    main()
