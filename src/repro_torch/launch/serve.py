"""Serving launcher: batched generation, optionally retrieval-augmented
with the ball*-tree datastore (the paper's constrained-NN search). A
port of the reference's `launch/serve.py`, with its options and output,
plus `--device` (default "cuda"; no card raises).

  python -m repro_torch.launch.serve --arch qwen2-0.5b --smoke \\
      --batch 4 --prompt-len 32 --new-tokens 16 [--retrieval] [--device cpu]
"""
import argparse
import time

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--retrieval", action="store_true")
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--radius", type=float, default=0.0, help="0 = auto")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Engine

    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if cfg.frontend != "tokens":
        raise SystemExit("serve CLI drives token-frontend archs")

    dev = M.resolve_device(args.device)
    model = M.init_params(cfg, args.seed, dev)
    engine = Engine(
        cfg, model, cache_len=args.prompt_len + args.new_tokens, device=dev
    )
    prompt = torch.randint(
        0, cfg.vocab, (args.batch, args.prompt_len),
        generator=torch.Generator().manual_seed(args.seed + 1),
    )
    t0 = time.time()
    tokens, hidden = engine.generate(
        prompt, args.new_tokens, capture_hidden=args.retrieval
    )
    dt = time.time() - t0
    print(f"generated {tokens.shape} in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s)")
    result = {"tokens": tokens, "seconds": dt, "timing": engine.last_timing}

    if args.retrieval:
        from repro_torch.serve.retrieval import Datastore, knn_interpolate

        # demo datastore: logit-space states from the prompt stream
        rng = np.random.default_rng(0)
        n_store = 2000
        keys = rng.standard_normal((n_store, 16)).astype(np.float32)
        vals = rng.integers(0, cfg.vocab, n_store)
        store = Datastore.from_pairs(keys, vals, leaf_size=32, device=dev)
        q = rng.standard_normal((args.batch, 16)).astype(np.float32)
        r = args.radius or 0.75 * np.sqrt(16)
        nv, nd, ok = store.lookup(q, args.k, r)
        lm = np.full((args.batch, cfg.vocab), 1.0 / cfg.vocab)
        mixed = knn_interpolate(lm, nv, nd, ok)
        print(
            f"retrieval: {ok.sum()} in-range neighbors for {args.batch} "
            f"queries; mixed-dist rows sum to "
            f"{np.round(mixed.sum(1), 3).tolist()}"
        )
        result.update(in_range=int(ok.sum()), row_sums=mixed.sum(1))
    return result


if __name__ == "__main__":
    main()
