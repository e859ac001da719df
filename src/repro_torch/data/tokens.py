"""Deterministic, sharded synthetic LM token pipeline (a port of the
reference's `data/tokens.py`: the same numpy batches).

Production-shaped data path: an infinite deterministic stream addressed
by (step, shard) — any worker can reproduce any batch, which is what
makes checkpoint/restart and elastic re-scale exact (the pipeline state
is just the step counter). A real deployment swaps `_batch_tokens` for
tokenized shards on disk; the addressing contract stays the same.

The stream is Zipf-distributed token ids with a Markov bigram flavor so
losses behave qualitatively like text (CE decreases smoothly)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    embed_dim: int = 0  # >0: emit embeddings (audio/vlm frontend stub)


def _batch_tokens(cfg: DataConfig, step: int) -> np.ndarray:
    rng = np.random.default_rng((cfg.seed, step))
    z = rng.zipf(cfg.zipf_a, size=(cfg.global_batch, cfg.seq + 1))
    base = (z - 1) % cfg.vocab
    # bigram flavor: every other token correlates with its predecessor
    shifted = np.roll(base, 1, axis=1)
    mix = rng.random((cfg.global_batch, cfg.seq + 1)) < 0.3
    tok = np.where(mix, (shifted * 31 + 7) % cfg.vocab, base)
    return tok.astype(np.int32)


def batch_at(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """The global batch for `step` (inputs + next-token labels)."""
    tok = _batch_tokens(cfg, step)
    out = {"labels": tok[:, 1:]}
    if cfg.embed_dim:
        rng = np.random.default_rng((cfg.seed, step, 1))
        out["inputs"] = rng.standard_normal(
            (cfg.global_batch, cfg.seq, cfg.embed_dim), dtype=np.float32
        ).astype(np.float32)
    else:
        out["inputs"] = tok[:, :-1]
    # labels must align with inputs length
    out["labels"] = np.pad(out["labels"], ((0, 0), (0, 0)))[:, : cfg.seq]
    return out


def stream(
    cfg: DataConfig, start_step: int = 0, device="cuda", shardings=None
) -> Iterator[Dict[str, torch.Tensor]]:
    """Infinite batch iterator starting at `start_step` (restart-exact),
    each batch's tensors on `device`; with `shardings` (the mesh's
    `models.sharding.Rules`) each is a DTensor placed ("batch", None, ...),
    as the reference places its batches, every rank keeping its rows."""
    step = start_step
    while True:
        b = batch_at(cfg, step)
        out = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        if shardings is not None:
            from ..models.sharding import place

            out = {k: place(v, shardings, ("batch",) + (None,) * (v.ndim - 1))
                   for k, v in out.items()}
        yield out
        step += 1
