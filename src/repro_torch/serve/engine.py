"""Serving engine: prefill + batched decode with a persistent cache (a
port of the reference's `serve/engine.py`).

The engine drives the model's own functions (`models.model.prefill` /
`decode_step`) eagerly on the model's device: "cuda" unless the caller
asks for the CPU; no card and no "cpu" raises.

Sampling. Each `generate` call without an explicit generator draws from
its own `torch.Generator`, seeded from (engine seed, request counter)
under a lock, so concurrent or consecutive requests sample different
streams while an engine as a whole stays reproducible; pass
`generator=` to pin one request. The draw is the Gumbel-max form of a
categorical sample, as `jax.random.categorical` draws it, but from
PyTorch's generator: the port's samples are not the reference's bits
(a deliberate divergence; greedy decoding is an argmax in both).
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models import model as model_lib
from ..models.config import ModelConfig


class Engine:
    def __init__(self, cfg: ModelConfig, model: model_lib.Model,
                 cache_len: int, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.model = model
        self.cache_len = cache_len
        self.seed = seed
        self.device = model_lib.resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device}, the engine "
                             f"runs on {self.device}")
        self._req_count = 0
        self._key_lock = threading.Lock()
        # host seconds of the last `generate`: prefill (first logits
        # ready) and decode (all tokens ready), and its new tokens
        self.last_timing: dict = {}

    def _next_request_generator(self) -> torch.Generator:
        """A fresh sampling generator for one request (thread-safe
        counter), seeded from (seed, request number)."""
        with self._key_lock:
            self._req_count += 1
            n = self._req_count
        state = np.random.SeedSequence((self.seed, n)).generate_state(2, np.uint32)
        seed = (int(state[0]) << 32 | int(state[1])) & ((1 << 63) - 1)
        return torch.Generator(device=self.device).manual_seed(seed)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def generate(
        self,
        prompt,                      # (B, S) int tokens
        max_new_tokens: int,
        temperature: float = 0.0,
        generator: Optional[torch.Generator] = None,
        capture_hidden: bool = False,
    ) -> Tuple[np.ndarray, List[np.ndarray]]:
        """Greedy/temperature decode. Returns (tokens (B, new) int32, the
        per-step last-position logits as f32 (B, vocab) arrays if
        capture_hidden).

        With `generator=None` (the serving default) each call samples
        from its own derived generator (`_next_request_generator`); a
        caller that passes generators seeded alike gets the same tokens
        every time. Greedy decoding draws nothing."""
        prompt = torch.as_tensor(prompt).to(self.device)
        B, S = prompt.shape[:2]
        t0 = time.perf_counter()
        logits, cache = model_lib.prefill(self.model, prompt, self.cache_len)
        last = logits[:, -1]
        self._sync()
        t1 = time.perf_counter()
        gen = generator if generator is not None else self._next_request_generator()
        out, captured = [], []
        for i in range(max_new_tokens):
            if temperature > 0:
                u = torch.rand(last.shape, generator=gen, device=self.device,
                               dtype=torch.float32)
                gumbel = -torch.log(-torch.log(u))
                tok = torch.argmax(last.float() / temperature + gumbel, dim=-1)
            else:
                tok = torch.argmax(last, dim=-1)
            tok = tok.to(torch.int32)[:, None]
            out.append(tok)
            if capture_hidden:
                captured.append(last.float().cpu().numpy())
            logits, cache = model_lib.decode_step(self.model, cache, tok, S + i)
            last = logits[:, -1]
        tokens = (torch.cat(out, dim=1).cpu().numpy() if out
                  else np.zeros((B, 0), np.int32))
        t2 = time.perf_counter()
        self.last_timing = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                            "new_tokens": max_new_tokens, "batch": B}
        return tokens, captured
