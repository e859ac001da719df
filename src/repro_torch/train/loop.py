"""Training loop with fault tolerance (a port of the reference's
`train/loop.py`).

  * auto-resume from the latest checkpoint (parameters, moments, step —
    and the data pipeline resumes at the same step, so a restart gives
    the uninterrupted run's numbers bit for bit on the same device);
  * periodic atomic checkpoints (`train.checkpoint`, the reference's
    layout: either package resumes the other's);
  * failure injection (`fail_at_step`) to test the restart path;
  * step-time watchdog: a step slower than `straggler_factor` × the
    median step time is counted as a straggler;
  * NaN/overflow guard: a non-finite loss aborts BEFORE the checkpoint
    is polluted.

The model holds f32 master weights (`models/model.py`), drawn from one
`torch.Generator` seeded with `loop.seed`; the reference draws from
`jax.random.PRNGKey(loop.seed)`, so the two start from other numbers.

With `rules` (`models.sharding.Rules` on a `DeviceMesh`) the loop runs as
one rank of that mesh: every rank draws the same weights and keeps its
shards (`sharding.shard_model`), the moments mirror them, each batch is
placed ("batch", None), the step runs under `axis_rules`, and the
checkpoints hold whole arrays (rank 0 writes) that restore on any mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from .. import convert, obs
from ..data import tokens as data_lib
from ..models import model as model_lib
from ..models import sharding
from ..models.config import ModelConfig
from . import checkpoint as ckpt_lib
from . import optimizer as opt_lib
from .step import make_train_step


class InjectedFailure(RuntimeError):
    pass


def _silent(*_):
    pass


def _scalar(t) -> float:
    """A scalar tensor's value (a DTensor's whole value)."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return float(t)


@contextlib.contextmanager
def _mesh_context(rules):
    """The step on a mesh: the rules in force, and a scalar made inside
    (the schedule's, a constant) taken as replicated."""
    with sharding.axis_rules(rules), implicit_replication():
        yield


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = "artifacts/ckpt"
    keep_last: int = 3
    log_every: int = 10
    fail_at_step: int = -1       # failure injection (once, pre-checkpoint)
    straggler_factor: float = 3.0
    seed: int = 0


def state_trees(cfg: ModelConfig, model, opt_state) -> dict:
    """{"params", "opt"} in the reference's tree layout (the checkpoint's
    parts): the model's parameters and the moments by the reference's
    keys, the step an int32 scalar."""
    return {
        "params": convert.reference_tree(cfg, dict(model.named_parameters())),
        "opt": {"m": convert.reference_tree(cfg, opt_state["m"]),
                "v": convert.reference_tree(cfg, opt_state["v"]),
                "step": opt_state["step"]},
    }


def load_state(cfg: ModelConfig, model, opt_state, trees: dict) -> None:
    """Copy restored `state_trees` into the model and the optimizer state."""
    convert.load_reference_tree(cfg, dict(model.named_parameters()), trees["params"])
    convert.load_reference_tree(cfg, opt_state["m"], trees["opt"]["m"])
    convert.load_reference_tree(cfg, opt_state["v"], trees["opt"]["v"])
    opt_state["step"] = trees["opt"]["step"].to(opt_state["step"].device)


def train(
    cfg: ModelConfig,
    loop: LoopConfig,
    opt_cfg: Optional[opt_lib.AdamWConfig] = None,
    global_batch: int = 8,
    seq: int = 128,
    log_fn: Callable[[str], None] = print,
    device="cuda",
    rules: Optional[sharding.Rules] = None,
) -> Dict[str, Any]:
    """The loop on `device` ("cuda" unless the caller asks for the CPU; no
    card raises), on one device or, with `rules`, as one rank of their
    mesh (rank 0 alone logs). Returns {"model", "params" (its parameters
    by name), "opt", "history", "stragglers"}."""
    dev = model_lib.resolve_device(device)
    if not ckpt_lib._writer():
        log_fn = _silent
    on_mesh = (contextlib.nullcontext if rules is None else
               lambda: _mesh_context(rules))
    opt_cfg = opt_cfg or opt_lib.AdamWConfig(total_steps=loop.steps)
    data_cfg = data_lib.DataConfig(
        vocab=cfg.vocab,
        seq=seq,
        global_batch=global_batch,
        seed=loop.seed,
        embed_dim=cfg.d_model if cfg.frontend == "embeddings" else 0,
    )

    # ---- init or resume -------------------------------------------------- #
    start_step = 0
    gen = torch.Generator(device=dev).manual_seed(loop.seed)
    model = model_lib.init_params(cfg, gen, dev, param_dtype=torch.float32)
    if rules is not None:
        sharding.shard_model(model, rules)
    model.requires_grad_(True)
    opt_state = opt_lib.init(dict(model.named_parameters()))
    last = ckpt_lib.latest(loop.ckpt_dir)
    if last is not None:
        restored = ckpt_lib.restore(last, state_trees(cfg, model, opt_state))
        load_state(cfg, model, opt_state, restored)
        start_step = ckpt_lib.manifest(last)["step"]
        log_fn(f"[resume] step {start_step} from {last}")

    step_fn = make_train_step(cfg, opt_cfg)
    history: List[Dict[str, float]] = []
    step_times: List[float] = []
    stragglers = 0

    data = data_lib.stream(data_cfg, start_step=start_step, device=dev,
                           shardings=rules)
    for step in range(start_step, loop.steps):
        batch = next(data)
        if step == loop.fail_at_step:
            raise InjectedFailure(f"injected node failure at step {step}")
        t0 = time.perf_counter()
        with on_mesh():
            model, opt_state, metrics = step_fn(model, opt_state, batch)
        loss = _scalar(metrics["loss"])  # waits for the step's device work
        dt = time.perf_counter() - t0
        if not np.isfinite(loss):
            raise FloatingPointError(f"non-finite loss at step {step}")
        # structured twin of the log_fn strings, on the obs registry
        if obs.REGISTRY.enabled:
            obs.REGISTRY.counter("train.steps").inc()
            obs.REGISTRY.gauge("train.loss").set(loss)
            obs.REGISTRY.gauge("train.grad_norm").set(
                _scalar(metrics["grad_norm"]))
            obs.REGISTRY.histogram("train.step_seconds", unit="s").observe(dt)
        if len(step_times) >= 5:
            med = float(np.median(step_times[-20:]))
            if dt > loop.straggler_factor * med:
                stragglers += 1
                obs.REGISTRY.counter("train.stragglers").inc()
                log_fn(f"[straggler] step {step}: {dt:.2f}s vs median {med:.2f}s")
        step_times.append(dt)
        history.append({"step": step, "loss": loss, "dt": dt})
        if step % loop.log_every == 0:
            log_fn(f"step {step} loss {loss:.4f} "
                   f"gnorm {_scalar(metrics['grad_norm']):.3f} {dt * 1e3:.0f}ms")
        if (step + 1) % loop.ckpt_every == 0 or step + 1 == loop.steps:
            ckpt_lib.save(
                loop.ckpt_dir,
                step + 1,
                state_trees(cfg, model, opt_state),
                keep_last=loop.keep_last,
                extra={"arch": cfg.name, "seq": seq,
                       "global_batch": global_batch},
            )
    return {
        "model": model,
        "params": dict(model.named_parameters()),
        "opt": opt_state,
        "history": history,
        "stragglers": stragglers,
    }
