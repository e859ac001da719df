"""The port's training loop, checkpoints and launcher
(`repro_torch.train.loop`, `train.checkpoint`, `launch.train`) on the CPU:
failure injection and a bitwise resume, the loss falling, retention, and
checkpoints restored across the two packages both ways.

Cross-package resume: a checkpoint written by one package is resumed by
the other, and both continue 2 steps from it; the parameters are then
held within 1e-4 of each other (atol, plus rtol 1e-3). The two start
from the same numbers; their gradients differ by the bf16 rounding of
their forwards (tests/test_torch_train.py), and a few AdamW steps at lr
≤ 3e-4 move a coordinate by at most ~lr each, so the parameters stay
within a few lr of each other (the largest difference seen was
1.8e-5).
"""
import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.train import checkpoint as ref_ckpt
from repro.train import loop as ref_loop
from repro_torch import configs, convert
from repro_torch.launch import train as launch_train
from repro_torch.train import checkpoint as C
from repro_torch.train import loop as L

QUIET = dict(log_fn=lambda *_: None, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(cfgs=configs):
    """The reference's `_tiny_cfg` (tests/test_fault_tolerance.py)."""
    cfg = cfgs.get("qwen2-0.5b").reduced()
    return dataclasses.replace(cfg, n_layers=2, d_model=32, d_ff=64,
                               vocab=64, n_heads=2, n_kv=1, head_dim=16)


def test_save_restore_roundtrip(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(2, dtype=torch.int32)}, "l": [torch.zeros(2)]}
    p = C.save(tmp_path, 5, {"params": tree})
    assert p.name == "step_00000005"
    out = C.restore(p, {"params": tree})["params"]
    torch.testing.assert_close(out["a"], tree["a"], rtol=0, atol=0)
    assert out["b"]["c"].dtype == torch.int32
    torch.testing.assert_close(out["b"]["c"], tree["b"]["c"], rtol=0, atol=0)
    assert C.manifest(p)["step"] == 5
    # the reference's keystr layout: the reference restores it
    got = ref_ckpt.restore(p, {"params": jax.tree.map(np.asarray, {
        "a": np.zeros((3, 4), np.float32), "b": {"c": np.zeros(2, np.int32)},
        "l": [np.zeros(2, np.float32)]})})["params"]
    np.testing.assert_array_equal(np.asarray(got["a"]), tree["a"].numpy())
    assert not list(tmp_path.glob(".tmp-*"))


def test_retention(tmp_path):
    tree = {"x": torch.zeros(3)}
    for s in range(6):
        C.save(tmp_path, s, {"params": tree}, keep_last=2)
    steps = sorted(d.name for d in tmp_path.glob("step_*"))
    assert steps == ["step_00000004", "step_00000005"]
    assert C.latest(tmp_path).name == "step_00000005"
    assert C.latest(tmp_path / "none") is None


def test_failure_injection_and_bitwise_resume(tmp_path):
    """10 steps with a crash at step 7, then a resume from the step-5
    checkpoint: parameters and moments equal the uninterrupted run's
    bitwise (the reference holds its own to 1e-6)."""
    cfg = _tiny()
    kw = dict(global_batch=4, seq=16, **QUIET)

    def loop(name, fail=-1):
        return L.LoopConfig(steps=10, ckpt_every=5, ckpt_dir=str(tmp_path / name),
                            seed=3, fail_at_step=fail, log_every=100)

    ref = L.train(cfg, loop("ok"), **kw)
    with pytest.raises(L.InjectedFailure):
        L.train(cfg, loop("crash", fail=7), **kw)
    assert C.latest(tmp_path / "crash").name == "step_00000005"
    out = L.train(cfg, loop("crash"), **kw)
    assert [h["step"] for h in out["history"]] == [5, 6, 7, 8, 9]
    assert [h["loss"] for h in out["history"]] == [
        h["loss"] for h in ref["history"][5:]]
    for n, p in ref["params"].items():
        assert torch.equal(out["params"][n], p), n
        assert torch.equal(out["opt"]["m"][n], ref["opt"]["m"][n]), n
        assert torch.equal(out["opt"]["v"][n], ref["opt"]["v"][n]), n
    assert int(out["opt"]["step"]) == int(ref["opt"]["step"]) == 10


def test_loss_decreases(tmp_path):
    loop = L.LoopConfig(steps=30, ckpt_every=100, ckpt_dir=str(tmp_path),
                        log_every=100)
    out = L.train(_tiny(), loop, global_batch=8, seq=16, **QUIET)
    losses = [h["loss"] for h in out["history"]]
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def _close(port_params, ref_values, cfg):
    want = {n: torch.zeros_like(p) for n, p in port_params.items()}
    convert.load_reference_tree(cfg, want, jax.tree.map(np.asarray, ref_values))
    for n, p in port_params.items():
        torch.testing.assert_close(p.detach(), want[n], rtol=1e-3, atol=1e-4,
                                   msg=n)


def test_checkpoints_cross_packages(tmp_path):
    """Each package resumes the other's checkpoint and both continue 2
    steps from it: the port trains to step 2; the reference resumes that
    checkpoint (its restore reads the port's file by its own keys) and
    the port resumes it too, both to step 4; then the port resumes the
    reference's step-4 checkpoint and the reference its own, both to
    step 6."""
    cfg, rcfg = _tiny(), _tiny(ref_configs)
    kw = dict(global_batch=4, seq=16)

    def loop(d, steps):
        return dict(steps=steps, ckpt_every=2, ckpt_dir=str(tmp_path / d),
                    seed=5, log_every=100)

    def port(d, steps):
        return L.train(cfg, L.LoopConfig(**loop(d, steps)), **kw, **QUIET)

    def ref(d, steps):
        return ref_loop.train(rcfg, ref_loop.LoopConfig(**loop(d, steps)), **kw,
                              log_fn=lambda *_: None)

    port("a", 2)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    for a, b, steps in (("a", "b", 4), ("c", "b", 6)):
        if a == "c":  # the port resumes the reference's checkpoint
            shutil.copytree(tmp_path / "b", tmp_path / "c")
        r = ref(b, steps)
        p = port(a, steps)
        assert [h["step"] for h in p["history"]] == [steps - 2, steps - 1]
        assert [h["step"] for h in r["history"]] == [steps - 2, steps - 1]
        np.testing.assert_allclose([h["loss"] for h in p["history"]],
                                   [h["loss"] for h in r["history"]], rtol=1e-3)
        _close(p["params"], r["params"], cfg)
        assert int(r["opt"]["step"]) == int(p["opt"]["step"]) == steps


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    out = launch_train.main(["--arch", "xlstm-125m", "--smoke", "--steps", "3",
                             "--global-batch", "2", "--seq", "32",
                             "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                             "--device", "cpu"])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert out["line"] in capsys.readouterr().out
    assert C.latest(tmp_path).name == "step_00000003"


@pytest.mark.parametrize("flag", ["--data-par", "--model-par"])
def test_launcher_refuses_parallelism(tmp_path, flag, monkeypatch):
    """Data or model parallelism runs as one rank of a group of that many
    ranks: without one (no torchrun) it is refused before anything is
    built, and the message says how to start it."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        launch_train.main(["--arch", "qwen2-0.5b", "--smoke", flag, "2",
                           "--ckpt-dir", str(tmp_path), "--device", "cpu"])


def test_launcher_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "qwen2-0.5b", "--smoke", "--steps", "1",
                           "--ckpt-dir", str(tmp_path)])
