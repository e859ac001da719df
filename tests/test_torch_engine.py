"""The port's generation engine (`repro_torch.serve.engine`) and serve
launcher (`repro_torch.launch.serve`) on the CPU, against the
reference's engine on the same weights (`convert.model_from_reference`).

Tolerances, and why:
  * per-step logits, reference vs port: rtol 0.03, atol 0.03, as in
    tests/test_torch_models.py (XLA's fused layer scan rounds bf16
    intermediates at other places; 1-2 bf16 ulps were seen).
  * greedy tokens: equal wherever the reference's top-2 logit margin
    exceeds twice the row's largest |port - reference| logit difference
    (then no rounding difference can flip the argmax; closer calls are
    not held).
  * the port's prefill + decode against its own forward: rtol 0.1, atol
    0.15, the reference's tolerance for the same identity.
Sampling draws from `torch.Generator`s, not `jax.random` keys: the
tokens of a temperature decode are not the reference's (a deliberate
divergence), so only the sampling contract is held.
"""
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import model as ref_model
from repro.models.layers import split_params
from repro.serve.engine import Engine as RefEngine
from repro_torch import configs, convert
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as M
from repro_torch.serve.engine import Engine

MODEL_TOL = dict(rtol=0.03, atol=0.03)
SELF_TOL = dict(rtol=0.1, atol=0.15)
ARCH = "qwen2-0.5b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's operations at these sizes run faster on one thread, and
    the suite runs several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _pair():
    rcfg = ref_configs.get(ARCH).reduced()
    values, _ = split_params(ref_model.init_params(rcfg, jax.random.PRNGKey(0)))
    cfg = configs.get(ARCH).reduced()
    return rcfg, values, cfg, convert.model_from_reference(cfg, values, device="cpu")


def _prompt(cfg, B=2, S=12, seed=11):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)


def test_engine_greedy_matches_reference_teacher_forced():
    """The reference engine decodes 8 greedy tokens; the port decodes the
    same prompt teacher-forced on the reference's tokens: its per-step
    logits match, and its argmax is the reference's token wherever the
    reference's top-2 margin is clear. The port's own greedy engine gives
    the reference's tokens up to the first close call."""
    rcfg, values, cfg, model = _pair()
    prompt = _prompt(cfg)
    n_new, cache_len = 8, 24
    ref_tokens, ref_logits = RefEngine(rcfg, values, cache_len).generate(
        jnp.asarray(prompt), n_new, capture_hidden=True)

    logits, cache = M.prefill(model, torch.from_numpy(prompt), cache_len)
    last = logits[:, -1]
    oks = []
    for i in range(n_new):
        want = ref_logits[i]
        got = last.float().numpy()
        np.testing.assert_allclose(got, want, **MODEL_TOL)
        top2 = np.sort(want, axis=-1)[:, -2:]
        ok = top2[:, 1] - top2[:, 0] > 2 * np.abs(got - want).max(-1)
        np.testing.assert_array_equal(got.argmax(-1)[ok], ref_tokens[ok, i])
        oks.append(ok)
        tok = torch.from_numpy(ref_tokens[:, i:i + 1].astype(np.int32))
        logits, cache = M.decode_step(model, cache, tok, prompt.shape[1] + i)
        last = logits[:, -1]
    oks = np.stack(oks, axis=1)  # (B, n_new)
    assert oks.sum() >= n_new  # most of the 2 x 8 steps are clear calls

    tokens, captured = Engine(cfg, model, cache_len, device="cpu").generate(
        prompt, n_new, capture_hidden=True)
    assert tokens.shape == (2, n_new) and tokens.dtype == np.int32
    assert len(captured) == n_new and captured[0].shape == (2, cfg.vocab)
    np.testing.assert_allclose(captured[0], ref_logits[0], **MODEL_TOL)
    for b in range(len(prompt)):  # each row up to its first close call
        first = n_new if oks[b].all() else int(np.argmin(oks[b]))
        np.testing.assert_array_equal(tokens[b, :first], ref_tokens[b, :first])


def test_engine_prefill_decode_equals_forward():
    """Greedy generation's per-step logits == the forward over the prompt
    and the generated tokens, at the reference's tolerance."""
    _, _, cfg, model = _pair()
    prompt = _prompt(cfg, seed=12)
    n_new = 5
    tokens, captured = Engine(cfg, model, 32, device="cpu").generate(
        prompt, n_new, capture_hidden=True)
    seq = np.concatenate([prompt, tokens], axis=1)
    full, _ = M.forward(model, torch.from_numpy(seq))
    S = prompt.shape[1]
    for i in range(n_new):
        np.testing.assert_allclose(captured[i], full[:, S - 1 + i].float().numpy(),
                                   **SELF_TOL)
    np.testing.assert_array_equal(tokens[:, 0], captured[0].argmax(-1))


def test_sampling_pins():
    """Fresh per-request generators differ; generators seeded alike
    reproduce the draw; greedy decoding ignores the generator; an engine
    with the same seed replays its requests' streams."""
    _, _, cfg, model = _pair()
    prompt = _prompt(cfg, B=3, seed=13)
    eng = Engine(cfg, model, 24, seed=5, device="cpu")
    s1, _ = eng.generate(prompt, 6, temperature=1.0)
    s2, _ = eng.generate(prompt, 6, temperature=1.0)
    assert not np.array_equal(s1, s2)
    p1, _ = eng.generate(prompt, 6, temperature=1.0,
                         generator=torch.Generator().manual_seed(7))
    p2, _ = eng.generate(prompt, 6, temperature=1.0,
                         generator=torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(p1, p2)
    g1, _ = eng.generate(prompt, 6)
    g2, _ = eng.generate(prompt, 6, generator=torch.Generator().manual_seed(9))
    np.testing.assert_array_equal(g1, g2)
    again = Engine(cfg, model, 24, seed=5, device="cpu")
    r1, _ = again.generate(prompt, 6, temperature=1.0)
    np.testing.assert_array_equal(r1, s1)
    t = eng.last_timing
    assert t["new_tokens"] == 6 and t["batch"] == 3 and t["decode_s"] > 0


def test_request_generators_are_unique_under_threads():
    """16 threads draw 50 request generators each: the counter loses no
    update and no two requests share a seed."""
    _, _, cfg, model = _pair()
    eng = Engine(cfg, model, 8, device="cpu")
    seeds, lock = [], threading.Lock()

    def work():
        mine = [eng._next_request_generator().initial_seed() for _ in range(50)]
        with lock:
            seeds.extend(mine)

    threads = [threading.Thread(target=work) for _ in range(16)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive()
    assert eng._req_count == 800
    assert len(set(seeds)) == 800


def test_card_entry_points_raise_without_a_card(monkeypatch):
    """No fallback: the model, its cache and the engine default to the
    card and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get(ARCH).reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_cache(cfg, 1, 8)
    _, _, _, model = _pair()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, model, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", ARCH, "--smoke"])


def test_engine_rejects_a_model_on_another_device():
    _, _, cfg, model = _pair()
    with pytest.raises(ValueError, match="lives on"):
        Engine(cfg, model, 8, device="meta")


def test_serve_launcher_smoke_retrieval_on_cpu(capsys):
    out = launch_serve.main(["--arch", ARCH, "--smoke", "--retrieval",
                             "--device", "cpu", "--new-tokens", "6"])
    text = capsys.readouterr().out
    assert "generated (4, 6)" in text and "retrieval:" in text
    assert out["tokens"].shape == (4, 6)
    np.testing.assert_allclose(out["row_sums"], 1.0, atol=1e-9)
    assert out["in_range"] > 0
