"""The port's MoE FFN (`repro_torch.models.moe`) and MLA mixer (the MLA half
of `repro_torch.models.attention`) against the reference's, on the same
weights and inputs (drawn with numpy from a seed), on the CPU.

Tolerances, and why:
  * the MoE FFN alone, reference vs port, on the same bf16 input: within
    one bf16 ulp (rtol 2^-7, atol 1e-6) for the output, 1e-6 relative for
    the aux loss. Both route in f32, keep the same assignments in the
    same order and sum bf16 products in f32; only the order of the sums
    may differ (the outputs were seen bitwise equal).
  * the MLA mixer alone (forward, prefill and its caches, absorbed
    decode), reference vs port: within one bf16 ulp, for the same reason.
  * the dense twin's prefill + decode against its own forward: rtol 0.05,
    atol 0.06, the reference's tolerance for the same identity
    (tests/test_archs_smoke.py::test_mla_parity_dense_twin); its logits
    against the reference's: rtol 0.03, atol 0.03, as the whole-model
    tolerance of tests/test_torch_models.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import attention as ref_attention
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro.models.layers import split_params
from repro_torch import configs, convert
from repro_torch.models import attention, moe
from repro_torch.models import model as M

BF16_ULP = 2.0 ** -7
ARCH = "deepseek-v2-lite-16b"
TWIN_TOL = dict(rtol=0.05, atol=0.06)
MODEL_TOL = dict(rtol=0.03, atol=0.03)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's operations at these sizes run faster on one thread, and
    the suite runs several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    """The reduced deepseek-v2-lite config of both packages, with `kw`."""
    return (dataclasses.replace(ref_configs.get(ARCH).reduced(), **kw),
            dataclasses.replace(configs.get(ARCH).reduced(), **kw))


def _bf16_pair(a):
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _np(x):
    return np.asarray(x, np.float32)


# ------------------------------------------------------------------ #
# MoE
# ------------------------------------------------------------------ #
# (experts, top_k, shared, capacity factor, B, S, drops expected):
# deepseek's routing (64 experts, top-6, 2 shared) at the published
# capacity factor 1.25 over one group of 63 tokens (C = 8: tokens drop);
# phi3.5-moe's (16 experts, top-2, no shared) at 1.25 over two groups of
# 40 (C = 16: none drop); and 8 experts, top-2, whose router holds three
# equal columns, scaled to be most tokens' best (exact ties, which the
# lower expert index wins: the tied tokens all go to experts 0 and 1), at
# 1.25 over one group of 63 (C = 24: tokens drop).
MOE_CASES = {
    "drops": (64, 6, 2, 1.25, 1, 63, True),
    "no_drops": (16, 2, 0, 1.25, 2, 40, False),
    "ties": (8, 2, 1, 1.25, 1, 63, True),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_matches_reference(case):
    e, k, n_shared, cf, B, S, drops = MOE_CASES[case]
    rcfg, cfg = _cfgs(n_experts=e, top_k=k, n_shared=n_shared,
                      capacity_factor=cf)
    d, fe = cfg.d_model, cfg.d_expert
    rng = np.random.default_rng(len(case))
    f32 = np.float32
    p = {
        "router": (rng.standard_normal((d, e)) / 8).astype(f32),
        "w_gate": (rng.standard_normal((e, d, fe)) / 8).astype(f32),
        "w_up": (rng.standard_normal((e, d, fe)) / 8).astype(f32),
        "w_down": (rng.standard_normal((e, fe, d)) / fe ** 0.5).astype(f32),
    }
    if case == "ties":
        p["router"][:, :3] = 3 * p["router"][:, :1]
    if n_shared:
        f = n_shared * fe
        p["shared"] = {
            "w_gate": (rng.standard_normal((d, f)) / 8).astype(f32),
            "w_up": (rng.standard_normal((d, f)) / 8).astype(f32),
            "w_down": (rng.standard_normal((f, d)) / f ** 0.5).astype(f32),
        }
    x = rng.standard_normal((B, S, d)).astype(f32)
    jx, tx = _bf16_pair(x)
    want, want_aux = jax.jit(lambda v, t: ref_moe.moe(v, t, rcfg))(
        jax.tree.map(jnp.asarray, p), jx)

    layer = moe.MoE(cfg, "cpu")
    convert._load(layer, p)
    with moe.routing_trace(layer) as calls:
        got, aux = layer(tx, cfg)
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    (_, _, flat_e, dropped), = calls
    assert (int(dropped.sum()) > 0) == drops, int(dropped.sum())
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=BF16_ULP, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    if case == "ties":
        # a token whose best expert is the tied triple routes to 0 and 1
        pairs = flat_e.view(-1, k)
        tied = (pairs < 3).all(1)
        assert tied.any() and (pairs[tied] == torch.tensor([0, 1])).all()


def test_moe_groups_and_capacity_match_reference():
    rcfg, cfg = ref_configs.get(ARCH), configs.get(ARCH)
    for tokens in (1, 4, 63, 128, 2048, 2051, 4096):
        assert moe.n_groups(cfg, tokens) == ref_moe.n_groups(rcfg, tokens)
        tg = tokens // moe.n_groups(cfg, tokens)
        assert moe.capacity(cfg, tg) == ref_moe.capacity(rcfg, tg)
    assert moe.n_groups(cfg, 2048) == 32 and moe.capacity(cfg, 64) == 8
    assert moe.n_groups(cfg, 2051) == 1 and moe.capacity(cfg, 2051) == 240


# ------------------------------------------------------------------ #
# MLA
# ------------------------------------------------------------------ #
def _mla_values(cfg, seed):
    rng = np.random.default_rng(seed)
    d, h = cfg.d_model, cfg.n_heads
    lora, qn, qr, vh = cfg.kv_lora, cfg.qk_nope, cfg.qk_rope, cfg.v_head
    shapes = {"w_dkv": (d, lora), "w_uk": (lora, h, qn), "w_uv": (lora, h, vh),
              "w_kr": (d, qr), "w_q": (d, h, qn + qr), "w_o": (h, vh, d)}
    p = {name: (rng.standard_normal(s) / (s[1] if name == "w_o" else s[0]) ** 0.5
                ).astype(np.float32) for name, s in shapes.items()}
    p["norm_kv"] = (1 + 0.1 * rng.standard_normal(lora)).astype(np.float32)
    return p


def test_mla_matches_reference():
    """forward (S = 40 over chunk 16: three q-chunks), prefill (S = 36,
    cache 40, its c_kv and k_rope caches) and four absorbed decode steps,
    reference vs port on the same weights."""
    rcfg, cfg = ref_configs.get(ARCH).reduced(), configs.get(ARCH).reduced()
    p = _mla_values(cfg, seed=0)
    jp = {name: jnp.asarray(v) for name, v in p.items()}
    layer = attention.MLA(cfg, "cpu")
    convert._load(layer, p)
    assert layer.w_uv.dtype == torch.float32 and layer.w_q.dtype == torch.bfloat16
    B, S, Sp = 2, 40, 36
    x = np.random.default_rng(1).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jx, tx = _bf16_pair(x)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    tol = dict(rtol=BF16_ULP, atol=1e-6)

    ref_mla = jax.jit(lambda v, t, q: ref_attention.mla(v, t, q, rcfg))
    ref_prefill = jax.jit(lambda v, t, q: ref_attention.mla_prefill(v, t, q, rcfg, S))
    ref_decode = jax.jit(lambda v, t, c, q: ref_attention.mla_decode(v, t, c, q, rcfg))
    want = ref_mla(jp, jx, jnp.asarray(pos))
    got = attention.mla(layer, tx, torch.from_numpy(pos), cfg)
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)

    want, ref_cache = ref_prefill(jp, jx[:, :Sp], jnp.asarray(pos[:, :Sp]))
    got, cache = attention.mla_prefill(layer, tx[:, :Sp], torch.from_numpy(pos[:, :Sp]),
                                       cfg, S)
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)
    shapes = attention.mla_cache_shape(cfg, B, S)
    for name, (shape, spec) in ref_attention.mla_cache_shape(rcfg, B, S).items():
        assert shapes[name] == (shape, torch.bfloat16)
        assert tuple(cache[name].shape) == shape
        np.testing.assert_array_equal(cache[name].float().numpy(), _np(ref_cache[name]))
    for i in range(S - Sp):
        t = Sp + i
        want, ref_cache = ref_decode(jp, jx[:, t:t + 1], ref_cache, jnp.int32(t))
        got, cache = attention.mla_decode(layer, tx[:, t:t + 1], cache, t, cfg)
        np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)


def test_mla_parity_dense_twin():
    """The reference's dense twin of deepseek-v2-lite (its MLA mixers, a
    dense FFN in place of the MoE) on the reference's weights: the port's
    prefill + decode against its own forward at the reference's tolerance
    for the twin, and its forward logits against the reference's."""
    kw = dict(n_experts=0, top_k=0, n_shared=0, first_dense=0)
    rcfg, cfg = _cfgs(**kw)
    values, _ = split_params(ref_model.init_params(rcfg, jax.random.PRNGKey(0)))
    model = convert.model_from_reference(cfg, values, device="cpu")
    rng = np.random.default_rng(3)
    B, S, n_new = 2, 16, 3
    x = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + n_new)).astype(np.int32))
    full, aux = M.forward(model, x)
    assert float(aux) == 0.0
    want, _ = jax.jit(lambda v, t: ref_model.forward(v, t, rcfg))(values, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(full.float().numpy(), _np(want), **MODEL_TOL)
    logits, cache = M.prefill(model, x[:, :S], S + n_new)
    np.testing.assert_allclose(logits[:, -1].float().numpy(),
                               full[:, S - 1].float().numpy(), **TWIN_TOL)
    for i in range(n_new):
        logits, cache = M.decode_step(model, cache, x[:, S + i:S + i + 1], S + i)
        np.testing.assert_allclose(logits[:, -1].float().numpy(),
                                   full[:, S + i].float().numpy(), **TWIN_TOL)
