"""The port's model stack (`repro_torch.models`, `configs`, `data.tokens`)
against the reference's, on the same weights and inputs, on the CPU.

The weights are the reference's own (`init_params` + `split_params`),
carried into the port by `convert.model_from_reference`; inputs are drawn
with numpy from a seed. The reference's functions run jitted (one compile
each), as its serving engine runs them.

Tolerances, and why:
  * primitives and `chunked_causal` on the same bf16 inputs: within one
    bf16 ulp (rtol 2^-7). Both sum bf16 products in f32 and round once;
    only the order of the sums may differ.
  * whole-model logits (forward, prefill, decode), reference vs port:
    rtol 0.03, atol 0.03. XLA fuses the reference's compiled layer scan
    and sums in other orders than its own eager ops (the port's blocks
    equal the reference's eager blocks bitwise); 1-2 bf16 ulps of logits
    up to ~4 were seen at these sizes. The reference is compiled without
    XLA's excess precision (`_jit`), which otherwise keeps some bf16
    intermediates in f32 where its code rounds them (the SwiGLU's
    silu(g) before the product, for one): that moved the reduced
    recurrentgemma's logits by up to 4 bf16 ulps from the reference's
    own eager run, and the port follows the code.
  * the prefill caches: the bf16 attention caches end to end at the
    same tolerance; the f32 recurrent states (RG-LRU, mLSTM, sLSTM) of
    each layer at the same tolerance, from the reference's own input to
    that layer. A recurrent state amplifies a single bf16 ulp of its
    input: one flipped element of xlstm's third layer's output grew to
    0.18 in the seventh layer's mLSTM memory (|C| <= 7.6).
  * the MoE configs' aux loss (forward), reference vs port: rtol 1e-3.
    The router sees hidden states that differ by those 1-2 bf16 ulps, so
    its probabilities differ in the fourth digit (2.4e-4 relative was
    seen); the MoE alone matches to 1e-6 (tests/test_torch_moe.py).
  * the port's prefill + decode against its own forward: rtol 0.1, atol
    0.15, the reference's own tolerance for the same identity
    (tests/test_archs_smoke.py).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data import tokens as ref_tokens
from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro.models import model as ref_model
from repro.models.layers import split_params
from repro_torch import configs, convert
from repro_torch.data import tokens
from repro_torch.models import attention, layers
from repro_torch.models import model as M

PORTED = ["qwen2-0.5b", "qwen2-72b", "granite-20b", "h2o-danube-1.8b",
          "musicgen-medium", "llava-next-34b", "deepseek-v2-lite-16b",
          "phi3.5-moe-42b-a6.6b", "recurrentgemma-9b", "xlstm-125m"]
# reduced configs held against the reference: GQA + bias + tied
# embeddings; ungated GELU MLP, one KV head, untied; a sliding window;
# the embeddings frontend; MLA with a dense first layer and MoE (shared
# experts); GQA with MoE; RG-LRU with local MQA (f32 recurrent caches);
# mLSTM / sLSTM with no FFN and tied embeddings
PARITY = ["qwen2-0.5b", "granite-20b", "h2o-danube-1.8b", "musicgen-medium",
          "deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b", "recurrentgemma-9b",
          "xlstm-125m"]
AUX_RTOL = 1e-3
BF16_ULP = 2.0 ** -7
MODEL_TOL = dict(rtol=0.03, atol=0.03)
SELF_TOL = dict(rtol=0.1, atol=0.15)
NO_EXCESS = {"xla_allow_excess_precision": False}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's operations at these sizes run faster on one thread, and
    the suite runs several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bf16_pair(a):
    """The same bf16 values in both packages."""
    return jnp.asarray(a).astype(jnp.bfloat16), _t(a).to(torch.bfloat16)


# ------------------------------------------------------------------ #
# configs and data
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_configs_match_reference(arch):
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    ref, port = ref_configs.get(arch), configs.get(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(ref.reduced())
    assert port.layer_plan() == ref.layer_plan()
    assert port.scan_groups() == ref.scan_groups()
    assert port.hd == ref.hd


@pytest.mark.parametrize("arch", PORTED)
def test_param_count_matches_reference(arch):
    """Full size, from shapes only (the meta device; nothing allocated):
    the parameter count and the active one (routed experts at top_k /
    n_experts) equal the reference's; a dense config's are the same."""
    cfg, rcfg = configs.get(arch), ref_configs.get(arch)
    assert M.param_count(cfg) == ref_model.param_count(rcfg)
    assert M.active_param_count(cfg) == ref_model.active_param_count(rcfg)
    assert (M.active_param_count(cfg) < M.param_count(cfg)) == bool(cfg.n_experts)


@pytest.mark.parametrize("embed_dim", [0, 8])
def test_token_batches_match_reference(embed_dim):
    cfg = tokens.DataConfig(vocab=97, seq=12, global_batch=3, seed=4,
                            embed_dim=embed_dim)
    ref_cfg = ref_tokens.DataConfig(**dataclasses.asdict(cfg))
    for step in (0, 5):
        got, want = tokens.batch_at(cfg, step), ref_tokens.batch_at(ref_cfg, step)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    it = tokens.stream(cfg, start_step=5, device="cpu")
    b = next(it)
    np.testing.assert_array_equal(b["labels"].numpy(),
                                  ref_tokens.batch_at(ref_cfg, 5)["labels"])
    assert b["inputs"].device.type == "cpu"


# ------------------------------------------------------------------ #
# layers and attention
# ------------------------------------------------------------------ #
def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 19, 64)).astype(np.float32) * 3
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jx, tx = _bf16_pair(x)
    want = ref_layers.rms_norm(jx, jnp.asarray(w), 1e-6)
    got = layers.rms_norm(tx, _t(w), 1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=BF16_ULP, atol=0)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(100, 140, dtype=np.int32), (2, 40))
    jx, tx = _bf16_pair(x)
    np.testing.assert_array_equal(layers.rope_freqs(16, theta).numpy(),
                                  np.asarray(ref_layers.rope_freqs(16, theta)))
    want = ref_layers.apply_rope(jx, jnp.asarray(pos), theta)
    got = layers.apply_rope(tx, _t(pos.copy()), theta)
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=BF16_ULP, atol=1e-6)


def test_matmul_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 19, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 3, 16)) * 0.1).astype(np.float32)
    want = ref_layers.matmul(jnp.asarray(x), jnp.asarray(w), "bsd,dhk->bshk")
    got = layers.matmul(_t(x), _t(w.reshape(64, 48))).view(2, 19, 3, 16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=BF16_ULP, atol=1e-6)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_matches_reference(gated):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 19, 64)).astype(np.float32)
    shapes = {"w_up": (64, 128), "w_down": (128, 64)}
    if gated:
        shapes["w_gate"] = (64, 128)
    p = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
         for k, s in shapes.items()}
    jx, tx = _bf16_pair(x)
    want = ref_layers.mlp({k: jnp.asarray(v) for k, v in p.items()}, jx)
    got = layers.mlp({k: _t(v).to(torch.bfloat16) for k, v in p.items()}, tx)
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=BF16_ULP, atol=1e-6)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    jl, tl = _bf16_pair(logits)
    want_mean, want = ref_layers.cross_entropy(jl, jnp.asarray(labels))
    got_mean, got = layers.cross_entropy(tl, _t(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(float(got_mean), float(want_mean), rtol=1e-6)


@pytest.mark.parametrize("window", [0, 12])
@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("packing", [True, False])
def test_chunked_causal_matches_reference(packing, flash, window):
    """S = 40 over chunk 16: padded to 48, three q-chunks, the multi-chunk
    online softmax; GQA grouping (KV = 2, G = 2)."""
    rng = np.random.default_rng(5)
    B, S, KV, G, hd = 2, 40, 2, 2, 16
    q = rng.standard_normal((B, S, KV, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = map(_bf16_pair, (q, k, v))
    kw = dict(chunk=16, window=window, packing=packing, flash=flash)
    want = ref_attention.chunked_causal(jq, jk, jv, **kw)
    got = attention.chunked_causal(tq, tk, tv, **kw)
    assert got.shape == (B, S, KV, G, hd) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=BF16_ULP, atol=1e-6)


@pytest.mark.parametrize("window", [0, 6])
def test_pack_kv_matches_reference(window):
    rng = np.random.default_rng(6)
    t = rng.standard_normal((2, 11, 2, 4)).astype(np.float32)
    for cache_len in (8, 11, 16):
        want = ref_attention._pack_kv(jnp.asarray(t), cache_len, window)
        got = attention._pack_kv(_t(t), cache_len, window)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------ #
# the model, reference vs port
# ------------------------------------------------------------------ #
def _jit(fn):
    """`fn` jitted and compiled without excess precision, once for each
    set of argument shapes."""
    jitted, compiled = jax.jit(fn), {}

    def call(*args):
        key = tuple((a.shape, a.dtype) for a in jax.tree.leaves(args))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(compiler_options=NO_EXCESS)
        return compiled[key](*args)
    return call


def _states_on_reference_inputs(rcfg, values, cfg, model, x, cache_len):
    """Per layer whose prefill cache is f32 (a recurrent state): (the
    reference's cache, the port's), each layer of both fed the
    reference's own input to that layer."""
    B, S = x.shape[:2]
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    h = ref_model._embed_in(values, jnp.asarray(x), rcfg)
    blocks, out = {}, []
    for kind, v, block in zip(rcfg.layer_plan(), convert._layer_values(rcfg, values["groups"]),
                              model.layers):
        if kind not in blocks:
            blocks[kind] = _jit(lambda v, h, p, kind=kind: ref_model._apply_block(
                v, h, p, rcfg, kind, cache_len=cache_len))
        h_in = _t(_np(h)).to(torch.bfloat16)
        h, _, want = blocks[kind](v, h, pos)
        _, _, got = M._apply_block(block, h_in, M._positions(B, S, "cpu"), cfg,
                                   cache_len=cache_len)
        if any(t.dtype == torch.float32 for t in got.values()):
            out.append((want, got))
    return out


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(ref cfg, ref values, port cfg, port model on the CPU)."""
    rcfg = ref_configs.get(arch).reduced()
    values, _ = split_params(ref_model.init_params(rcfg, jax.random.PRNGKey(0)))
    cfg = configs.get(arch).reduced()
    return rcfg, values, cfg, convert.model_from_reference(cfg, values, device="cpu")


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "embeddings":
        x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        return x.astype(jnp.bfloat16).astype(np.float32)
    return rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", PARITY)
def test_model_matches_reference(arch):
    """forward (S = 19), prefill (S = 16, cache 19, its caches; the f32
    recurrent states layer by layer, see the module docstring) and three
    decode steps, reference vs port on the same weights."""
    rcfg, values, cfg, model = _pair(arch)
    B, S, n_new = 2, 16, 3
    x = _inputs(cfg, B, S + n_new, seed=3)
    fwd = _jit(lambda v, t: ref_model.forward(v, t, rcfg))
    pre = _jit(lambda v, t: ref_model.prefill(v, t, rcfg, S + n_new))
    dec = _jit(lambda v, c, t, p: ref_model.decode_step(v, c, t, p, rcfg))

    want, want_aux = fwd(values, jnp.asarray(x))
    got, aux = M.forward(model, _t(x))
    assert got.shape == (B, S + n_new, cfg.vocab) and aux.dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(), _np(want), **MODEL_TOL)
    if cfg.n_experts:
        assert float(aux) > 0
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=AUX_RTOL)
    else:
        assert float(aux) == float(want_aux) == 0.0

    want, ref_cache = pre(values, jnp.asarray(x[:, :S]))
    got, cache = M.prefill(model, _t(x[:, :S]), S + n_new)
    np.testing.assert_allclose(got.float().numpy(), _np(want), **MODEL_TOL)
    ref_layers_cache = convert._layer_values(rcfg, ref_cache)
    assert len(ref_layers_cache) == len(cache)
    for rc, c in zip(ref_layers_cache, cache):
        assert c.keys() == rc.keys()
        for name in c:
            assert c[name].shape == rc[name].shape
            if c[name].dtype == torch.bfloat16:
                np.testing.assert_allclose(c[name].float().numpy(), _np(rc[name]),
                                           **MODEL_TOL)
    states = _states_on_reference_inputs(rcfg, values, cfg, model, x[:, :S], S + n_new)
    assert len(states) == sum(any(t.dtype == torch.float32 for t in c.values())
                              for c in cache)
    for rc, c in states:
        for name in c:
            np.testing.assert_allclose(c[name].float().numpy(), _np(rc[name]), **MODEL_TOL)
    for i in range(n_new):
        tok = x[:, S + i:S + i + 1]
        want, ref_cache = dec(values, ref_cache, jnp.asarray(tok), jnp.int32(S + i))
        got, cache = M.decode_step(model, cache, _t(tok), S + i)
        np.testing.assert_allclose(got.float().numpy(), _np(want), **MODEL_TOL)


@pytest.mark.parametrize("arch", PARITY)
def test_prefill_decode_matches_forward(arch):
    """The port's own identity: forward(S + n) == prefill(S) + n decode
    steps, at the reference's tolerance for it. h2o-danube's rolling
    buffer (window 16) wraps: 24 + 4 tokens."""
    _, _, cfg, model = _pair(arch)
    B, S, n_new = 2, 24, 4
    x = _t(_inputs(cfg, B, S + n_new, seed=7))
    full, _ = M.forward(model, x)
    logits, cache = M.prefill(model, x[:, :S], S + n_new)
    np.testing.assert_allclose(logits[:, -1].float().numpy(),
                               full[:, S - 1].float().numpy(), **SELF_TOL)
    for i in range(n_new):
        logits, cache = M.decode_step(model, cache, x[:, S + i:S + i + 1], S + i)
        np.testing.assert_allclose(logits[:, -1].float().numpy(),
                                   full[:, S + i].float().numpy(), **SELF_TOL)


def test_cache_shapes_match_reference():
    """Per layer, the reference's cache shapes and dtypes with each scan
    group's stacked leading axis taken apart; the full-attention and the
    rolling (window) buffers, MLA's latent caches (bf16), and the RG-LRU's
    and xLSTM's recurrent states (f32); zeros of those dtypes from
    `init_cache`."""
    dtypes = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
              jnp.dtype(jnp.float32): torch.float32}
    for arch in PARITY:
        rcfg, cfg = ref_configs.get(arch).reduced(), configs.get(arch).reduced()
        want = []
        for (unit, reps), group in zip(rcfg.scan_groups(),
                                       ref_model.cache_shapes(rcfg, 3, 40)):
            for _ in range(reps):
                for i in range(len(unit)):
                    want.append({
                        name: (tuple(shape[1:] if reps > 1 else shape),
                               dtypes[jnp.dtype(dtype)])
                        for name, (shape, _, dtype) in group[f"b{i}"].items()})
        got = [{name: (shape, dtype) for name, (shape, dtype) in layer.items()}
               for layer in M.cache_shapes(cfg, 3, 40)]
        assert got == want
        cache = M.init_cache(cfg, 3, 40, "cpu")
        for c, shapes in zip(cache, got):
            for name, (shape, dtype) in shapes.items():
                assert c[name].dtype == dtype
                assert tuple(c[name].shape) == shape and not c[name].any()
