"""Training in the port (`repro_torch.models.flash_vjp` backward,
`models.model.loss_fn`, `train.optimizer`, `train.step`, `configs.shapes`)
against the reference's, on the same inputs, on the CPU.

Inputs are drawn with numpy from a seed; model weights are the
reference's own (`init_params` + `split_params`), carried into the port
as f32 masters by `convert.model_from_reference(param_dtype=float32)`.
The reference's loss and gradients run jitted, one compile a config.

Tolerances, and why:
  * the flash backward against the reference's `_bwd` on f32 inputs:
    rtol 1e-5, atol 1e-5 (the same f32 products summed in other
    orders); on bf16 inputs within 2 bf16 ulps of the largest entry
    (both round the output and dq, dk, dv to bf16 once; the outputs are
    held alike); against autograd through the
    plain `_scan` in f64: 1e-12.
  * AdamW against the reference's `update`: rtol 1e-5, atol 1e-8 (f32
    element-wise arithmetic; the global norm sums in another order).
  * loss and gradients of the reduced models: loss rtol 1e-3; each
    parameter's gradient within a relative Frobenius error of 0.05 of
    the reference's, plus an absolute floor of 1e-6 of the global
    gradient norm for gradients that vanish analytically (the mLSTM's
    input-gate bias: its output is invariant to a common scale of the
    input gates, so its gradient is ~1e-11 of noise in both). The
    forwards differ by 1-2 bf16 ulps (tests/test_torch_models.py); the
    backward rounds its cotangents to bf16 at every cast, so gradient
    errors of up to 2.2% were seen (the MoE router, the RG-LRU's gates).
    All gradients together: a relative Frobenius error of 0.05.
    xlstm-125m's single gradients are held at 0.5: its recurrences
    amplify one bf16 ulp (ROADMAP §3), so much that the reference's own
    gradients, compiled with and without XLA's excess precision, differ
    by 20-41% in most of its first unit's weights and by 111% in an
    input-gate bias; the port was up to 23% from the reference (an
    input-gate bias), 5.4% in a product's weight.
  * `accum_steps = 2` against one batch in the port: loss rtol 1e-5;
    gradient norm and first moments (the clipped gradients times 0.1)
    within a relative error of 1e-2; each parameter's update within 5%
    of the one-batch update (a first AdamW step moves a coordinate by
    about ±lr whatever the gradient's size, so an entry whose tiny
    gradient flips its sign between the two moves by 2·lr).
    A token's gradient does not depend on the other microbatch, but the
    logits' cotangent is scaled by 1/tokens before its bf16 rounding, a
    different scale in one batch and in a microbatch (2.4e-3 seen).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs import shapes as ref_shapes
from repro.models import flash_vjp as ref_flash
from repro.models import model as ref_model
from repro.models.layers import split_params
from repro.train import optimizer as ref_opt
from repro_torch import configs, convert
from repro_torch.configs import shapes
from repro_torch.models import flash_vjp
from repro_torch.models import model as M
from repro_torch.train import optimizer as opt
from repro_torch.train.step import make_train_step

NO_EXCESS = {"xla_allow_excess_precision": False}
# one reduced config of each family: GQA with bias and tied embeddings;
# MLA + MoE with a dense first layer; RG-LRU + local MQA; mLSTM / sLSTM
FAMILIES = ["qwen2-0.5b", "deepseek-v2-lite-16b", "recurrentgemma-9b",
            "xlstm-125m"]
GRAD_RTOL = {"xlstm-125m": 0.5}
GRAD_FLOOR = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's operations at these sizes run faster on one thread, and
    the suite runs several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, dtype=None, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dtype is not None:
        t = t.to(dtype)
    return t.requires_grad_(grad)


# ------------------------------------------------------------------ #
# the flash backward
# ------------------------------------------------------------------ #
# (S, chunk, window, packing, hd, hdv): two chunks and three, a window
# inside the chunk, the full masked grid, and MLA's hdv != hd
WALKS = [(16, 8, 0, True, 8, 8), (24, 8, 8, True, 8, 12),
         (24, 8, 0, False, 8, 12), (16, 8, 8, False, 8, 8)]


def _attn_inputs(S, hd, hdv, seed=0, B=2, KV=2, G=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, KV, G, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hdv)).astype(np.float32),
            rng.standard_normal((B, S, KV, G, hdv)).astype(np.float32))


@pytest.mark.parametrize("S,C,window,packing,hd,hdv,dtype",
                         [(*w, "float32") for w in WALKS]
                         + [(*WALKS[1], "bfloat16")])
def test_flash_backward_matches_reference(S, C, window, packing, hd, hdv,
                                          dtype):
    q, k, v, do = _attn_inputs(S, hd, hdv)
    scale = hd ** -0.5
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in (q, k, v, do))
    out_r, res = ref_flash._fwd(jq, jk, jv, C, window, packing, scale)
    want = ref_flash._bwd(C, window, packing, scale, res, jdo)
    tq, tk, tv = (_t(a, tdt, grad=True) for a in (q, k, v))
    out = flash_vjp.flash_causal(tq, tk, tv, C, window, packing, scale)
    got = torch.autograd.grad(out, (tq, tk, tv), _t(do, tdt))
    assert [g.dtype for g in got] == [tdt] * 3
    for name, g, w in zip(("out", "dq", "dk", "dv"), (out.detach(), *got),
                          (out_r, *want)):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            assert np.abs(g - w).max() <= 2 * 2.0 ** -8 * np.abs(w).max(), name


@pytest.mark.parametrize("S,C,window,packing,hd,hdv", WALKS)
def test_flash_backward_matches_autograd_f64(S, C, window, packing, hd, hdv):
    """The hand-written backward equals autograd through the plain online
    softmax walk (`_scan`), both in f64."""
    q, k, v, do = _attn_inputs(S, hd, hdv, seed=1)
    ts = [_t(a, torch.float64, grad=True) for a in (q, k, v)]
    dout = _t(do, torch.float64)
    scale = hd ** -0.5
    out = flash_vjp.flash_causal(*ts, C, window, packing, scale)
    got = torch.autograd.grad(out, ts, dout)
    plain, _, _ = flash_vjp._scan(*ts, C, window, packing, scale, False)
    want = torch.autograd.grad(plain, ts, dout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------------ #
# AdamW
# ------------------------------------------------------------------ #
def test_adamw_matches_reference():
    """Five steps on a random tree with 1-D leaves (no decay) and
    gradients large enough that the global-norm clip binds."""
    rng = np.random.default_rng(3)
    shapes_ = {"a": (4, 3), "b": (5,), "c": (2, 3, 2), "n": (3,)}
    p0 = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes_.items()}
    cfg = ref_opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    port_cfg = opt.AdamWConfig(**dataclasses.asdict(cfg))
    ref_p = {n: jnp.asarray(v) for n, v in p0.items()}
    ref_s = ref_opt.init(ref_p)
    params = {n: _t(v.copy()) for n, v in p0.items()}
    state = opt.init(params)
    ref_update = jax.jit(ref_opt.update, static_argnums=0)
    for step in range(5):
        grads = {n: (rng.standard_normal(s) * (3.0 if step % 2 else 0.1))
                 .astype(np.float32) for n, s in shapes_.items()}
        ref_p, ref_s, ref_m = ref_update(
            cfg, {n: jnp.asarray(g) for n, g in grads.items()}, ref_s, ref_p)
        params, state, met = opt.update(
            port_cfg, {n: _t(g) for n, g in grads.items()}, state, params)
        tol = dict(rtol=1e-5, atol=1e-8)
        for n in shapes_:
            np.testing.assert_allclose(params[n].numpy(), ref_p[n], **tol)
            np.testing.assert_allclose(state["m"][n].numpy(), ref_s["m"][n], **tol)
            np.testing.assert_allclose(state["v"][n].numpy(), ref_s["v"][n], **tol)
        assert int(state["step"]) == int(ref_s["step"]) == step + 1
        assert state["step"].dtype == torch.int32
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(ref_m["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(met["lr"]), float(ref_m["lr"]),
                                   rtol=1e-6)


@pytest.mark.parametrize("arch", FAMILIES[:2])
def test_adamw_on_a_model_matches_reference(arch):
    """Three steps of the train step's AdamW on every parameter of a
    reduced model (its values perturbed so biases and norms are neither 0
    nor 1) against the reference's `update` on its own tree: the decay
    follows the reference's leaves (`convert.reference_ndims`), which
    split the port's merged head axes and stack a scan group of several
    layers — qwen2's biases and norms are decayed, deepseek's dense first
    layer's norms are not."""
    cfg, rcfg, values, _ = _family(arch)
    rng = np.random.default_rng(5)
    p0 = jax.tree.map(lambda a: np.asarray(a, np.float32)
                      + 0.02 * rng.standard_normal(a.shape).astype(np.float32),
                      values)
    ocfg = ref_opt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    ref_p, ref_update = jax.tree.map(jnp.asarray, p0), jax.jit(ref_opt.update,
                                                              static_argnums=0)
    ref_s = ref_opt.init(ref_p)
    params = dict(convert.model_from_reference(
        cfg, p0, device="cpu", param_dtype=torch.float32).named_parameters())
    state = opt.init(params)
    ndims = convert.reference_ndims(cfg, params)
    assert any(params[n].ndim != d for n, d in ndims.items())
    for step in range(3):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32)
                         * (3.0 if step % 2 else 0.1), values)
        ref_p, ref_s, _ = ref_update(ocfg, jax.tree.map(jnp.asarray, g), ref_s, ref_p)
        grads = {n: torch.zeros_like(p) for n, p in params.items()}
        convert.load_reference_tree(cfg, grads, g)
        params, state, _ = opt.update(opt.AdamWConfig(**dataclasses.asdict(ocfg)),
                                      grads, state, params, ndims)
        for got, want in ((params, ref_p), (state["m"], ref_s["m"]),
                          (state["v"], ref_s["v"])):
            like = {n: torch.zeros_like(p) for n, p in got.items()}
            convert.load_reference_tree(cfg, like, jax.tree.map(np.asarray, want))
            for n in got:
                np.testing.assert_allclose(got[n].numpy(), like[n].numpy(),
                                           rtol=1e-5, atol=1e-8, err_msg=n)


def test_adamw_schedule_matches_reference():
    cfg = ref_opt.AdamWConfig(warmup_steps=10, total_steps=50)
    port_cfg = opt.AdamWConfig(**dataclasses.asdict(cfg))
    for s in (0, 1, 5, 10, 11, 30, 50, 60):
        np.testing.assert_allclose(
            float(opt.schedule(port_cfg, torch.tensor(s, dtype=torch.int32))),
            float(ref_opt.schedule(cfg, jnp.int32(s))), rtol=1e-6)


# ------------------------------------------------------------------ #
# loss and gradients of the four families
# ------------------------------------------------------------------ #
@functools.lru_cache(maxsize=None)
def _family(arch, B=2, S=32):
    """(port cfg, reference cfg, reference values, numpy batch) of a
    reduced config, made once a module; S = 32 is two attention chunks of
    16."""
    rcfg = ref_configs.get(arch).reduced()
    values, _ = split_params(ref_model.init_params(rcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(11)
    tok = rng.integers(0, rcfg.vocab, (B, S)).astype(np.int32)
    return configs.get(arch).reduced(), rcfg, values, {"inputs": tok, "labels": tok}


def _ref_loss_and_grads(rcfg, values, batch):
    fn = jax.jit(jax.value_and_grad(
        lambda v, b: ref_model.loss_fn(v, b, rcfg), has_aux=True))
    (loss, aux), grads = fn.lower(values, batch).compile(
        compiler_options=NO_EXCESS)(values, batch)
    return float(loss), {k: float(v) for k, v in aux.items()}, grads


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch):
    cfg, rcfg, values, batch = _family(arch)
    loss_r, aux_r, grads_r = _ref_loss_and_grads(rcfg, values, batch)
    model = convert.model_from_reference(cfg, values, device="cpu",
                                         param_dtype=torch.float32)
    model.requires_grad_(True)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    loss, parts = M.loss_fn(model, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss.detach()), loss_r, rtol=1e-3)
    np.testing.assert_allclose(float(parts["ce"].detach()), aux_r["ce"], rtol=1e-3)
    np.testing.assert_allclose(float(parts["aux"].detach()), aux_r["aux"],
                               rtol=1e-2, atol=1e-6)
    named = dict(model.named_parameters())
    got = torch.autograd.grad(loss, list(named.values()))
    want = {n: torch.zeros_like(p) for n, p in named.items()}
    convert.load_reference_tree(cfg, want, jax.tree.map(np.asarray, grads_r))
    total = float(opt.global_norm(want.values()))
    for (name, w), g in zip(want.items(), got):
        err = float((g - w).norm())
        rtol = GRAD_RTOL.get(arch, 0.05)
        assert err <= rtol * float(w.norm()) + GRAD_FLOOR * total, (
            name, err, float(w.norm()))
    diff = opt.global_norm(g - w for g, w in zip(got, want.values()))
    assert float(diff) <= 0.05 * total, (float(diff), total)


def test_training_forward_equals_serving_forward():
    """f32 masters cast at each use give the serving model's numbers:
    forward(training=True) on masters == forward() on bf16 weights."""
    cfg, _, values, batch = _family("qwen2-0.5b")
    serve = convert.model_from_reference(cfg, values, device="cpu")
    train = convert.model_from_reference(cfg, values, device="cpu",
                                         param_dtype=torch.float32)
    train.requires_grad_(True)
    x = _t(batch["inputs"])
    want, _ = M.forward(serve, x)
    got, _ = M.forward(train, x, training=True)
    assert got.requires_grad
    torch.testing.assert_close(got.detach(), want, rtol=0, atol=0)


def test_accumulation_matches_one_batch():
    cfg, _, values, batch = _family("qwen2-0.5b")
    ocfg = opt.AdamWConfig(warmup_steps=1, total_steps=4)
    tb = {k: _t(v) for k, v in batch.items()}
    out = []
    for accum in (1, 2):
        model = convert.model_from_reference(cfg, values, device="cpu",
                                             param_dtype=torch.float32)
        model.requires_grad_(True)
        state = opt.init(dict(model.named_parameters()))
        model, state, met = make_train_step(cfg, ocfg, accum)(model, state, tb)
        out.append((model, state, met))
    (m1, s1, a), (m2, s2, b) = out
    np.testing.assert_allclose(float(b["loss"]), float(a["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(b["grad_norm"]), float(a["grad_norm"]),
                               rtol=1e-2)
    for n in s1["m"]:
        w, g = s1["m"][n], s2["m"][n]
        assert float((g - w).norm()) <= 1e-2 * float(w.norm()) + 1e-12, n
    before = dict(convert.model_from_reference(
        cfg, values, device="cpu", param_dtype=torch.float32).named_parameters())
    for (n, p1), p2 in zip(m1.named_parameters(), m2.parameters()):
        step1, step2 = (p1 - before[n]).detach(), (p2 - before[n]).detach()
        assert float(step1.norm()) > 0, n
        assert float((step2 - step1).norm()) <= 0.05 * float(step1.norm()), n


# ------------------------------------------------------------------ #
# configs/shapes
# ------------------------------------------------------------------ #
def test_shapes_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in ref_shapes.SHAPES.items()}
    got = shapes.cells(configs.all_configs())
    want = ref_shapes.cells(ref_configs.all_configs())
    assert got == want
    assert any(not ok for _, _, ok, _ in got)
