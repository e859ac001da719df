"""The port's recurrent mixers (`repro_torch.models.recurrent`: the RG-LRU;
`repro_torch.models.xlstm`: mLSTM and sLSTM) against the reference's, each
alone on the same weights and inputs (drawn with numpy from a seed), on
the CPU; and the two configs that use them served through the launcher.

The weights are the reference's own init, with every bias, the mLSTM's
norm and the RG-LRU's conv bias set to random values so that their paths
are exercised (the RG-LRU's conv bias is rounded to bf16 in forward and
prefill and added in f32 in decode, as in the reference). They reach the
port by name (`convert._load`, as `model_from_reference` loads a block).
The reference's functions run jitted, once for each module's fixture.

Tolerances, and why:
  * a mixer's bf16 output: within 2 bf16 ulps (2 · 2^-7) of each value
    or of the output's RMS, whichever is larger. Both sum bf16 products
    in f32 and round once; the f32 gate and state arithmetic in between
    sums in other orders (the RG-LRU's scan is Hillis–Steele doubling
    here, `associative_scan`'s tree there; torch's cumsum and XLA's
    reduce-window; XLA's exp, tanh and logistic are its own), which now
    and then moves an input of the last product across a bf16 rounding
    boundary. That product's sum carries the ulp at the scale of its
    terms, so an output that cancels to near 0 is held at the scale of
    the output (such elements were seen 10 ulps of their own value off,
    0.0017 absolute, in the mLSTM over two chunks).
  * a mixer's f32 state (RG-LRU h and its conv window, mLSTM C and n,
    sLSTM c, n, h, m): rtol 1e-4, atol 1e-5, a few f32 ulps of the
    largest values after the sequence's sums in other orders.
  * the f32 weights the port stores unrounded: bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import recurrent as ref_recurrent
from repro.models import xlstm as ref_xlstm
from repro.models.layers import split_params
from repro_torch import configs, convert
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as M
from repro_torch.models import recurrent, xlstm

OUT_ULPS = 2 * 2.0 ** -7
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
B, N_DECODE = 2, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's operations at these sizes run faster on one thread, and
    the suite runs several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return ref_configs.get(arch).reduced(), configs.get(arch).reduced()


def _np(x):
    return np.asarray(x, np.float32)


def _bf16_pair(a):
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _values(init, rcfg, randomised, seed):
    """The reference's init of one mixer as numpy arrays, the leaves named
    in `randomised` replaced by seeded random values."""
    values, _ = split_params(init(jax.random.PRNGKey(seed), rcfg))
    values = {k: np.asarray(v, np.float32) for k, v in values.items()}
    rng = np.random.default_rng(seed)
    for name, (center, scale) in randomised.items():
        values[name] = (center + scale * rng.standard_normal(values[name].shape)
                        ).astype(np.float32)
    return values


REF_MIXERS = {  # forward, prefill, decode
    "rglru": (ref_recurrent.rglru, ref_recurrent.rglru_prefill, ref_recurrent.rglru_decode),
    "mlstm": (ref_xlstm.mlstm, ref_xlstm.mlstm_prefill, ref_xlstm.mlstm_decode),
    "slstm": (ref_xlstm.slstm, ref_xlstm.slstm_prefill, ref_xlstm.slstm_decode),
}


def _run(kind, layer, values, rcfg, cfg, S, seed):
    """forward (S + N_DECODE tokens; the mLSTM's S, whole chunks), prefill
    (S, its cache) and N_DECODE decode steps of one mixer: {step: (the
    reference's, the port's)}."""
    ref_fwd, ref_prefill, ref_decode = REF_MIXERS[kind]
    _, fwd, decode, _, prefill = M.MIXERS[kind]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S + N_DECODE, cfg.d_model)).astype(np.float32)
    jx, tx = _bf16_pair(x)
    jp = {k: jnp.asarray(v) for k, v in values.items()}
    pos = np.broadcast_to(np.arange(S + N_DECODE, dtype=np.int32), (B, S + N_DECODE))
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos.copy())
    out = {}
    S_fwd = S if kind == "mlstm" else S + N_DECODE
    want = jax.jit(lambda v, t, q: ref_fwd(v, t, q, rcfg))(jp, jx[:, :S_fwd], jpos[:, :S_fwd])
    out["forward"] = (want, fwd(layer, tx[:, :S_fwd], tpos[:, :S_fwd], cfg))
    want, ref_cache = jax.jit(lambda v, t, q: ref_prefill(v, t, q, rcfg, S + N_DECODE))(
        jp, jx[:, :S], jpos[:, :S])
    got, cache = prefill(layer, tx[:, :S], tpos[:, :S], cfg, S + N_DECODE)
    out["prefill"] = (want, got)
    out["prefill_cache"] = (dict(ref_cache), {k: v.clone() for k, v in cache.items()})
    step = jax.jit(lambda v, t, c, p: ref_decode(v, t, c, p, rcfg))
    for i in range(N_DECODE):
        t = S + i
        want, ref_cache = step(jp, jx[:, t:t + 1], ref_cache, jnp.int32(t))
        got, cache = decode(layer, tx[:, t:t + 1], cache, t, cfg)
        out[f"decode {i}"] = (want, got)
    out["decode_cache"] = (dict(ref_cache), cache)
    return out


def _check_out(pair):
    want, got = pair
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    w = _np(want)
    rms = float(np.sqrt(np.mean(w * w)))
    np.testing.assert_allclose(got.float().numpy(), w, rtol=OUT_ULPS, atol=OUT_ULPS * rms)


def _check_state(pair):
    want, got = pair
    assert got.keys() == want.keys()
    for name in got:
        assert got[name].dtype == torch.float32, name
        assert tuple(got[name].shape) == want[name].shape, name
        np.testing.assert_allclose(got[name].numpy(), _np(want[name]), err_msg=name,
                                   **STATE_TOL)


# ------------------------------------------------------------------ #
# RG-LRU
# ------------------------------------------------------------------ #
RG = "recurrentgemma-9b"
RG_RANDOMISED = {"conv_b": (0.0, 0.3), "b_r": (0.0, 0.5), "b_i": (0.0, 0.5)}


def _rglru_layer():
    rcfg, cfg = _cfgs(RG)
    values = _values(ref_recurrent.init_rglru, rcfg, RG_RANDOMISED, seed=0)
    layer = recurrent.RGLRU(cfg, "cpu")
    convert._load(layer, values)
    return rcfg, cfg, values, layer


@pytest.fixture(scope="module")
def rglru_run():
    """S = 29: the Hillis–Steele scan's last stride (16) covers a partial
    span, and prefill leaves a full conv window."""
    rcfg, cfg, values, layer = _rglru_layer()
    return _run("rglru", layer, values, rcfg, cfg, S=29, seed=1)


@pytest.mark.parametrize("step", ["forward", "prefill"] + [f"decode {i}" for i in range(N_DECODE)])
def test_rglru_matches_reference(rglru_run, step):
    _check_out(rglru_run[step])


@pytest.mark.parametrize("cache", ["prefill_cache", "decode_cache"])
def test_rglru_state_matches_reference(rglru_run, cache):
    """h (B, dr) and the conv window of the last cw - 1 pre-conv inputs
    (B, cw - 1, dr), f32, after prefill and after the decode steps."""
    _check_state(rglru_run[cache])


def test_rglru_short_prompt_raises():
    """A prompt shorter than conv_width - 1 cannot fill the decode conv
    window: the port refuses it at prefill, the mixer and the model."""
    _, cfg, _, layer = _rglru_layer()
    x = torch.zeros((1, cfg.conv_width - 2, cfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="conv_width - 1"):
        recurrent.rglru_prefill(layer, x, None, cfg, 8)
    model = M.init_params(cfg, 0, "cpu")
    with pytest.raises(ValueError, match="conv_width - 1"):
        M.prefill(model, torch.zeros((1, cfg.conv_width - 2), dtype=torch.int32), 8)
    M.prefill(model, torch.zeros((1, cfg.conv_width - 1), dtype=torch.int32), 8)


@pytest.mark.parametrize("S", [1, 2, 5, 16, 19, 64])
def test_linear_scan_matches_sequential(S):
    """The doubling scan against the sequential recurrence in f64."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 7)).astype(np.float32)
    b = rng.standard_normal((2, S, 7)).astype(np.float32)
    want = np.zeros_like(b, dtype=np.float64)
    h = np.zeros((2, 7))
    for t in range(S):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        want[:, t] = h
    got = recurrent.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ #
# mLSTM, sLSTM
# ------------------------------------------------------------------ #
XL = "xlstm-125m"
MLSTM_RANDOMISED = {"b_i": (0.0, 0.5), "b_f": (2.0, 0.5), "norm": (1.0, 0.1)}
SLSTM_RANDOMISED = {f"b_{g}": (0.0, 0.5) for g in xlstm.GATES}


def _xlstm_layer(kind, seed):
    rcfg, cfg = _cfgs(XL)
    init, cls, randomised = {
        "mlstm": (ref_xlstm.init_mlstm, xlstm.MLSTM, MLSTM_RANDOMISED),
        "slstm": (ref_xlstm.init_slstm, xlstm.SLSTM, SLSTM_RANDOMISED),
    }[kind]
    values = _values(init, rcfg, randomised, seed)
    layer = cls(cfg, "cpu")
    convert._load(layer, values)
    return rcfg, cfg, values, layer


@pytest.fixture(scope="module", params=[16, 512], ids=["one_chunk", "two_chunks"])
def mlstm_run(request):
    """One chunk (S = 16) and two (S = 512 over the chunk of 256)."""
    rcfg, cfg, values, layer = _xlstm_layer("mlstm", seed=2)
    return _run("mlstm", layer, values, rcfg, cfg, S=request.param, seed=3)


@pytest.mark.parametrize("step", ["forward", "prefill"] + [f"decode {i}" for i in range(N_DECODE)])
def test_mlstm_matches_reference(mlstm_run, step):
    _check_out(mlstm_run[step])


@pytest.mark.parametrize("cache", ["prefill_cache", "decode_cache"])
def test_mlstm_state_matches_reference(mlstm_run, cache):
    """The matrix memory C (B, nh, dh, dh) and normaliser n (B, nh, dh)."""
    _check_state(mlstm_run[cache])


def test_mlstm_chunk_refusal():
    """A sequence longer than the chunk must be a multiple of it, as the
    reference asserts; the port raises with a message."""
    assert xlstm.mlstm_chunk(16) == 16 and xlstm.mlstm_chunk(512) == 256
    _, cfg, _, layer = _xlstm_layer("mlstm", seed=2)
    x = torch.zeros((1, 300, cfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of its chunk 256; got 300"):
        xlstm.mlstm(layer, x, None, cfg)
    with pytest.raises(ValueError, match="multiple of its chunk"):
        xlstm.mlstm_prefill(layer, x, None, cfg, 310)


@pytest.fixture(scope="module")
def slstm_run():
    rcfg, cfg, values, layer = _xlstm_layer("slstm", seed=4)
    return _run("slstm", layer, values, rcfg, cfg, S=21, seed=5)


@pytest.mark.parametrize("step", ["forward", "prefill"] + [f"decode {i}" for i in range(N_DECODE)])
def test_slstm_matches_reference(slstm_run, step):
    _check_out(slstm_run[step])


@pytest.mark.parametrize("cache", ["prefill_cache", "decode_cache"])
def test_slstm_state_matches_reference(slstm_run, cache):
    """c, n, h, m (B, d) f32."""
    _check_state(slstm_run[cache])


# ------------------------------------------------------------------ #
# weights, init, serving
# ------------------------------------------------------------------ #
F32_LEAVES = {
    "rglru": ("conv_w", "conv_b", "w_r", "w_i", "b_r", "b_i", "lam"),
    "mlstm": ("w_i", "w_f", "b_i", "b_f", "norm"),
    "slstm": tuple(f"{w}_{g}" for g in xlstm.GATES for w in ("w", "r", "b")),
}


@pytest.mark.parametrize("kind", list(F32_LEAVES))
def test_weights_keep_the_reference_dtypes(kind):
    """The f32 leaves arrive bitwise; every other leaf is the reference's
    value rounded to bf16 (the reference rounds it at every use)."""
    if kind == "rglru":
        _, _, values, layer = _rglru_layer()
    else:
        _, _, values, layer = _xlstm_layer(kind, seed=6)
    params = dict(layer.named_parameters())
    assert params.keys() == values.keys()
    for name, p in params.items():
        assert tuple(p.shape) == values[name].shape, name
        if name in F32_LEAVES[kind]:
            assert p.dtype == torch.float32, name
            np.testing.assert_array_equal(p.numpy(), values[name], err_msg=name)
        else:
            assert p.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(
                p.float().numpy(),
                np.asarray(jnp.asarray(values[name]).astype(jnp.bfloat16), np.float32),
                err_msg=name)


@pytest.mark.parametrize("arch", [RG, XL])
def test_init_matches_reference_layout(arch):
    """The port's own init (seeded torch draws, not the reference's
    numbers): every leaf of every layer of the reduced config has the
    reference's size; zeros and ones are equal,
    the RG-LRU's lam within rtol 1e-4 (torch's linspace, pow and log
    differ from XLA's in the last bit, which the logit near 0.999^(1/8)
    amplifies), drawn weights at fan-in scale."""
    from repro.models import model as ref_model

    rcfg, cfg = _cfgs(arch)
    values, _ = split_params(ref_model.init_params(rcfg, jax.random.PRNGKey(0)))
    model = M.init_params(cfg, 0, "cpu")
    for ref, block in zip(convert._layer_values(rcfg, values["groups"]), model.layers):
        for name, p in block.named_parameters():
            leaf = ref
            for key in name.split("."):
                leaf = leaf[key]
            want, got = _np(leaf), p.float().numpy()
            assert want.size == got.size, name  # attention's head axes are merged
            want = want.reshape(got.shape)
            if name.endswith("lam"):
                np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=name)
            elif (want == want.flat[0]).all():
                np.testing.assert_array_equal(got, want, err_msg=name)
            else:
                assert 0.8 * want.std() < got.std() < 1.25 * want.std(), name


@pytest.mark.parametrize("arch", [RG, XL])
def test_launcher_serves_recurrent_configs(arch, capsys):
    """`python -m repro_torch.launch.serve --arch ... --smoke --device cpu`
    at the launcher's defaults (batch 4, 32-token prompts, 16 new tokens):
    prefill and 16 decode steps of the reduced config."""
    out = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    assert out["tokens"].shape == (4, 16)
    assert out["timing"]["new_tokens"] == 16
    assert "generated (4, 16)" in capsys.readouterr().out
    cfg = configs.get(arch).reduced()
    assert ((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab)).all()

