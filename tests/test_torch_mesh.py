"""The port on a mesh (`repro_torch.launch.mesh`, `models.sharding` on
DTensors, the mesh paths of `train/`, `launch/train` and the dry run) on
the CPU:

  * a fake 16 x 16 world (`mesh.fake_world`): the reduced qwen2-0.5b
    train step's parameter elements a device equal the closed form of the
    rules' placement, its collectives are counted; one sharded product
    gathers exactly its weight's data shard (all-gather bytes in closed
    form);
  * one spawned group of four gloo ranks, a 2 x 2 (data, model) mesh,
    for the reduced configs of the four families — qwen2-0.5b (GQA with
    biases), deepseek-v2-lite-16b (MLA and MoE), recurrentgemma-9b
    (RG-LRU and local attention) and xlstm-125m (mLSTM and sLSTM) —
    with weights carried from the reference by `convert.model_from_
    reference` and tokens from a numpy seed:
      - the loss and every gathered gradient equal the one-rank port's
        and the reference's (`jax.value_and_grad`);
      - serving: prefill of 16 tokens into a cache of 36 slots (time
        sharded on the model axis, 18 a rank, so the three decode steps
        write slots 16 and 17 on one rank and 18 on the other) and three
        decode steps, the logits against the one-rank port's and the
        reference's;
      - with the compute type patched to f64 on both sides (the f32
        sums, states and optimizer stay f32), the mesh computes the one
        rank's function: loss, gradients, the prefill caches and logits,
        and the parameters and both moments after two train steps
        (weights perturbed so that biases and norms are neither 0 nor 1,
        and a weight decay of 10, so that their decay shows). In bf16 the mesh's split sums move
        xlstm-125m's gradients by up to 21% of a tensor's norm; in f64
        the gap is 5e-5, so it is the recurrences' sensitivity to one
        rounding (tests/test_torch_train.py), not a fault of the mesh;
      - for qwen2-0.5b and deepseek-v2-lite-16b: a checkpoint written on
        2 x 2 restores on 1 x 1 bitwise, one written on 1 x 1 restores on
        2 x 2 bitwise, and the reference's `restore` reads the 2 x 2 one;
        the train step's collective bytes, counted live, equal by kind
        those of the same step traced on a fake 2 x 2 mesh;
  * `launch/train` under `torch.distributed.run` with four gloo ranks
    fails at the injected step and resumes from its checkpoint.

Tolerances. bf16, mesh against one rank: the loss to rtol 1e-4 and each
gradient to 2% of its norm (the same products, their sums split across
ranks and all-reduced in f32); xlstm-125m's gradients to 0.5 of a
tensor's norm and 0.1 over all (its recurrences amplify one bf16 ulp:
21% and 5.5% seen). Against the reference those of
tests/test_torch_train.py (loss rtol 1e-3, gradients 5% of the norm,
xlstm-125m 0.5 a tensor, all together 5%). Serving logits:
tests/test_torch_models.py's MODEL_TOL against both. f64: the loss to
rtol 1e-6, gradients and moments to 1e-3 of a tensor's norm (gradients
3.3e-6 seen), parameters after two steps at lr 1e-4 to 5e-5 of theirs
(1.4e-5 seen; a first AdamW step moves a coordinate by about ±lr whatever
its gradient's size, so an entry whose tiny gradient differs in sign
moves by 2·lr, and xlstm-125m's next gradient amplifies that; a decay
applied on one side only, lr x 10 x 2 steps, would be 2e-3), logits and
caches to 1e-4 absolute (3e-6 seen).
"""
import contextlib
import importlib
import os
import pathlib
import pickle
import socket
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor

from repro import configs as ref_configs
from repro.models import model as ref_model
from repro.models.layers import split_params
from repro.train import checkpoint as ref_ckpt
from repro_torch import configs, convert
from repro_torch.configs.shapes import Shape
from repro_torch.launch import dryrun, hlo, mesh as mesh_lib
from repro_torch.models import model as M
from repro_torch.models import sharding
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop as loop_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.step import make_train_step

ARCHS = ("qwen2-0.5b", "deepseek-v2-lite-16b")  # + checkpoints, collectives
FAMILIES = ARCHS + ("recurrentgemma-9b", "xlstm-125m")
B, S = 4, 32  # the batch splits over data = 2; S is two attention chunks
PROMPT, N_NEW, CACHE_LEN = 16, 3, 36
GRAD_RTOL = {"xlstm-125m": 0.5}  # a tensor, against one rank and the reference
GRAD_ALL = {"xlstm-125m": 0.1}   # all together, against one rank
MODEL_TOL = dict(rtol=0.03, atol=0.03)
EXACT_STEPS = 2
NO_EXCESS = {"xla_allow_excess_precision": False}
ENV = {"card": "test card", "power_limit": "700.00 W", "memory_bytes": 80 * 10**9,
       "hbm_bytes_per_s": 3.35e12, "bf16_flops_per_s": 989e12,
       "f32_flops_per_s": 67e12}
SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(vocab):
    tok = np.random.default_rng(11).integers(0, vocab, (B, S)).astype(np.int32)
    return {"inputs": tok, "labels": tok}


def _values(arch):
    rcfg = ref_configs.get(arch).reduced()
    values, _ = split_params(ref_model.init_params(rcfg, jax.random.PRNGKey(0)))
    return rcfg, jax.tree.map(np.asarray, values)


def _torch_batch(batch, rules=None):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    if rules is not None:
        out = {k: sharding.place(v, rules, ("batch", None)) for k, v in out.items()}
    return out


def _host_tree(tree):
    """A state tree with every leaf a numpy array (DTensors gathered)."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host_tree(v) for v in tree]
    return ckpt._host(tree)


@contextlib.contextmanager
def _compute_in(dtype):
    """The models' compute type (bf16) replaced by `dtype` in every module
    that reads it, for as long as the context lasts."""
    mods = [importlib.import_module(f"repro_torch.models.{m}") for m in
            ("layers", "attention", "model", "moe", "recurrent", "xlstm")]
    old = [m.COMPUTE_DTYPE for m in mods]
    for m in mods:
        m.COMPUTE_DTYPE = dtype
    try:
        yield
    finally:
        for m, d in zip(mods, old):
            m.COMPUTE_DTYPE = d


def _full(t) -> np.ndarray:
    """A copy of `t`, whole, as numpy (bf16 as f32)."""
    t = t.full_tensor() if isinstance(t, DTensor) else t
    t = t.detach().float() if t.dtype == torch.bfloat16 else t.detach()
    return t.numpy().copy()


def _tokens(vocab):
    return np.random.default_rng(12).integers(
        0, vocab, (B, PROMPT + N_NEW)).astype(np.int32)


def _rules_ctx(rules):
    from torch.distributed.tensor.experimental import implicit_replication

    stack = contextlib.ExitStack()
    if rules is not None:
        stack.enter_context(sharding.axis_rules(rules))
        stack.enter_context(implicit_replication())
    return stack


def _serve(cfg, values, rules, dtype=None):
    """Prefill of PROMPT tokens into CACHE_LEN slots and N_NEW decode
    steps, on `rules`' mesh (None: one rank): (the logits of each, the
    prefill's caches), numpy."""
    model = convert.model_from_reference(cfg, values, device="cpu", param_dtype=dtype)
    if rules is not None:
        sharding.shard_model(model, rules)
    tok = torch.from_numpy(_tokens(cfg.vocab))

    def put(t):
        return t if rules is None else sharding.place(t, rules, ("batch", None))

    with _rules_ctx(rules):
        logits, cache = M.prefill(model, put(tok[:, :PROMPT].contiguous()), CACHE_LEN)
        caches = [{k: _full(v) for k, v in c.items()} for c in cache]
        out = [_full(logits)]
        for i in range(N_NEW):
            logits, cache = M.decode_step(
                model, cache, put(tok[:, PROMPT + i:PROMPT + i + 1].contiguous()),
                PROMPT + i)
            out.append(_full(logits))
    return out, caches


def _exact(cfg, values, rules, serve_rules):
    """In the compute type the caller set: the loss and gradients of one
    batch, the parameters and moments after EXACT_STEPS train steps, and
    `_serve`'s readings, on `rules`' mesh (None: one rank)."""
    f64 = torch.float64
    model = convert.model_from_reference(cfg, values, device="cpu", param_dtype=f64)
    if rules is not None:
        sharding.shard_model(model, rules)
    model.requires_grad_(True)
    batch = _torch_batch(_batch(cfg.vocab), rules)
    named = dict(model.named_parameters())
    # a small step, so that the second step's gradient is taken at nearly
    # the same point on both sides, and a decay large enough to show
    step = make_train_step(cfg, opt_lib.AdamWConfig(
        lr=1e-4, weight_decay=10.0, warmup_steps=1, total_steps=4))
    with _rules_ctx(rules):
        loss, _ = M.loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(named.values()))
        res = {"loss": float(_full(loss)),
               "grads": {n: _full(g) for n, g in zip(named, grads)}}
        opt = opt_lib.init(named)
        for _ in range(EXACT_STEPS):
            step(model, opt, batch)
    res["state"] = {n: (_full(p), _full(opt["m"][n]), _full(opt["v"][n]))
                    for n, p in model.named_parameters()}
    res["serve"] = _serve(cfg, values, serve_rules, f64)
    return res


def _perturbed(values):
    """`values` plus N(0, 0.02²) noise from a numpy seed: biases and norms
    neither 0 nor 1."""
    rng = np.random.default_rng(13)
    return jax.tree.map(lambda a: (a + 0.02 * rng.standard_normal(a.shape))
                        .astype(a.dtype), values)


# ------------------------------------------------------------------ #
# a fake 16 x 16 world
# ------------------------------------------------------------------ #
def test_fake_16x16_reduced_train_step():
    cfg = configs.get("qwen2-0.5b").reduced()
    rec = dryrun.run_cell("qwen2-0.5b", Shape("train_s", "train", 64, 32), "single",
                          envelope=ENV, cfg=cfg, device_type="cpu")
    assert rec["n_devices"] == 256 and not rec.get("error")
    shape, names = mesh_lib.PRODUCTION[False]
    rules = sharding.train_rules(SimpleNamespace(mesh_dim_names=names, shape=shape))
    closed = 0
    for shape, spec in sharding.param_layout(cfg, M.Model(cfg, device="meta")).values():
        shards = 1
        for axes in rules.resolve(shape, spec):
            for a in ((axes,) if isinstance(axes, str) else axes or ()):
                shards *= rules.sizes[a]
        closed += int(np.prod(shape)) // shards
    assert rec["param_elements_per_device"] == closed
    assert rec["collective_bytes_per_device_total"] > 0
    assert set(rec["collective_bytes_per_device_by_axis"]) <= {"data", "model"}


def test_sharded_product_gathers_its_weight_shard():
    """x (32, 8, 64) by batch on data, w (64, 128) f32 as (fsdp, tp): the
    product gathers w's data shard — 16 pieces of (4, 8) f32 — and
    nothing else; the result keeps the batch on data and the output dim
    on model."""
    from repro_torch.models.layers import matmul

    with mesh_lib.fake_world(256):
        mesh = mesh_lib.make_production_mesh(device_type="cpu")
        rules = sharding.train_rules(mesh)
        x = sharding.place(torch.empty(32, 8, 64, dtype=torch.bfloat16, device="meta"),
                           rules, ("batch", None, None))
        w = sharding.place(torch.empty(64, 128, device="meta"), rules, ("fsdp", "tp"))
        with sharding.axis_rules(rules):
            tr = hlo.trace(matmul, x, w)
        y = tr.result
        assert y.to_local().shape == (2, 8, 8)
    assert tr.cost.collective_bytes == {"all-gather": 4 * 8 * 4}


# ------------------------------------------------------------------ #
# four gloo ranks on a 2 x 2 mesh
# ------------------------------------------------------------------ #
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank, port, root, queue):
    torch.set_num_threads(1)
    with open(root / "values.pkl", "rb") as f:
        values, perturbed = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    mesh = mesh_lib.make_host_mesh(2, 2, device_type="cpu")
    rules, serve = sharding.train_rules(mesh), sharding.serve_rules(mesh)
    out = {}
    for arch in FAMILIES:
        cfg = configs.get(arch).reduced()
        model = convert.model_from_reference(cfg, values[arch], device="cpu",
                                             param_dtype=torch.float32)
        sharding.shard_model(model, rules).requires_grad_(True)
        batch = _torch_batch(_batch(cfg.vocab), rules)
        named = dict(model.named_parameters())
        counter = hlo.Counter()
        with _rules_ctx(rules):
            loss, _ = M.loss_fn(model, batch)
            grads = torch.autograd.grad(loss, list(named.values()))
            opt = opt_lib.init(named)
            if arch in ARCHS:
                with counter:
                    make_train_step(cfg, opt_lib.AdamWConfig())(model, opt, batch)
        res = {"loss": float(loss.full_tensor()),
               "grads": {n: g.full_tensor().numpy() for n, g in zip(named, grads)},
               "serve": _serve(cfg, values[arch], serve)}
        out[arch] = res
        if arch not in ARCHS:
            continue
        res["coll"] = dict(counter.cost.collective_bytes)
        trees = loop_lib.state_trees(cfg, model, opt)
        ckpt.save(root / arch / "mesh", 1, trees)
        res["state"] = _host_tree(trees)
        # the 1 x 1 checkpoint restored on this mesh: whole == the file
        path = ckpt.latest(root / arch / "one")
        back = ckpt.restore(path, trees)
        with np.load(path / "params.npz") as f:
            res["back_bitwise"] = all(
                np.array_equal(ckpt._host(t), f[k])
                for k, t in ckpt._leaves(back["params"]))
            res["back_sharded"] = all(
                isinstance(t, DTensor) for _, t in ckpt._leaves(back["params"]))
    with _compute_in(torch.float64):
        for arch in FAMILIES:
            cfg = configs.get(arch).reduced()
            out[arch]["exact"] = _exact(cfg, perturbed[arch], rules, serve)
    if rank == 0:
        queue.put(out)
    dist.barrier()
    dist.destroy_process_group()


def _one_rank(arch, values, root):
    """The one-rank port's loss, gradients, model, optimizer state and
    `_serve` readings; for ARCHS after a train step, checkpointed in
    root/arch/one."""
    cfg = configs.get(arch).reduced()
    batch = _torch_batch(_batch(cfg.vocab))
    model = convert.model_from_reference(cfg, values, device="cpu",
                                         param_dtype=torch.float32)
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    loss, _ = M.loss_fn(model, batch)
    grads = torch.autograd.grad(loss, list(named.values()))
    opt = opt_lib.init(named)
    if arch in ARCHS:
        make_train_step(cfg, opt_lib.AdamWConfig())(model, opt, batch)
        ckpt.save(root / arch / "one", 1, loop_lib.state_trees(cfg, model, opt))
    return (float(loss.detach()), dict(zip(named, grads)), cfg, model, opt,
            _serve(cfg, values, None))


def _reference(rcfg, values):
    """The reference's loss, gradients and `_serve` logits."""
    batch = _batch(rcfg.vocab)
    fn = jax.jit(jax.value_and_grad(
        lambda v, b: ref_model.loss_fn(v, b, rcfg), has_aux=True))
    (loss, _), grads = fn.lower(values, batch).compile(
        compiler_options=NO_EXCESS)(values, batch)
    tok = _tokens(rcfg.vocab)
    pre = jax.jit(lambda v, t: ref_model.prefill(v, t, rcfg, CACHE_LEN))
    dec = jax.jit(lambda v, c, t, p: ref_model.decode_step(v, c, t, p, rcfg))
    logits, cache = pre.lower(values, tok[:, :PROMPT]).compile(
        compiler_options=NO_EXCESS)(values, tok[:, :PROMPT])
    served, step = [np.asarray(logits, np.float32)], None
    for i in range(N_NEW):
        args = (values, cache, tok[:, PROMPT + i:PROMPT + i + 1], np.int32(PROMPT + i))
        step = step or dec.lower(*args).compile(compiler_options=NO_EXCESS)
        logits, cache = step(*args)
        served.append(np.asarray(logits, np.float32))
    return float(loss), jax.tree.map(np.asarray, grads), served


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The 2 x 2 run's readings by arch, beside the one-rank port's and
    the reference's on the same weights and batch."""
    root = tmp_path_factory.mktemp("mesh")
    values, perturbed, rcfgs, refs, ones = {}, {}, {}, {}, {}
    for arch in FAMILIES:
        rcfgs[arch], values[arch] = _values(arch)
        perturbed[arch] = _perturbed(values[arch])
    for arch in ARCHS:  # the 1 x 1 checkpoints, which the ranks read
        ones[arch] = _one_rank(arch, values[arch], root)
    # the weights go by file: a spawned process takes its arguments only
    # once it has imported this module, and the parent would wait for each
    with open(root / "values.pkl", "wb") as f:
        pickle.dump((values, perturbed), f)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, root, queue))
             for r in range(4)]
    for p in procs:
        p.start()
    try:  # while the ranks run: the one rank's and the reference's readings
        for arch in FAMILIES:
            if arch not in ones:
                ones[arch] = _one_rank(arch, values[arch], root)
            refs[arch] = _reference(rcfgs[arch], values[arch])
        with _compute_in(torch.float64):
            exact = {arch: _exact(configs.get(arch).reduced(), perturbed[arch], None, None)
                     for arch in FAMILIES}
        got = queue.get(timeout=600)
    finally:
        for p in procs:
            p.join(120)
    assert all(p.exitcode == 0 for p in procs)
    return {"root": root, "mesh": got, "ref": refs, "one": ones, "values": values,
            "exact_one": exact}


def _grads_close(got, want, rtol, rtol_all=None):
    """Each gradient of `got` (name -> array) within `rtol` of its norm
    in `want` (name -> tensor), plus a floor of 1e-6 of the global norm
    for gradients that vanish; with `rtol_all`, all together too."""
    total = float(opt_lib.global_norm(want.values()))
    diff = 0.0
    for name, w in want.items():
        g = torch.as_tensor(got[name]).reshape(w.shape).to(w.dtype)
        err = float((g - w).norm())
        diff += err ** 2
        assert err <= rtol * float(w.norm()) + 1e-6 * total, (name, err, float(w.norm()))
    if rtol_all is not None:
        assert diff ** 0.5 <= rtol_all * total, (diff ** 0.5, total)


@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh_loss_and_grads_equal_one_rank_and_reference(mesh_run, arch):
    got = mesh_run["mesh"][arch]
    loss1, g1, cfg = mesh_run["one"][arch][:3]
    np.testing.assert_allclose(got["loss"], loss1, rtol=1e-4)
    _grads_close(got["grads"], {n: g.detach() for n, g in g1.items()},
                 GRAD_RTOL.get(arch, 0.02), GRAD_ALL.get(arch))
    loss_r, grads_r = mesh_run["ref"][arch][:2]
    np.testing.assert_allclose(got["loss"], loss_r, rtol=1e-3)
    want = {n: torch.zeros_like(g) for n, g in g1.items()}
    convert.load_reference_tree(cfg, want, grads_r)
    _grads_close(got["grads"], want, GRAD_RTOL.get(arch, 0.05), 0.05)


@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh_serving_equals_one_rank_and_reference(mesh_run, arch):
    """Prefill and three decode steps (flash-decoding across the cache's
    time shards): the logits against the one-rank port's and the
    reference's."""
    (got, _), (one, _) = mesh_run["mesh"][arch]["serve"], mesh_run["one"][arch][5]
    want = mesh_run["ref"][arch][2]
    assert len(got) == len(one) == len(want) == 1 + N_NEW
    for g, o, w in zip(got, one, want):
        np.testing.assert_allclose(g, o, **MODEL_TOL)
        np.testing.assert_allclose(g, w, **MODEL_TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh_computes_the_one_rank_function_in_f64(mesh_run, arch):
    """With the compute type f64 on both sides, the mesh's loss,
    gradients, prefill caches and logits, and its parameters and moments
    after two train steps, equal the one rank's."""
    got, one = mesh_run["mesh"][arch]["exact"], mesh_run["exact_one"][arch]
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-6)
    _grads_close(got["grads"], {n: torch.from_numpy(g) for n, g in one["grads"].items()},
                 1e-3)
    assert got["state"].keys() == one["state"].keys()
    for name, (p, m, v) in one["state"].items():
        gp, gm, gv = (a.reshape(b.shape) for a, b in zip(got["state"][name], (p, m, v)))
        assert np.linalg.norm(gp - p) <= 5e-5 * np.linalg.norm(p), name
        for a, b in ((gm, m), (gv, v)):
            assert np.linalg.norm(a - b) <= 1e-3 * np.linalg.norm(b) + 1e-12, name
    (logits, caches), (logits1, caches1) = got["serve"], one["serve"]
    for a, b in zip(logits, logits1):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    for c, c1 in zip(caches, caches1):
        assert c.keys() == c1.keys()
        for k in c:
            np.testing.assert_allclose(c[k], c1[k], rtol=0, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_reshard_bitwise(mesh_run, arch):
    """2 x 2 -> 1 x 1: the port's one-rank restore of the mesh's
    checkpoint equals the mesh's gathered state bitwise; 1 x 1 -> 2 x 2:
    checked on the ranks (every array placed, whole == the file)."""
    got = mesh_run["mesh"][arch]
    assert got["back_bitwise"] and got["back_sharded"]
    _, _, cfg, model, opt, _ = mesh_run["one"][arch]
    path = ckpt.latest(mesh_run["root"] / arch / "mesh")
    restored = ckpt.restore(path, loop_lib.state_trees(cfg, model, opt))
    flat = dict(ckpt._leaves(_host_tree(restored)))
    want = dict(ckpt._leaves(got["state"]))
    assert flat.keys() == want.keys()
    for k, v in want.items():
        assert np.array_equal(flat[k], v), k


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_restores_mesh_checkpoint(mesh_run, arch):
    values = mesh_run["values"][arch]
    path = ckpt.latest(mesh_run["root"] / arch / "mesh")
    template = {"params": values,
                "opt": {"m": values, "v": values, "step": np.int32(0)}}
    out = ref_ckpt.restore(path, template)
    want = dict(ckpt._leaves(mesh_run["mesh"][arch]["state"]))
    for k, v in ckpt._leaves(jax.tree.map(np.asarray, out)):
        assert np.array_equal(v, want[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_live_collective_bytes_equal_fake_mesh(mesh_run, arch):
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = configs.get(arch).reduced()
    with mesh_lib.fake_world(4):
        rules = sharding.train_rules(mesh_lib.make_host_mesh(2, 2, device_type="cpu"))
        with sharding.axis_rules(rules), implicit_replication():
            tr, _ = dryrun._trace(cfg, Shape("mesh", "train", S, B), rules)
    live = mesh_run["mesh"][arch]["coll"]
    assert live and live == dict(tr.cost.collective_bytes)


# ------------------------------------------------------------------ #
# the launcher under torchrun
# ------------------------------------------------------------------ #
def test_launcher_torchrun_fails_and_resumes(tmp_path):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
           "--arch", "qwen2-0.5b", "--smoke", "--steps", "3", "--device", "cpu",
           "--data-par", "2", "--model-par", "2", "--global-batch", "4",
           "--seq", "32", "--ckpt-every", "1", "--ckpt-dir", str(tmp_path / "ck")]
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    env.pop("WORLD_SIZE", None)
    first = subprocess.run(cmd + ["--fail-at", "2"], capture_output=True,
                           text=True, env=env, timeout=300)
    assert first.returncode != 0 and "InjectedFailure" in first.stderr + first.stdout
    second = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
    assert second.returncode == 0, second.stderr[-2000:]
    assert "[resume] step 2" in second.stdout
    assert "on a 2 x 2 mesh" in second.stdout
