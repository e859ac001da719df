"""The port's accounting tier (`repro_torch.launch.{hlo,specs,dryrun,
roofline,report}`) against ground truths and the reference.

  * `hlo.analyze` counts products exactly: an L-layer loop of (B, D) x
    (D, D) products is 2·L·B·D² (the reference's scan ground truth in
    tests/test_hlo_analyzer.py), a single product 2·M·K·N; the forward of
    a reduced dense config counts the closed form of its products exactly
    and totals within 10% of the reference's `hlo.analyze` of its
    compiled forward (XLA fuses and counts its elementwise ops otherwise
    than the port's eager aten ops: 3.1–3.5% apart on the reduced dense
    configs);
  * the memory trace: the peak of live bytes of a call whose
    temporaries are known; gather's and index's backward writing into
    their zeros in place, as the program does without the counter;
  * `specs` allocate nothing (every tensor on the meta device);
  * `dryrun.run_cell` gives a record for every family — dense, MoE (its
    `bincount`, which has no meta kernel), RG-LRU, xLSTM — and kind;
  * `--mesh multi` raises;
  * `roofline.dryrun_table` and `report.replace_section` render the
    reference's text on the same records.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import hlo as jhlo
from repro.launch import report as jreport
from repro.launch import roofline as jroofline
from repro.models import model as jmodel
from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, Shape
from repro_torch.launch import dryrun, hlo, report, roofline, specs
from repro_torch.models import model as M

ENV = {"card": "test card", "power_limit": "700.00 W", "memory_bytes": 80 * 10**9,
       "hbm_bytes_per_s": 3.35e12, "bf16_flops_per_s": 989e12,
       "f32_flops_per_s": 67e12, "link_bytes_per_s": 450e9}


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_loop_products_equal_unrolled_ground_truth():
    L, B, D = 8, 64, 256
    w, x = _meta(L, D, D), _meta(B, D)

    def loop(w, x):
        h = x
        for i in range(L):
            h = torch.matmul(h.float(), w[i].float()).to(torch.bfloat16)
        return h.sum()

    cost = hlo.analyze(loop, w, x)
    assert cost.product_flops == 2 * L * B * D * D
    # + per layer the two widenings and one narrowing, and the final sum
    assert cost.flops == 2 * L * B * D * D + L * (B * D + D * D + B * D) + B * D
    assert cost.collective_total == 0 and cost.ops == 5 * L + 1


def test_single_product_exact():
    cost = hlo.analyze(lambda a, b: a @ b, _meta(128, 64, dtype=torch.float32),
                       _meta(64, 32, dtype=torch.float32))
    assert cost.product_flops == cost.flops == 2 * 128 * 64 * 32
    assert cost.hbm_bytes == 4 * (128 * 64 + 64 * 32 + 128 * 32)


def test_memory_peak_of_known_temporaries():
    n = 1 << 18  # 1 MiB of f32

    def f(x):
        y = x * 2          # +1 MiB
        z = y + 1          # +1 MiB: peak 3 MiB with x
        del y              # freed
        return z.sum()     # + 4 B

    tr = hlo.trace(f, _meta(n, dtype=torch.float32))
    assert tr.argument_bytes == 4 * n
    assert tr.peak_bytes == 3 * 4 * n
    assert tr.output_bytes == 4 and tr.alias_bytes == 0
    assert tr.temp_bytes == 2 * 4 * n - 4


@pytest.mark.parametrize("op", ["gather", "index"])
def test_backward_writes_its_zeros_in_place(op):
    """gather's and index's backward add the gradient into the zeros they
    make, as the program does without a dispatch mode: the peak holds the
    arguments and one gradient-sized buffer, not two."""
    x = torch.empty((64, 1000), device="meta", requires_grad=True)
    if op == "gather":
        idx = torch.empty((64, 1), dtype=torch.int64, device="meta")
        fn = lambda x, i: torch.autograd.grad(torch.gather(x, 1, i).sum(), x)[0]
    else:
        idx = torch.empty((50,), dtype=torch.int64, device="meta")
        fn = lambda x, i: torch.autograd.grad(x[i].sum(), x)[0]
    tr = hlo.trace(fn, x, idx)
    grad = 64 * 1000 * 4
    assert tr.output_bytes == grad
    assert grad < tr.peak_bytes - tr.argument_bytes < grad + 1024


def test_bincount_on_meta_and_attribution():
    x = torch.empty(50, dtype=torch.int64, device="meta")
    tr = hlo.trace(lambda t: torch.bincount(t, minlength=7).float() / 50, x)
    assert tr.result.shape == (7,) and tr.result.device.type == "meta"
    prof = hlo.profile(lambda a, b: (a @ b).exp().sum(),
                       _meta(32, 16, dtype=torch.float32), _meta(16, 8, dtype=torch.float32))
    assert prof["flops"][0] == ("mm", 2 * 32 * 16 * 8)
    assert {name for name, _ in prof["hbm_bytes"]} == {"mm", "exp", "sum"}
    assert prof["collective_bytes"] == []


def test_dense_forward_products_closed_form_and_reference_total():
    arch, B, S = "qwen2-0.5b", 2, 16
    cfg = configs.get(arch).reduced()
    jcfg = jconfigs.get(arch).reduced()
    assert S == cfg.attn_chunk  # one chunk pair a layer: the closed form below
    model = specs.param_specs(cfg)
    tokens = specs.batch_specs(cfg, Shape("f", "prefill", S, B))["inputs"]
    cost = hlo.analyze(lambda m, t: M.forward(m, t)[0], model, tokens)
    T, d, H, KV, hd = B * S, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    per_layer = (2 * T * d * H * hd * 2          # q and o projections
                 + 2 * T * d * KV * hd * 2       # k and v projections
                 + 3 * 2 * T * d * cfg.d_ff      # gated MLP
                 + 2 * 2 * B * H * S * S * hd)   # scores and values
    assert cost.product_flops == cfg.n_layers * per_layer + 2 * T * d * cfg.vocab

    values, _ = jmodel.abstract_params(jcfg)
    x = jax.ShapeDtypeStruct((B, S), jnp.int32)
    text = jax.jit(lambda v, t: jmodel.forward(v, t, jcfg)[0]).lower(values, x).compile().as_text()
    want = jhlo.analyze(text)
    assert cost.flops == pytest.approx(want.flops, rel=0.10)


def test_specs_allocate_nothing():
    cfg = configs.get("deepseek-v2-lite-16b")  # the published size: 15.7e9 parameters
    model = specs.param_specs(cfg)
    opt = specs.opt_specs(model)
    shape = SHAPES["decode_32k"]
    batch = specs.batch_specs(cfg, shape)
    cache = specs.cache_specs(cfg, shape)
    tok, pos = specs.decode_token_specs(cfg, shape)
    tensors = (list(model.parameters()) + list(opt["m"].values()) + [opt["step"]]
               + list(batch.values()) + [t for layer in cache for t in layer.values()]
               + [tok])
    assert all(t.device.type == "meta" for t in tensors)
    assert sum(p.numel() for p in model.parameters()) == M.param_count(cfg)
    assert batch["inputs"].shape == (128, 32768) and tok.shape == (128, 1)
    assert pos == 32767 and len(cache) == cfg.n_layers


FAMILIES = ("qwen2-0.5b", "deepseek-v2-lite-16b", "recurrentgemma-9b", "xlstm-125m")
KINDS = (Shape("train_s", "train", 32, 2), Shape("prefill_s", "prefill", 32, 2),
         Shape("decode_s", "decode", 32, 2))


@pytest.fixture(scope="module")
def records():
    return [dryrun.run_cell(arch, shape, "single", envelope=ENV,
                            cfg=configs.get(arch).reduced())
            for arch in FAMILIES for shape in KINDS]


@pytest.mark.parametrize("i", range(len(FAMILIES) * len(KINDS)))
def test_run_cell_reduced_families(records, i):
    rec = records[i]
    arch, shape = FAMILIES[i // len(KINDS)], KINDS[i % len(KINDS)]
    assert (rec["arch"], rec["shape"], rec["kind"]) == (arch, shape.name, shape.kind)
    assert not rec.get("error") and not rec.get("skipped")
    assert 0 < rec["product_flops_per_device"] <= rec["flops_per_device"]
    assert rec["hbm_bytes_per_device"] > 0 and rec["collective_bytes_per_device_total"] == 0
    assert rec["peak_bytes"] >= rec["argument_size_in_bytes"] > 0
    assert rec["fits"] and rec["card"] == "test card"
    tokens = shape.batch * (shape.seq if shape.kind != "decode" else 1)
    factor = 6 if shape.kind == "train" else 2
    assert rec["model_flops"] == factor * M.active_param_count(configs.get(arch).reduced()) * tokens
    assert rec["dominant"] in ("compute", "memory")
    assert dryrun.summary(rec).startswith(f"{arch} {shape.name} single: ")


def test_skipped_cell_and_mesh_refusal():
    rec = dryrun.run_cell("qwen2-0.5b", "long_500k", envelope=ENV)
    assert rec["skipped"] and "sub-quadratic" in rec["reason"]
    for mesh in ("multi", "both"):
        with pytest.raises(ValueError, match="launch/mesh"):
            dryrun.run_cell("qwen2-0.5b", "train_4k", mesh, envelope=ENV)
        with pytest.raises(ValueError, match="launch/mesh"):
            dryrun.main(["--arch", "qwen2-0.5b", "--shape", "train_4k", "--mesh", mesh])


def test_tables_and_sections_equal_reference(records):
    recs = records + [dryrun.run_cell("xlstm-125m", "long_500k", envelope=ENV),
                      {"arch": "x", "shape": "train_4k", "error": True}]
    recs[-2] = dict(recs[-2], skipped=True, reason="a reason longer than sixty "
                    "characters, which both tables cut at sixty")
    assert roofline.dryrun_table(recs) == jroofline.dryrun_table(recs)
    text = "intro\n<!-- DRYRUN:BEGIN -->\nold\n<!-- DRYRUN:END -->\nrest\n"
    body = roofline.dryrun_table(recs)
    assert report.replace_section(text, "DRYRUN", body) == jreport.replace_section(
        text, "DRYRUN", body)
    table = roofline.roofline_table(recs)
    assert table.count("\n") == 1 + len(records)
    hill = roofline.pick_hillclimb(recs)
    assert len(hill) == 2 and all(not r.get("skipped") for r in hill)
    assert roofline.fmt_s(2.5) == jroofline.fmt_s(2.5) == "2.50s"
    assert roofline.fmt_s(2.5e-5) == jroofline.fmt_s(2.5e-5)
