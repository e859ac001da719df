"""Model configuration + per-layer plan for the 10 assigned architectures.

A config fully describes a decoder stack as a sequence of (mixer, ffn)
blocks. Mixers: "attn" (GQA, optional sliding window), "mla" (DeepSeek
multi-head latent attention), "rglru" (Griffin recurrent block),
"mlstm"/"slstm" (xLSTM). FFNs: "dense" (SwiGLU), "moe", "none".

Layers are grouped into scan-able units (`scan_groups`): the reference
stacks a unit's weights and scans it; the port keeps the same grouping
as the order of its layer list (`models/model.py`). A copy of the
reference's `models/config.py`: the fields and methods are the same, so
that every config loads and reduces as it does there. The sharding knobs
(`gqa_broadcast`, `shard_hd`) change no number on one card; on a mesh
`shard_hd` enters the weights' logical specs (`models/sharding`) and
attention takes the `gqa_broadcast` form.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    # block pattern, cycled across layers
    pattern: Tuple[str, ...] = ("attn",)
    # attention
    qkv_bias: bool = False
    window: int = 0             # sliding-window size; 0 = full attention
    rope_theta: float = 1e4
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_expert: int = 0
    first_dense: int = 0        # leading layers that use a dense FFN
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # MLA
    kv_lora: int = 0
    qk_nope: int = 0
    qk_rope: int = 0
    v_head: int = 0
    # recurrent (RG-LRU / Griffin)
    d_rnn: int = 0
    conv_width: int = 4
    mlp_gated: bool = True      # SwiGLU (3 mats) vs GELU MLP (2 mats)
    # frontend: "tokens" embeds ids; "embeddings" takes precomputed vectors
    frontend: str = "tokens"
    tied_embeddings: bool = False
    norm_eps: float = 1e-6
    # training-time knobs
    remat: str = "full"         # full | none
    attn_chunk: int = 1024      # kv/q chunk for flash-style attention
    causal_packing: bool = True  # triangular chunk schedule (no masked-out
    #                              chunk compute); False = full masked grid
    flash_backward: bool = True  # custom-vjp flash backward for chunked
    #                              attention (False = scan-AD baseline that
    #                              stacks per-chunk residuals)
    inner_remat: bool = True     # jax.checkpoint the per-step bodies of
    #                              inner scans (sLSTM time steps, mLSTM
    #                              chunks): scan-AD then saves only the
    #                              small carries instead of stacking every
    #                              per-step intermediate
    gqa_broadcast: bool = True   # repeat K/V to n_heads so attention
    #                              shards on the q-head axis (fixes
    #                              n_kv < tp partial-sum all-reduces)
    shard_hd: bool = True        # allow sharding the head_dim axis when
    #                              n_heads % tp != 0. True (baseline) saves
    #                              weight memory but makes every attention
    #                              einsum a partial-sum all-reduce of
    #                              activation-sized tensors; False
    #                              replicates attention over the tp axis.

    # ------------------------------------------------------------------ #
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_plan(self) -> List[Tuple[str, str]]:
        """[(mixer, ffn)] for each layer."""
        plan = []
        for i in range(self.n_layers):
            mixer = self.pattern[i % len(self.pattern)]
            if mixer in ("mlstm", "slstm", "rglru_noffn"):
                ffn = "none" if self.d_ff == 0 else "dense"
            elif self.n_experts > 0 and i >= self.first_dense:
                ffn = "moe"
            else:
                ffn = "dense"
            plan.append((mixer, ffn))
        return plan

    def scan_groups(self) -> List[Tuple[List[Tuple[str, str]], int]]:
        """Greedy grouping of the layer plan into (unit, repetitions) with
        the repeating unit scanned. Returns list of (unit_plan, reps)."""
        plan = self.layer_plan()
        unit_len = len(self.pattern)
        # heterogenous leading layers (e.g. first_dense MoE layers) are
        # their own groups of reps=1
        groups: List[Tuple[List[Tuple[str, str]], int]] = []
        i = 0
        # leading non-repeating prefix
        while i < len(plan) and self.first_dense and i < self.first_dense:
            groups.append(([plan[i]], 1))
            i += 1
        # main repeated body
        unit = plan[i : i + unit_len]
        reps = 0
        j = i
        while j + unit_len <= len(plan) and plan[j : j + unit_len] == unit:
            reps += 1
            j += unit_len
        if reps:
            groups.append((unit, reps))
        # remainder
        while j < len(plan):
            groups.append(([plan[j]], 1))
            j += 1
        assert sum(len(u) * r for u, r in groups) == self.n_layers
        return groups

    # Exact parameter counts come from the model's parameter shapes
    # (models.model.param_count / active_param_count) — no analytic drift.

    # ------------------------------------------------------------------ #
    def reduced(self) -> "ModelConfig":
        """Scaled-down same-family config for CPU smoke tests."""
        pat_len = len(self.pattern)
        n_layers = max(pat_len * 2, 2) + (1 if self.first_dense else 0)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv=min(self.n_kv, 2) if self.n_kv > 1 else 1,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            d_expert=32 if self.n_experts else 0,
            kv_lora=32 if self.kv_lora else 0,
            qk_nope=16 if self.qk_nope else 0,
            qk_rope=8 if self.qk_rope else 0,
            v_head=16 if self.v_head else 0,
            d_rnn=64 if self.d_rnn else 0,
            window=min(self.window, 16) if self.window else 0,
            first_dense=min(self.first_dense, 1),
            attn_chunk=16,
            remat="none",
            # no token dropping at smoke scale: keeps prefill+decode
            # bit-consistent with the parallel forward
            capacity_factor=8.0,
        )
