"""deepseek-v2-lite-16b [moe]: 27L d=2048 16H MLA(kv_lora=512) vocab=102400,
MoE 64 routed top-6 + 2 shared (d_expert=1408), first layer dense
[arXiv:2405.04434; hf]. NOTE: the assignment line also says "160 routed"
(that is DeepSeek-V3); we follow the leading "64e top-6" spec which matches
the HF config of V2-Lite (see DESIGN.md §Arch-applicability)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=10944,          # the single dense layer's FFN
    vocab=102400,
    pattern=("mla",),
    n_experts=64,
    top_k=6,
    n_shared=2,
    d_expert=1408,
    first_dense=1,
    kv_lora=512,
    qk_nope=128,
    qk_rope=64,
    v_head=128,
    head_dim=192,        # qk_nope + qk_rope
    rope_theta=1e4,
)
