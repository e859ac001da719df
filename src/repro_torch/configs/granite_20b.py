"""granite-20b [dense]: 52L d=6144 48H (MQA kv=1) d_ff=24576 vocab=49152,
llama-style per the assignment [arXiv:2405.04324; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv=1,
    d_ff=24576,
    vocab=49152,
    pattern=("attn",),
    mlp_gated=False,  # 2-matrix GELU FFN (gpt-bigcode style) -> ~20B total
)
