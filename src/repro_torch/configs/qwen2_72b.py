"""qwen2-72b [dense]: 80L d=8192 64H (GQA kv=8) d_ff=29568 vocab=152064,
QKV bias [arXiv:2407.10671; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_ff=29568,
    vocab=152064,
    pattern=("attn",),
    qkv_bias=True,
    rope_theta=1e6,
)
