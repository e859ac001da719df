"""qwen2-0.5b [dense]: 24L d=896 14H (GQA kv=2) d_ff=4864 vocab=151936,
QKV bias, tied embeddings [arXiv:2407.10671; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv=2,
    d_ff=4864,
    vocab=151936,
    pattern=("attn",),
    qkv_bias=True,
    tied_embeddings=True,
    rope_theta=1e6,
)
