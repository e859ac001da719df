"""llava-next-34b [vlm]: 60L d=7168 56H (GQA kv=8) d_ff=20480 vocab=64000
[hf:llava-hf/llava-v1.6; unverified]. The anyres vision frontend is a
STUB: input_specs() supplies merged patch+token embeddings (B, S, d)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv=8,
    d_ff=20480,
    vocab=64000,
    pattern=("attn",),
    frontend="embeddings",
)
