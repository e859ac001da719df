"""recurrentgemma-9b [hybrid]: 38L d=4096 16H (local-attn MQA kv=1)
d_ff=12288 vocab=256000 — Griffin pattern: 2 RG-LRU recurrent blocks per
1 local attention (window 2048) [arXiv:2402.19427; unverified]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv=1,
    d_ff=12288,
    vocab=256000,
    pattern=("rglru", "rglru", "attn"),
    window=2048,
    d_rnn=4096,
    head_dim=256,
)
