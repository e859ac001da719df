"""h2o-danube-1.8b [dense]: 24L d=2560 32H (GQA kv=8) d_ff=6912 vocab=32000,
llama+mistral mix with sliding-window attention (W=4096)
[arXiv:2401.16818; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv=8,
    d_ff=6912,
    vocab=32000,
    pattern=("attn",),
    window=4096,
)
