"""musicgen-medium [audio]: 48L d=1536 24H (MHA kv=24) d_ff=6144 vocab=2048,
decoder-only over EnCodec tokens [arXiv:2306.05284; hf]. The EnCodec
frontend is a STUB: input_specs() supplies precomputed frame embeddings
(B, S, d); the output head predicts the 2048-entry codebook."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv=24,
    d_ff=6144,
    vocab=2048,
    pattern=("attn",),
    frontend="embeddings",
)
