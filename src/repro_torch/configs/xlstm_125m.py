"""xlstm-125m [ssm]: 12L d=768 4H, sLSTM + mLSTM blocks (3 mLSTM : 1 sLSTM,
following the paper's mostly-mLSTM ratios), d_ff=0 (projections live in
the blocks) [arXiv:2405.04517; unverified]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv=4,
    d_ff=0,
    vocab=50304,
    pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    tied_embeddings=True,
)
