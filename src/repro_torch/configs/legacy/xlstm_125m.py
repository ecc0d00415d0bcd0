"""xlstm-125m [ssm] — alternating mLSTM/sLSTM blocks [arXiv:2405.04517]."""
from ...models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    activation="gelu", tie_embeddings=True,
    xlstm_slstm_every=2,
    source="arXiv:2405.04517",
)
