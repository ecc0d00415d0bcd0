"""zamba2-2.7b [hybrid] — Mamba2 backbone + weight-shared attention block
every 6 layers (ssm_state 64) [arXiv:2411.15242]."""
from ...models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    activation="geglu", tie_embeddings=True,
    ssm_state=64, ssm_expand=2, ssm_conv=4, hybrid_attn_every=6,
    source="arXiv:2411.15242",
)
