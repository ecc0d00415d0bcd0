"""gemma-7b [dense] — GeGLU, head_dim 256, MQA on the 2b sibling [arXiv:2403.08295]."""
from ...models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16,
    d_ff=24576, vocab_size=256000, head_dim=256,
    activation="geglu", embed_scale=True, tie_embeddings=True,
    source="arXiv:2403.08295",
)
