"""stablelm-12b [dense] [hf:stabilityai/stablelm-2-12b]."""
from ...models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=13824, vocab_size=100352,
    activation="swiglu", tie_embeddings=False,
    source="hf:stabilityai/stablelm-2-1_6b",
)
