"""internvl2-2b [vlm] — InternLM2 decoder; InternViT frontend STUBBED
(input_specs feeds (B, 256, d) patch embeddings) [arXiv:2404.16821]."""
from ...models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=8192, vocab_size=92553,
    activation="swiglu", tie_embeddings=True,
    num_patches=256,
    source="arXiv:2404.16821",
)
