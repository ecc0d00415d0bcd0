"""mistral-large-123b [dense] [hf:mistralai/Mistral-Large-Instruct-2407]."""
from ...models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense",
    num_layers=88, d_model=12288, num_heads=96, num_kv_heads=8,
    d_ff=28672, vocab_size=32768, head_dim=128,
    activation="swiglu", tie_embeddings=False,
    train_mb_tokens=65536,  # §Perf B2: 60 -> 34 GB/device on train_4k
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)
