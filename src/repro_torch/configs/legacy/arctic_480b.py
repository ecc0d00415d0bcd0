"""arctic-480b [moe] — 128 experts top-2 + dense residual branch
[hf:Snowflake/snowflake-arctic-base]."""
from ...models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32000,
    activation="swiglu", tie_embeddings=False,
    num_experts=128, top_k=2, moe_d_ff=4864, moe_dense_residual=True,
    train_mb_tokens=262144,  # §Perf A4: fewer grad-sync rounds (collective-bound)
    source="hf:Snowflake/snowflake-arctic-base",
)
