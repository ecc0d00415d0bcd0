"""qwen2-moe-a2.7b [moe] — 60 routed experts top-4 + 4 shared experts
[hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from ...models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=151936,
    activation="swiglu", tie_embeddings=True,
    num_experts=60, top_k=4, moe_d_ff=1408,
    num_shared_experts=4, shared_d_ff=5632,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
