"""gemma2-2b [dense] — alternating local(4096)/global attention, logit
softcapping [arXiv:2408.00118]."""
from ...models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4,
    d_ff=9216, vocab_size=256000, head_dim=256,
    activation="geglu", embed_scale=True, tie_embeddings=True,
    sliding_window=4096, local_global_alternating=True,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    source="arXiv:2408.00118",
)
