"""whisper-medium [audio] — enc-dec; conv/mel frontend STUBBED (input_specs
feeds (B, 1500, d) frame embeddings) [arXiv:2212.04356]."""
from ...models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=51865,
    activation="gelu", tie_embeddings=True,
    enc_layers=24, enc_seq=1500,
    source="arXiv:2212.04356",
)
