"""Model configuration for the architecture zoo — counterpart of
``repro/models/config.py``, copied field for field.

One dataclass covers the six assigned families (dense / moe / ssm / hybrid /
audio enc-dec / vlm); family-specific fields are ignored elsewhere.  Configs
are plain frozen dataclasses so they hash and can key jit caches.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm

    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads

    # attention features
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None
    local_global_alternating: bool = False  # gemma2: even layers local window
    attn_logit_softcap: Optional[float] = None  # gemma2: 50.0
    final_logit_softcap: Optional[float] = None  # gemma2: 30.0

    # mlp
    activation: str = "swiglu"  # swiglu | geglu | gelu

    # moe
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    shared_d_ff: int = 0
    moe_dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25

    # ssm / hybrid
    ssm_state: int = 0  # mamba2 d_state
    ssm_expand: int = 2
    ssm_conv: int = 4
    xlstm_slstm_every: int = 2  # xlstm: every k-th block is sLSTM
    hybrid_attn_every: int = 0  # zamba2: shared attention every k mamba layers

    # encdec (whisper): encoder config; frontend is stubbed (frame embeddings in)
    enc_layers: int = 0
    enc_seq: int = 0

    # vlm: number of stub patch embeddings prepended to the token stream
    num_patches: int = 0

    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    embed_scale: bool = False  # gemma family scales embeddings by sqrt(d)

    # training
    remat: bool = True
    # two-level layer-scan remat: outer group count (None = flat scan).
    # NOTE: measured WORSE than flat scan + smaller microbatch on this XLA
    # (EXPERIMENTS.md §Perf B1-refuted) — kept as an option, off by default.
    remat_blocks: Optional[int] = None
    # gradient-accumulation microbatch size in global tokens (§Perf A4/B2):
    # fewer tokens/microbatch -> less live activation memory, more per-step
    # FSDP gather + grad-sync rounds.  Tuned per arch in configs/.
    train_mb_tokens: int = 131072

    # citation for the config values (paper / model card)
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.hd

    def reduced(self) -> "ModelConfig":
        """CPU-smoke-test variant: <=2 layers (pattern-preserving), d_model<=256,
        <=4 experts, tiny vocab."""
        layer_quantum = {
            "hybrid": max(self.hybrid_attn_every, 1),
            "ssm": max(self.xlstm_slstm_every, 1),
            "dense": 2 if self.local_global_alternating else 1,
        }.get(self.family, 1)
        L = max(layer_quantum, min(2, self.num_layers)) if layer_quantum <= 2 else layer_quantum
        d = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, max(1, heads // 2))
        hd = d // heads
        return dataclasses.replace(
            self,
            num_layers=L,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 4 * d) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=min(self.moe_d_ff, 2 * d) if self.moe_d_ff else 0,
            num_shared_experts=min(self.num_shared_experts, 1),
            shared_d_ff=min(self.shared_d_ff, 2 * d) if self.shared_d_ff else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
            enc_seq=min(self.enc_seq, 64) if self.enc_seq else 0,
            num_patches=min(self.num_patches, 16) if self.num_patches else 0,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else None,
            remat=False,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
