"""The single-token GQA decode-attention kernel family (``decode_attn.cu``,
its plain version, its wrapper)."""
