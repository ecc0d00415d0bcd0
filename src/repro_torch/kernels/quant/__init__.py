"""The per-symbol quantizer kernel families ``quant_encode`` and
``quant_decode`` (``quant_encode.cu``, ``quant_decode.cu``, their plain
versions, their wrappers)."""
