"""The fused packed-words dequantize+gram kernel family (``qgram_packed.cu``)."""
