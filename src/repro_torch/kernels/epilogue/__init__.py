"""The fused serve epilogue (``csrc/epilogue.cu``) and its plain version."""
