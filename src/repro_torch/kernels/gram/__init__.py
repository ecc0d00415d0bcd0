"""The tiled gram kernel family (``gram.cu``, its plain version, its wrapper)."""
