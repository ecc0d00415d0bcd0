"""Hand-written Hopper kernels of the port and their plain PyTorch
versions (counterpart of ``repro.kernels``).

Families: ``gram`` (``csrc/gram.cu``), ``qgram_packed``
(``csrc/qgram_packed.cu``) and ``epilogue`` (``csrc/epilogue.cu``).  The CUDA sources are compiled at first use
(:mod:`.build`); importing this package compiles nothing.
"""
