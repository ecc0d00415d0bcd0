"""Hand-written Hopper kernels of the port and their plain PyTorch
versions (counterpart of ``repro.kernels``).

Families: ``gram`` (``csrc/gram.cu``), ``qgram_packed``
(``csrc/qgram_packed.cu``), ``epilogue`` (``csrc/epilogue.cu``) and
``epilogue_fleet`` (``csrc/epilogue_fleet.cu``; the two epilogues share
``csrc/epilogue_body.cuh``).  The CUDA sources are compiled at first use
(:mod:`.build`); importing this package compiles nothing.
"""
