"""Hand-written Hopper kernels of the port and their plain PyTorch
versions (counterpart of ``repro.kernels``).

Families — the reference's ``KERNEL_OPS`` names, each with its CUDA source
under ``csrc/``: ``gram`` (``gram.cu``), ``qgram_packed``
(``qgram_packed.cu``), ``qgram`` (``qgram.cu``, the unpacked-code API),
``quant_encode`` and ``quant_decode`` (``quant_encode.cu``,
``quant_decode.cu``), ``epilogue`` (``epilogue.cu``) and ``epilogue_fleet``
(``epilogue_fleet.cu``; the two epilogues share ``epilogue_body.cuh``) and
``decode_attn`` (``decode_attn.cu``).  :mod:`.runtime` holds the registry,
the dispatch rule and the shape sweep.  The CUDA sources are compiled at
first use (:mod:`.build`); importing this package compiles nothing.
"""
