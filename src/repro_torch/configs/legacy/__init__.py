"""The seed-era LLM architecture configs — counterpart of
``repro/configs/legacy``, copied value for value, ``source`` included.

These transformer / SSM / MoE configs (gemma, whisper, arctic, ...) are the
workloads of the decode-serving scaffold (``repro_torch.launch.serve``) and
are unrelated to the distributed-GP paper; the paper's own experiment
configs live one level up (``repro_torch.configs.gp_paper``).
``repro_torch.configs.get_config`` resolves names into this package.
"""
