"""Runnable examples of the port (counterparts of the repository's
``examples/quickstart.py`` and ``examples/distributed_gp_sarcos.py``); each
runs as ``python -m repro_torch.examples.<name>`` on the card, or with
``--device cpu``."""
