"""The paper's experiment configurations (counterpart of ``repro.configs``'s
GP side)."""
from . import gp_paper  # noqa: F401
