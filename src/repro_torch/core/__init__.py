"""repro_torch.core — the paper's protocols in PyTorch (counterpart of
``repro.core``).  The front door is ``DistributedGP(DGPConfig(...))``."""
from . import quantizers, linalg_safe, torch_scheme, gp, nystrom, fusion, poe  # noqa: F401
from . import registry, config, protocols, api  # noqa: F401

from .api import DistributedGP
from .config import DGPConfig
from .gp import GPParams, init_params, train_gp
from .protocols import FittedProtocol, load_artifact, save_artifact, split_machines

__all__ = [
    "DistributedGP", "DGPConfig", "GPParams", "init_params", "train_gp",
    "FittedProtocol", "load_artifact", "save_artifact", "split_machines",
]
