"""repro_torch.core — the paper's protocols in PyTorch (counterpart of
``repro.core``).  The front door is ``DistributedGP(DGPConfig(...))``; the
reference's one-call entry points (``single_center_gp``, ``broadcast_gp``,
``poe_baseline``) are thin compositions over it."""
from . import quantizers, linalg_safe, torch_scheme, gp, nystrom, fusion, poe  # noqa: F401
from . import transforms, distortion, schemes, sparse_gp  # noqa: F401
from . import registry, config, protocols, api  # noqa: F401

from .api import DistributedGP
from .config import DGPConfig
from .gp import GPModel, GPParams, init_params, train_gp
from .protocols import FittedProtocol, load_artifact, save_artifact, split_machines
from .protocols.broadcast import broadcast_gp
from .protocols.center import single_center_gp
from .protocols.poe import poe_baseline
from .schemes import DimReductionScheme, OptimalScheme, PCAScheme, PerSymbolScheme
from .sparse_gp import SGPR, train_sgpr

__all__ = [
    "DistributedGP", "DGPConfig", "GPModel", "GPParams", "init_params", "train_gp",
    "FittedProtocol", "load_artifact", "save_artifact", "split_machines",
    "single_center_gp", "broadcast_gp", "poe_baseline",
    "PerSymbolScheme", "OptimalScheme", "DimReductionScheme", "PCAScheme",
    "SGPR", "train_sgpr",
]
