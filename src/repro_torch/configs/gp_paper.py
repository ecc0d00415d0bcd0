"""The paper's own experiment configurations (§6) — counterpart of
``repro/configs/gp_paper.py``, the same data objects field by field, for
the port's figure scripts (``repro_torch.launch``).

Each entry fixes: dataset (paper scale), machine count, kernel, rate sweep and
the zero-rate baselines, mirroring Figs. 2-7.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Optional


@dataclasses.dataclass(frozen=True)
class GPExperimentConfig:
    name: str
    figure: str
    dataset: Optional[str]  # repro_torch.data.synthetic.regression_dataset name, or None
    n_train: int
    n_machines: int
    kernel: str
    rates: Sequence[int]
    baselines: Sequence[str]
    notes: str = ""
    source: str = "arXiv Tavassolipour et al. 2017"


FIG2 = GPExperimentConfig(
    name="fig2_rate_distortion", figure="Fig. 2", dataset=None,
    n_train=4000, n_machines=2, kernel="linear",
    rates=tuple(range(5, 121, 5)), baselines=("lower_bound", "dim_reduction"),
    notes="20-d Gaussian, random covariance; distortion eq. (7)",
)

FIG4 = GPExperimentConfig(
    name="fig4_gp1d", figure="Fig. 4", dataset=None,
    n_train=200, n_machines=1, kernel="se",
    rates=tuple(range(1, 9)), baselines=("full_gp",),
    notes="1-d GP trained on quantized inputs",
)

FIG5_SARCOS = GPExperimentConfig(
    name="fig5_sarcos_linear", figure="Fig. 5a", dataset="sarcos",
    n_train=1000, n_machines=40, kernel="linear",
    rates=(2, 5, 8, 12, 16, 25, 40, 64, 100),
    baselines=("full_gp", "bcm", "rbcm"),
)

FIG6 = tuple(
    GPExperimentConfig(
        name=f"fig6_{ds}_se", figure="Fig. 6", dataset=ds,
        n_train=1000, n_machines=40, kernel="se",
        rates=(2, 5, 8, 12, 16, 25, 40, 64, 100),
        baselines=("full_gp", "bcm", "rbcm"),
    )
    for ds in ("sarcos", "kin40k", "abalone")
)

FIG7 = GPExperimentConfig(
    name="fig7_sparse_kin40k", figure="Fig. 7", dataset="kin40k",
    n_train=1000, n_machines=40, kernel="se",
    rates=(1, 2, 4, 8, 16, 32, 64), baselines=("rbcm",),
    notes="Titsias inducing points, quantized (15 per machine)",
)

ALL = (FIG2, FIG4, FIG5_SARCOS, *FIG6, FIG7)
