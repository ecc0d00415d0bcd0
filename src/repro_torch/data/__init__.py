"""Synthetic data of the port (counterpart of ``repro.data``)."""
from .synthetic import (  # noqa: F401
    DATASET_SPECS, lm_batch_stream, mnist_like_two_digits, regression_dataset,
)
