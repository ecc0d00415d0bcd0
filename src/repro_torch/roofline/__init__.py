"""Roofline analysis of the port — counterpart of ``repro.roofline``: the
per-device cost counter (``hlo_cost``)."""
from .hlo_cost import COLLECTIVES, Cost, CostCounter, HloCost, analyze, register_bytes
