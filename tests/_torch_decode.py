"""The reference's decode and the port's, teacher-forced on the same tokens
with the same weights — shared by the ``tests/test_torch_decode_*.py``
files, which split the ten architectures so that none jits many.

:func:`check_arch` carries the reference's ``init_model(PRNGKey(0))`` (the
reduced config) into the port with ``params_from_numpy`` and runs the
reference's jitted ``decode_step`` (:class:`RefSide`) and the port's on
the CPU (``PortSide``) in lockstep through ``repro_torch.analysis.lockstep``,
the comparison core the card checks share, twice: in float32 (both
packages' compute dtype float32: the algorithm) and in bfloat16 (the
working type).  Each run is held to ``lockstep.faults`` at
``lockstep.tolerance``: kpos bitwise, logits and every state leaf within
the run's limit of scale at every step, greedy tokens equal where the
reference's top-2 margin is clear; in bf16 an MoE step is excused where
the port's router had a near-tie, and the hybrid family's numbers are
reported, not held (the reasons in that module).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.models.backbone as ref_backbone
import repro.models.decode as ref_decode
from repro.configs import get_config as ref_get_config
from repro.models import init_model as ref_init_model
from repro_torch.configs import get_config
from repro_torch.analysis import lockstep as LS
from repro_torch.models import cast_compute, params_from_numpy

B = 2


def tokens(cfg, steps, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(steps, B, 1),
                                                dtype=np.int32)


@contextlib.contextmanager
def compute_dtype(name):
    """The reference's compute dtype (its module constant) set to ``name``
    ("bfloat16", the working type, or "float32") for a run; the port takes
    its dtype as an argument."""
    saved = [(m, m.COMPUTE_DTYPE) for m in (ref_backbone, ref_decode)]
    for m in (ref_backbone, ref_decode):
        m.COMPUTE_DTYPE = getattr(jnp, name)
    try:
        yield
    finally:
        for m, v in saved:
            m.COMPUTE_DTYPE = v


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32))
                        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


class RefSide:
    """The reference's jitted ``decode_step`` as a lockstep side."""

    margin = np.inf

    def __init__(self, ref_cfg, ref_params, steps):
        self.params = ref_params
        self.fn = jax.jit(lambda p, s, t, pos: ref_decode.decode_step(p, ref_cfg, s, t, pos))
        self.state = ref_decode.init_decode_state(ref_cfg, B, steps)

    def step(self, p, toks):
        lg, self.state = self.fn(self.params, self.state, jnp.asarray(toks), jnp.int32(p))
        return np.asarray(lg.astype(jnp.float32))[:, 0], _np(self.state)


def run(arch, name, steps=44, ref_params=None):
    """The lockstep report of ``arch`` (reduced) in ``name`` ("float32" or
    "bfloat16"): the reference against the port on the CPU."""
    ref_cfg = ref_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    assert cfg == type(cfg)(**{f: getattr(ref_cfg, f) for f in cfg.__dataclass_fields__})
    if ref_params is None:
        ref_params = jax.jit(ref_init_model, static_argnums=1)(jax.random.PRNGKey(0), ref_cfg)
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    dtype = getattr(torch, name)
    with compute_dtype(name):
        port = LS.PortSide(cfg, cast_compute(params, dtype), "cpu", B, steps)
        rep = LS.lockstep(RefSide(ref_cfg, ref_params, steps), port, tokens(cfg, steps),
                          LS.tolerance(cfg, dtype), hold=LS.holds_numbers(cfg, dtype),
                          route_tol=LS.ROUTE_TOL if dtype == torch.bfloat16 else None)
    return rep, port.state


def check_arch(arch, steps=44):
    """Both runs of ``arch``, each held to ``lockstep.faults``: ({dtype:
    greedy tokens held equal}, the port's bf16 state after the last step)."""
    ref_cfg = ref_get_config(arch).reduced()
    ref_params = jax.jit(ref_init_model, static_argnums=1)(jax.random.PRNGKey(0), ref_cfg)
    held = {}
    for name in ("float32", "bfloat16"):
        rep, state = run(arch, name, steps, ref_params)
        assert not LS.faults(rep), f"{arch} {name}: {LS.faults(rep)}"
        held[name] = rep["greedy_clear"] if rep["hold"] else 0
    return held, state


if __name__ == "__main__":
    # the largest readings of each run, against which the limits are set:
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_decode.py zamba2-2.7b [float32]
    import json
    import sys

    for name in sys.argv[2:] or ("float32", "bfloat16"):
        rep, _ = run(sys.argv[1], name)
        print(json.dumps({"arch": sys.argv[1], "dtype": name, "logits": max(rep["logit_err"]),
                          "state": max(rep["state_err"]), "worst_leaf": rep["worst_leaf"],
                          "flipped": rep["flipped"], "tol": rep["tol"], "held": rep["hold"],
                          "faults": LS.faults(rep)}))
