"""Two decode step functions teacher-forced in lockstep on one token
sequence, and the rules that hold one to the other — the one comparison
core of the port's decode checks: the port on the CPU against the
reference (the JAX parity tests), and the port on the card against the
port on the CPU (the ``gpu`` tests and ``chip_smoke.py``).

A *side* is an object with

* ``step(p, tokens)``: one decode step at position ``p`` of ``tokens``
  ((B, 1) integer numpy) -> (logits (B, V) float32 numpy, the state as a
  nested dict of numpy arrays, bf16 leaves as float32);
* ``margin``: the least router margin of that step (``inf`` without MoE);
* ``load(state)``: go on from another side's state (only ``got`` loads).

:class:`PortSide` is the port's ``decode_step`` on a device; the
reference's side lives with the JAX parity tests.

:func:`lockstep` runs ``ref`` and ``got`` and reports how far apart they
came at each step: the logits and every state leaf as a fraction of the
``ref`` leaf's scale (max(1, max |value|)), kpos bitwise, and the greedy
tokens where ``ref``'s top-2 margin exceeds 2 ``tol`` of scale.
:func:`faults` names every rule the report breaks.  :func:`tolerance`
gives each run its limit:

* float32 (the algorithm): ``F32_TOL`` of scale, fp32 sums in other orders;
* bfloat16 (the working type): ``BF16_TOL``, 16 bf16 ulps (2^-8 each) at
  the leaf's scale: the runs round bf16 at other places (XLA fuses
  elementwise chains in fp32 and rounds at the fusion's end, PyTorch after
  each op; cuBLAS and the CPU sum in other orders), and layers and steps
  carry that.

Two discontinuities are stated, not hidden.  An MoE router's top-k choice
flips where two experts' probabilities tie within bf16 rounding: a bf16
step whose logits leave ``tol`` while either side's router margin is below
``ROUTE_TOL`` is ``flipped``, and ``got`` goes on from ``ref``'s state.
The hybrid family's mamba layers normalize y = (C.B) v per row, and the
reduced config's random weights cancel C.B up to 200-fold at a row's
first step, so rounding at the inputs' last bit moves y by O(1) of its
scale in bf16: the hybrid family's bf16 numbers are reported, not held
(:func:`holds_numbers`), and its float32 run is held to
``HYBRID_F32_TOL``, set between the largest reading of the sound runs
and the smallest of a planted fault (PERF.md, the decode path's limits).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["BF16_TOL", "F32_TOL", "HYBRID_F32_TOL", "ROUTE_TOL", "PortSide", "err_of_scale",
           "faults", "flat", "holds_numbers", "lockstep", "route_margin", "tolerance", "unflat"]

F32_TOL = 1e-4
HYBRID_F32_TOL = 5e-3  # sound runs read <= 2.4e-3, a 1 % fault in v 1.4e-2 (PERF.md)
BF16_TOL = 16 * 2.0 ** -8
ROUTE_TOL = 1e-2  # a router probability margin within reach of bf16 rounding


def tolerance(cfg, dtype) -> float:
    """The limit of a run of ``cfg`` in ``dtype`` (a torch dtype)."""
    if dtype == torch.bfloat16:
        return BF16_TOL
    return HYBRID_F32_TOL if cfg.family == "hybrid" else F32_TOL


def holds_numbers(cfg, dtype) -> bool:
    """Whether a run's logits and state leaves are held to its limit: all
    but the hybrid family's in bf16."""
    return not (cfg.family == "hybrid" and dtype == torch.bfloat16)


def flat(tree, prefix=""):
    """{"a/b/c": leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def err_of_scale(ref: np.ndarray, got: np.ndarray) -> float:
    """max |ref - got| / max(1, max |ref|)."""
    if not ref.size:
        return 0.0
    return float(np.abs(ref - got).max()) / max(1.0, float(np.abs(ref).max()))


def route_margin(aux, k: int) -> float:
    """The least gap between a token's k-th and (k+1)-th router probability
    over the MoE layers' aux dicts (``moe_apply``'s ``router_probs``): how
    near a top-k choice came to flipping."""
    gaps = []
    for a in aux:
        probs = a["router_probs"]
        if probs.shape[-1] > k:
            top = torch.topk(probs, k + 1, dim=-1).values
            gaps.append(float((top[:, k - 1] - top[:, k]).min()))
    return min(gaps, default=np.inf)


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


class PortSide:
    """The port's ``decode_step`` of ``cfg`` on ``device`` from ``params``
    (a compute-cast tree, moved to ``device``), its own state in ``dtype``
    (the params' embedding dtype)."""

    def __init__(self, cfg, params, device, batch: int, max_len: int):
        from ..models import decode_step, init_decode_state

        self.cfg, self.device = cfg, torch.device(device)
        self.params = _to(params, self.device)
        self.dtype = self.params["embedding"].dtype
        self.state = init_decode_state(cfg, batch, max_len, self.device, self.dtype)
        self.positions = torch.arange(max_len, dtype=torch.int32, device=self.device)
        self.margin = np.inf
        self._step = decode_step

    def step(self, p, tokens):
        from ..models import state_to_numpy

        aux = [] if self.cfg.family == "moe" else None
        tok = torch.from_numpy(np.ascontiguousarray(tokens)).to(self.device)
        with torch.no_grad():
            logits, self.state = self._step(self.params, self.cfg, self.state, tok,
                                            self.positions[p], moe_aux=aux)
        self.margin = route_margin(aux, self.cfg.top_k) if aux else np.inf
        return logits[:, 0].float().cpu().numpy(), state_to_numpy(self.state)

    def load(self, state):
        from ..models import state_from_numpy

        self.state = state_from_numpy(state, self.device, self.dtype)


def lockstep(ref, got, tokens, tol: float, *, hold: bool = True, route_tol=None) -> dict:
    """Teacher-force ``tokens`` ((steps, B, 1) integer numpy) through the
    sides ``ref`` and ``got``.  ``route_tol``: excuse a step whose logits
    leave ``tol`` where a router margin is below it (None: excuse none).
    Returns {"tol", "hold", "logit_err": per step, "state_err": per step
    (the worst leaf's), "worst_leaf", "flipped": excused steps,
    "tree_equal", "kpos_equal", "finite", "greedy_clear": steps x rows at
    a clear margin, "greedy_equal": of those, the ones both sides pick the
    same token at}."""
    rep = {"tol": tol, "hold": hold, "logit_err": [], "state_err": [], "worst_leaf": (None, 0.0),
           "flipped": [], "tree_equal": True, "kpos_equal": True, "finite": True,
           "greedy_clear": 0, "greedy_equal": 0}
    for p in range(tokens.shape[0]):
        rl, rs = ref.step(p, tokens[p])
        gl, gs = got.step(p, tokens[p])
        rs, gs = flat(rs), flat(gs)
        rep["finite"] &= bool(np.isfinite(gl).all()) and all(
            bool(np.isfinite(a).all()) for a in gs.values())
        if set(rs) != set(gs) or any(rs[k].shape != gs[k].shape for k in rs):
            rep["tree_equal"] = False
            break
        kpos = [k for k in rs if k.endswith("kpos")]
        rep["kpos_equal"] &= all(np.array_equal(rs[k], gs[k]) for k in kpos)
        errs = {k: err_of_scale(rs[k], gs[k]) for k in rs if k not in kpos}
        worst = max(errs, key=errs.get, default=None)
        rep["logit_err"].append(err_of_scale(rl, gl))
        rep["state_err"].append(errs[worst] if worst else 0.0)
        if worst and errs[worst] > rep["worst_leaf"][1]:
            rep["worst_leaf"] = (worst, errs[worst])
        if (route_tol is not None and rep["logit_err"][-1] > tol
                and min(ref.margin, got.margin) < route_tol):
            rep["flipped"].append(p)
            got.load(unflat(rs))
            continue
        top2 = np.sort(rl, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * tol * max(1.0, float(np.abs(rl).max()))
        same = np.argmax(rl, -1) == np.argmax(gl, -1)
        rep["greedy_clear"] += int(clear.sum())
        rep["greedy_equal"] += int((clear & same).sum())
    return rep


def unflat(flat_state):
    """The nested dict of a :func:`flat` one."""
    tree = {}
    for path, a in flat_state.items():
        *head, name = path.split("/")
        node = tree
        for h in head:
            node = node.setdefault(h, {})
        node[name] = a
    return tree


def faults(rep: dict) -> list:
    """Every rule a :func:`lockstep` report breaks, as text (empty: none)."""
    out = []
    if not rep["tree_equal"]:
        out.append("the state trees differ")
    if not rep["finite"]:
        out.append("non-finite logits or state")
    if not rep["kpos_equal"]:
        out.append("kpos differs")
    if not rep["hold"]:
        return out
    tol = rep["tol"]
    for name in ("logit_err", "state_err"):
        bad = [(p, e) for p, e in enumerate(rep[name]) if p not in rep["flipped"] and e > tol]
        if bad:
            out.append(f"{name} beyond {tol:.3e} of scale at (step, err) {bad[:4]}"
                       + (f", worst leaf {rep['worst_leaf']}" if name == "state_err" else ""))
    if rep["greedy_equal"] != rep["greedy_clear"]:
        out.append(f"greedy tokens differ at a clear margin: {rep['greedy_equal']} of "
                   f"{rep['greedy_clear']} equal")
    return out
