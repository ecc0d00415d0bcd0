"""Repo-rule lint of the port's source — counterpart of
``repro/analysis/lint.py``.

The op-level contracts (:mod:`.contracts`) check what a call does; this
AST pass checks the source conventions that keep those calls checkable.
Run it as::

    python -m repro_torch.analysis.lint src/repro_torch   # exit 1 on a violation

``tests/test_torch_analysis.py`` pins each rule firing on a known-bad
source and the port's tree clean.

Active rules
------------
raw-cholesky
    No ``*.linalg.cholesky`` (or ``cholesky_ex``, ``torch.cholesky``) call
    outside ``core/linalg_safe.py``: every factorization goes through
    ``chol_jittered`` / ``chol_safe``, so the jitter policy and its
    escalation live in one place (numpy / scipy host calls are exempt).
raw-eigh
    The same for ``*.linalg.eigh`` / ``eig`` (``linalg_safe.eigh_sym`` is
    the home).
local-jitter
    No module grows its own ``_JITTER`` constant or rebinds
    ``DEFAULT_JITTER``: the one value is ``linalg_safe.DEFAULT_JITTER``.
device-get-hot-path
    No host round trip — ``.item()``, ``.cpu()``, ``.tolist()``,
    ``.numpy()`` — in ``kernels/*/ops.py`` or ``core/protocols/`` outside
    the named host-sync boundaries (:data:`HOST_SYNC_BOUNDARIES`, each with
    its reason); anywhere else it would stall the host once per call.
registry-top-level
    ``register_*`` calls (and the kernel runtime's ``runtime.register``)
    run at module top level only, so one import fills a registry and a
    duplicate registration fails at import, not mid-serve.
trace-counter-encapsulation
    ``_GROWTHS``, the capacity-growth counter behind
    ``update_growth_count`` (the port's form of the reference's trace
    counters), is touched only in ``core/protocols/`` and in
    ``repro_torch/analysis`` (which snapshots and restores it); everything
    else reads ``update_growth_count`` or budgets with ``retrace_budget``.

The reference's ``xla-env-mutation`` rule does not apply: the port runs no
XLA and reads no ``XLA_FLAGS``, so there is no process-global compiler
flag whose mutation order matters.
"""
from __future__ import annotations

import ast
import dataclasses
import sys
from pathlib import Path

__all__ = ["Violation", "RULES", "HOST_SYNC_BOUNDARIES", "lint_source", "lint_file",
           "lint_paths", "main"]

# host numerics roots exempt from the factorization rules (numpy / scipy
# run on the host, carry no jitter policy, and serve the float64 oracles)
_HOST_ROOTS = {"np", "numpy", "scipy", "sp", "onp"}

# the method calls that pull a tensor to the host
_HOST_SYNC_METHODS = ("item", "cpu", "tolist", "numpy")

# the sanctioned host-sync boundaries, by path suffix and function: a host
# round trip lexically inside one of these is allowed, with its reason;
# anywhere else in the scoped files it fires
HOST_SYNC_BOUNDARIES = {
    "core/protocols/base.py": {
        "_numpy": "caller arrays and checkpoint tensors as numpy: fit entry, save, "
                  "a fit's fault plan; a request's mask is built on the device",
        "split_machines": "the fit-time random split draws on the host (CPU generator)",
        "lengths": "the artifact's integer view of its stream counts, as the "
                   "reference's ledger properties",
        "serve_health": "the degradation report is a host report, not a request",
        "_machine_index": "an update's machine index is a host int, once per update",
    },
    "core/protocols/wire.py": {
        "_corrupt_and_demote": "fit-time compaction of the CRC survivors: their counts "
                               "become the artifact's host lengths",
        "_per_symbol_run": "the fit's Theorem-1 ledger, computed on the host rates",
        "_vq_run": "the vq channel is fit in float64 on the host, as the reference's",
    },
    "kernels/quant/ops.py": {
        "_numpy": "build_scaled_tables builds the decode tables on the host in "
                  "float64, once per fit, as the reference's",
    },
}

_REGISTER_CALLS = (
    "register_kernel", "register_scheme", "register_fusion",
    "register_protocol", "register_kernel_op", "register_contract",
    "register_tune_candidates",
)
_REGISTER_DOTTED = ("runtime.register",)

_GROWTH_COUNTERS = ("_GROWTHS",)

RULES = {
    "raw-cholesky":
        "cholesky outside core/linalg_safe.py (use chol_jittered/chol_safe)",
    "raw-eigh":
        "eigh/eig outside core/linalg_safe.py (use eigh_sym)",
    "local-jitter":
        "local _JITTER constant / DEFAULT_JITTER rebinding (the one home is "
        "linalg_safe.DEFAULT_JITTER)",
    "device-get-hot-path":
        ".item()/.cpu()/.tolist()/.numpy() in kernels/*/ops.py or outside the "
        "named host-sync boundaries of core/protocols/",
    "registry-top-level":
        "register_* call below module top level (registries fill at import)",
    "trace-counter-encapsulation":
        "_GROWTHS touched outside core/protocols/ and repro_torch/analysis (use "
        "update_growth_count / retrace_budget)",
}


@dataclasses.dataclass(frozen=True)
class Violation:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


def _dotted(node) -> str:
    """``a.b.c`` for a Name/Attribute chain; '' for anything dynamic."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


@dataclasses.dataclass(frozen=True)
class _FileKind:
    """Which rule scopes apply to one file, from its path."""

    is_linalg_safe: bool
    in_kernel_ops: bool
    in_protocols: bool
    in_analysis: bool
    boundaries: dict

    @classmethod
    def of(cls, path: str) -> "_FileKind":
        p = Path(path).as_posix()
        parts = p.split("/")
        in_kernel_ops = (len(parts) >= 3 and parts[-1] == "ops.py"
                         and parts[-3] == "kernels")
        boundaries = next((set(v) for k, v in HOST_SYNC_BOUNDARIES.items()
                           if p.endswith(k)), set())
        return cls(
            is_linalg_safe=p.endswith("core/linalg_safe.py"),
            in_kernel_ops=in_kernel_ops,
            in_protocols="core/protocols/" in p,
            in_analysis="repro_torch/analysis/" in p or p.startswith("analysis/"),
            boundaries=boundaries,
        )


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, kind: _FileKind):
        self.path = path
        self.kind = kind
        self.out: list[Violation] = []
        self._func_stack: list[str] = []

    def _flag(self, node, rule: str, message: str) -> None:
        self.out.append(Violation(self.path, node.lineno, node.col_offset, rule, message))

    # -- scope tracking ----------------------------------------------------

    def visit_FunctionDef(self, node):
        self._func_stack.append(node.name)
        self.generic_visit(node)
        self._func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self._func_stack.append("<lambda>")
        self.generic_visit(node)
        self._func_stack.pop()

    # -- rules -------------------------------------------------------------

    def visit_Call(self, node):
        dotted = _dotted(node.func)
        root = dotted.split(".", 1)[0]
        tail = dotted.rsplit(".", 1)[-1]

        if not self.kind.is_linalg_safe and root not in _HOST_ROOTS:
            if dotted.endswith((".linalg.cholesky", ".linalg.cholesky_ex")) \
                    or dotted == "torch.cholesky":
                self._flag(node, "raw-cholesky",
                           f"{dotted}: factorizations go through "
                           "linalg_safe.chol_jittered/chol_safe")
            elif dotted.endswith((".linalg.eigh", ".linalg.eig")):
                self._flag(node, "raw-eigh",
                           f"{dotted}: eigendecompositions go through "
                           "linalg_safe.eigh_sym")

        if (isinstance(node.func, ast.Attribute) and node.func.attr in _HOST_SYNC_METHODS
                and root not in _HOST_ROOTS
                and (self.kind.in_kernel_ops or self.kind.in_protocols)
                and not any(f in self.kind.boundaries for f in self._func_stack)):
            where = "a kernels/*/ops.py module" if self.kind.in_kernel_ops \
                else "core/protocols/ outside the named host-sync boundaries"
            self._flag(node, "device-get-hot-path",
                       f".{node.func.attr}() in {where} (a host round trip per call)")

        if (tail in _REGISTER_CALLS or dotted in _REGISTER_DOTTED) and self._func_stack:
            self._flag(node, "registry-top-level",
                       f"{tail}() inside {self._func_stack[-1]!r}: registry "
                       "registration happens at module top level")
        self.generic_visit(node)

    def visit_Assign(self, node):
        for target in node.targets:
            self._check_store(target, node)
        self.generic_visit(node)

    def visit_AnnAssign(self, node):
        self._check_store(node.target, node)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        self._check_store(node.target, node)
        self.generic_visit(node)

    def _check_store(self, target, node):
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._check_store(elt, node)
            return
        if isinstance(target, ast.Name) and not self.kind.is_linalg_safe \
                and target.id in ("_JITTER", "DEFAULT_JITTER"):
            self._flag(node, "local-jitter",
                       f"{target.id} bound outside linalg_safe (import "
                       "linalg_safe.DEFAULT_JITTER instead)")

    def visit_ImportFrom(self, node):
        if not self.kind.is_linalg_safe:
            for alias in node.names:
                if alias.name == "_JITTER":
                    self._flag(node, "local-jitter",
                               "importing _JITTER (import linalg_safe.DEFAULT_JITTER "
                               "instead)")
                elif (node.module or "").startswith("torch") and alias.name in (
                        "cholesky", "cholesky_ex"):
                    self._flag(node, "raw-cholesky",
                               "importing cholesky from torch (use linalg_safe)")
                elif (node.module or "").startswith("torch") and alias.name in ("eigh", "eig"):
                    self._flag(node, "raw-eigh",
                               "importing eigh from torch (use linalg_safe.eigh_sym)")
        self.generic_visit(node)

    def _counter(self, node, name):
        if name in _GROWTH_COUNTERS and not (self.kind.in_protocols or self.kind.in_analysis):
            self._flag(node, "trace-counter-encapsulation",
                       f"{name} accessed outside core/protocols/ (use "
                       "update_growth_count / repro_torch.analysis.retrace_budget)")

    def visit_Name(self, node):
        self._counter(node, node.id)
        self.generic_visit(node)

    def visit_Attribute(self, node):
        self._counter(node, node.attr)
        self.generic_visit(node)


def lint_source(source: str, path: str = "<string>") -> list[Violation]:
    """Lint one source text as if it lived at ``path`` (the path decides
    which scoped rules apply; tests feed synthetic paths)."""
    tree = ast.parse(source, filename=path)
    linter = _Linter(path, _FileKind.of(path))
    linter.visit(tree)
    return sorted(linter.out, key=lambda v: (v.line, v.col, v.rule))


def lint_file(path) -> list[Violation]:
    return lint_source(Path(path).read_text(), str(path))


def lint_paths(paths) -> list[Violation]:
    """Lint files and directory trees (directories recurse over *.py)."""
    out: list[Violation] = []
    for p in paths:
        p = Path(p)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            out.extend(lint_file(f))
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="repo-rule lint of the port (serve/wire source contracts)",
    )
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to lint (default: src/repro_torch)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the active rule table and exit")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule:28s} {desc}")
        return 0
    violations = lint_paths(args.paths or ["src/repro_torch"])
    for v in violations:
        print(v)
    n = len(violations)
    print(f"{n} violation(s), {len(RULES)} active rule(s)"
          if n else f"clean ({len(RULES)} active rule(s))")
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
