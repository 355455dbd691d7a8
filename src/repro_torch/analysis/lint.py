"""AST lint: the port's repo-specific rules (port of `repro.analysis.lint`,
the same rule ids where the meaning carries over).

REPRO001  magic channel-type literal: comparing a `ch_type`-ish value
          against a bare int instead of the MESH/LOCAL/GLOBAL/INJECT/
          EJECT constants (`repro_torch.core.topology`).  A literal
          silently desynchronizes if the channel-type encoding changes.
          Scope: every linted file.
REPRO002  environment read outside `src/repro_torch/__init__.py`: every
          knob goes through that module (`repro_torch.env_int`,
          `env_raw`), so the whole env surface is auditable in one file.
          Scope: src/repro_torch.
REPRO003  a host sync inside the step bodies — the torch meaning of the
          reference's rule (a Python branch on a traced value).  A step
          runs inside a captured CUDA graph, where reading a value on the
          host breaks the capture, or bakes one outcome into the replay.
          A host sync is `.item()`, `.cpu()`, `.tolist()`,
          `int(...)` / `float(...)` / `bool(...)` of a tensor expression,
          or `if` / `while` on one.  A tensor expression is one that calls
          a `torch.` function (not `torch.device`, `torch.cuda.*` or
          another host-side query) or a tensor reduction (`.sum()`,
          `.max()`, `.any()`, ... — not on `np`/`math`); `int()` of
          `x.shape[...]`, `x.size(...)`, `x.dim()`, `x.numel()` or `len()`
          reads metadata and is not a sync.  The host-side helpers that
          copy to the host on purpose are out of scope by function name
          (`HOST_FUNCTIONS`: `stats.finalize`, the sweep's `_host*`,
          `finish`, `stats_host` and `LaneSession.export`).
          Scope: src/repro_torch/core/engine.
REPRO004  `sys.path.insert` in an example script: they run as modules
          from the repo root (`python -m examples.torch_quickstart`);
          path hacks mask broken imports and break installed-package
          runs.  Scope: the port's example scripts.
REPRO005  an import of `jax`, `jaxlib` or `repro` (the reference): the
          port, its example scripts and `chip_smoke.py` run where JAX is
          not installed.  Scope: every linted file.

All rules are pure AST — no imports of the linted code, so lint runs in
milliseconds, touches no device and can't be confused by import-time
side effects.
"""
from __future__ import annotations

import ast
from pathlib import Path

from .findings import Finding

PASS = "lint"

# directories and single files linted, relative to the repo root (the
# reference's scripts beside the port's under examples/ are not the port's)
LINT_TREES = ("src/repro_torch",)
LINT_FILES = ("chip_smoke.py", "examples/torch_quickstart.py",
              "examples/torch_serve_lm.py", "examples/torch_train_lm.py")

PKG = "src/repro_torch/"
ENV_MODULE = "src/repro_torch/__init__.py"
STEP_TREE = "src/repro_torch/core/engine/"

# REPRO001: int literals that collide with the channel-type encoding
_CH_TYPE_RANGE = range(0, 5)
_CH_TYPE_HINTS = ("ch_type", "ch_typ")

# REPRO003: the host-side helpers of the engine tree, by function name
HOST_FUNCTIONS = ("finalize", "finish", "stats_host", "export")
HOST_PREFIX = "_host"
_SYNC_METHODS = ("item", "cpu", "tolist")
_CASTS = ("int", "float", "bool")
_REDUCTIONS = ("sum", "max", "min", "any", "all", "amax", "amin", "argmax",
               "argmin", "mean", "prod", "count_nonzero", "nonzero")
_HOST_ROOTS = ("np", "numpy", "math")
# torch calls that answer on the host without reading a tensor's value
_TORCH_HOST = ("torch.device", "torch.dtype", "torch.is_tensor",
               "torch.is_floating_point", "torch.finfo", "torch.iinfo",
               "torch.Size", "torch.get_default_dtype")
_TORCH_HOST_PREFIXES = ("torch.cuda.", "torch.backends.")
_METADATA = ("size", "dim", "numel")

# REPRO005: the packages the port must not import
_FORBIDDEN = ("jax", "jaxlib", "repro")


def _iter_py(root: Path):
    for tree in LINT_TREES:
        base = root / tree
        if not base.is_dir():
            continue
        for p in sorted(base.rglob("*.py")):
            if "__pycache__" in p.parts:
                continue
            yield p
    for name in LINT_FILES:
        p = root / name
        if p.is_file():
            yield p


def _rel(root: Path, path: Path) -> str:
    try:
        return path.relative_to(root).as_posix()
    except ValueError:
        return path.as_posix()


def _is_ch_literal(node) -> bool:
    return (isinstance(node, ast.Constant)
            and type(node.value) is int
            and node.value in _CH_TYPE_RANGE)


def _mentions_ch_type(node) -> bool:
    for n in ast.walk(node):
        name = None
        if isinstance(n, ast.Name):
            name = n.id
        elif isinstance(n, ast.Attribute):
            name = n.attr
        if name and any(h in name for h in _CH_TYPE_HINTS):
            return True
    return False


def _check_repro001(tree, rel, out):
    for node in ast.walk(tree):
        if not isinstance(node, ast.Compare):
            continue
        sides = [node.left] + list(node.comparators)
        lits = [s for s in sides if _is_ch_literal(s)]
        others = [s for s in sides if not _is_ch_literal(s)]
        if lits and any(_mentions_ch_type(s) for s in others):
            out.append(Finding(
                PASS, "REPRO001", "error", f"{rel}:{node.lineno}",
                f"channel type compared against magic literal "
                f"{lits[0].value}; use the MESH/LOCAL/GLOBAL/INJECT/"
                f"EJECT constants from repro_torch.core.topology"))


def _check_repro002(tree, rel, out):
    if rel == ENV_MODULE or not rel.startswith(PKG):
        return
    for node in ast.walk(tree):
        hit = None
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute):
                # os.environ.get(...) / os.getenv(...)
                if (f.attr == "get" and isinstance(f.value, ast.Attribute)
                        and f.value.attr == "environ"):
                    hit = "os.environ.get"
                elif (f.attr == "getenv"
                      and isinstance(f.value, ast.Name)
                      and f.value.id == "os"):
                    hit = "os.getenv"
        elif (isinstance(node, ast.Subscript)
              and isinstance(node.ctx, ast.Load)
              and isinstance(node.value, ast.Attribute)
              and node.value.attr == "environ"):
            hit = "os.environ[...]"
        if hit:
            out.append(Finding(
                PASS, "REPRO002", "error", f"{rel}:{node.lineno}",
                f"environment read ({hit}) outside {ENV_MODULE}; route the "
                f"knob through repro_torch.env_int so the env surface "
                f"stays auditable in one module"))


def _dotted(node) -> str:
    """`a.b.c` for an attribute chain rooted at a name, else ''."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ""
    return ".".join([node.id] + parts[::-1])


def _root_name(node) -> str:
    while isinstance(node, (ast.Attribute, ast.Call, ast.Subscript)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else ""


def _tensor_call(node) -> bool:
    """A call that yields a tensor value: a `torch.` function other than a
    host-side query, or a reduction method not on a host module."""
    if not isinstance(node, ast.Call):
        return False
    name = _dotted(node.func)
    if name.startswith("torch."):
        return not (name in _TORCH_HOST
                    or name.startswith(_TORCH_HOST_PREFIXES))
    return (isinstance(node.func, ast.Attribute)
            and node.func.attr in _REDUCTIONS
            and _root_name(node.func) not in _HOST_ROOTS)


def _is_metadata(node) -> bool:
    """`x.shape[...]`, `x.size(...)`, `x.dim()`, `x.numel()`, `len(...)`."""
    if (isinstance(node, ast.Subscript) and isinstance(node.value,
                                                       ast.Attribute)
            and node.value.attr == "shape"):
        return True
    if isinstance(node, ast.Call):
        f = node.func
        return ((isinstance(f, ast.Attribute) and f.attr in _METADATA)
                or (isinstance(f, ast.Name) and f.id == "len"))
    return False


def _tensor_expr(node) -> bool:
    return not _is_metadata(node) and any(
        _tensor_call(n) for n in ast.walk(node))


class _StepSyncs(ast.NodeVisitor):
    """REPRO003's walk: host syncs outside the host-side helpers."""

    def __init__(self):
        self.hits: list = []

    def visit_FunctionDef(self, node):
        if node.name in HOST_FUNCTIONS or node.name.startswith(HOST_PREFIX):
            return
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node):
        f = node.func
        if (isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS
                and _root_name(f) not in _HOST_ROOTS):
            self.hits.append((node.lineno, f".{f.attr}()"))
        elif (isinstance(f, ast.Name) and f.id in _CASTS
              and len(node.args) == 1 and _tensor_expr(node.args[0])):
            self.hits.append((node.lineno, f"{f.id}() of a tensor"))
        self.generic_visit(node)

    def _branch(self, node, kind):
        if _tensor_expr(node.test):
            self.hits.append((node.lineno, f"`{kind}` on a tensor"))
        self.generic_visit(node)

    def visit_If(self, node):
        self._branch(node, "if")

    def visit_While(self, node):
        self._branch(node, "while")

    def visit_IfExp(self, node):
        self._branch(node, "if")


def _check_repro003(tree, rel, out):
    if not rel.startswith(STEP_TREE):
        return
    walk = _StepSyncs()
    walk.visit(tree)
    for line, what in walk.hits:
        out.append(Finding(
            PASS, "REPRO003", "error", f"{rel}:{line}",
            f"host sync ({what}) in a step body: a captured CUDA graph "
            f"cannot hold it; keep the value on the device (torch.where, "
            f"masks) or move the read to a host-side helper"))


def _check_repro004(tree, rel, out):
    if not rel.startswith("examples/"):
        return
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if (isinstance(f, ast.Attribute) and f.attr == "insert"
                and isinstance(f.value, ast.Attribute)
                and f.value.attr == "path"
                and isinstance(f.value.value, ast.Name)
                and f.value.value.id == "sys"):
            out.append(Finding(
                PASS, "REPRO004", "error", f"{rel}:{node.lineno}",
                "sys.path.insert in an example script: run it as a "
                "module from the repo root (python -m ...) instead of "
                "patching the import path"))


def _check_repro005(tree, rel, out):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            if mod.split(".")[0] in _FORBIDDEN:
                out.append(Finding(
                    PASS, "REPRO005", "error", f"{rel}:{node.lineno}",
                    f"import of {mod}: the port, its examples and "
                    f"chip_smoke.py import torch and numpy, never jax or "
                    f"the reference package"))


_CHECKS = (_check_repro001, _check_repro002, _check_repro003,
           _check_repro004, _check_repro005)


def lint_file(path: Path, rel: str) -> list:
    try:
        tree = ast.parse(path.read_text(), filename=str(path))
    except SyntaxError as e:
        return [Finding(PASS, "REPRO000", "error",
                        f"{rel}:{e.lineno or 0}",
                        f"file does not parse: {e.msg}")]
    out: list = []
    for check in _CHECKS:
        check(tree, rel, out)
    return out


def run_lint(root: Path) -> list:
    """Lint every in-scope file under `root`; returns the findings plus
    one info summary."""
    findings: list = []
    n = 0
    for path in _iter_py(root):
        n += 1
        findings.extend(lint_file(path, _rel(root, path)))
    findings.append(Finding(
        PASS, "LINT_COVERAGE", "info", str(root),
        f"linted {n} files under {', '.join(LINT_TREES + LINT_FILES)} "
        f"({len(findings)} rule hits)"))
    return findings
