"""Engine 2: the port's source lint (twin of ``repro.analysis.lint``).

Seven rules over the port's source (``findings.RULES`` has the catalog),
in PyTorch's idiom. Python files get the AST rules and the two
legacy-surface regex rules; markdown files the regex rules only.

Suppression: append ``# neurallint: disable=RULE`` (comma-separate for
several) to the flagged line, or put it alone on the line above. A
suppression is per line and per rule; there is no file-level opt-out. The
few files that are exempt by what they are sit in ``_PATH_EXEMPT``.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterable, Optional

from .findings import Finding

#: what a default scan walks: the port's package, its example and tool
#: twins, and the card's check
DEFAULT_SCAN = ("src/repro_torch", "examples/torch_*.py", "tools/torch_*.py",
                "chip_smoke.py")

_SUPPRESS_RE = re.compile(r"#\s*neurallint:\s*disable=([A-Z0-9-,\s]+)")

# the two legacy-surface regex rules, as the reference has them
_LEGACY_FLAGS_RE = re.compile(
    r"\b(use_event_kernels|spike_format|pack_out)=(?!=)")  # neurallint: disable=NL-LEGACY-FLAGS
_LEGACY_FORKS_RE = re.compile(
    r"_apply_fused_event|_apply_fused_reference"            # neurallint: disable=NL-LEGACY-FORKS
    r"|snn_cnn\.apply(?:_fused)?\s*\(")

#: rule -> path fragments exempt from it by what the file is
_PATH_EXEMPT = {
    # the lint states the legacy patterns it polices
    "NL-LEGACY-FLAGS": ("repro_torch/analysis/", "tools/torch_neurallint.py"),
    "NL-LEGACY-FORKS": ("repro_torch/analysis/", "tools/torch_neurallint.py"),
    # call sites go through repro_torch.ops; the registry layers, the
    # static checks and the card's kernel check (which holds every
    # launcher against its plain version) import the kernels themselves
    "NL-REGISTRY-BYPASS": ("repro_torch/ops/", "repro_torch/kernels/",
                           "repro_torch/analysis/", "chip_smoke.py"),
    # the plain versions of the kernels threshold legitimately: the rule
    # polices the differentiable surface
    "NL-BARE-HEAVISIDE": ("repro_torch/kernels/",),
}


def _exempt(rule: str, path: str) -> bool:
    p = path.replace("\\", "/")
    return any(frag in p for frag in _PATH_EXEMPT.get(rule, ()))


def _suppressed(lines: list, lineno: int) -> set:
    """Rules suppressed at 1-indexed ``lineno`` (on the line, or on the
    line above when that line holds only the directive)."""
    out: set = set()
    for ln in (lineno, lineno - 1):
        if not 1 <= ln <= len(lines):
            continue
        m = _SUPPRESS_RE.search(lines[ln - 1])
        if m and (ln == lineno or lines[ln - 1].lstrip().startswith("#")):
            out.update(r.strip() for r in m.group(1).split(","))
    return out


# ------------------------------------------------------------- regex rules
def _lint_text(src: str, path: str) -> list:
    findings = []
    lines = src.splitlines()
    for rule, rx in (("NL-LEGACY-FLAGS", _LEGACY_FLAGS_RE),
                     ("NL-LEGACY-FORKS", _LEGACY_FORKS_RE)):
        if _exempt(rule, path):
            continue
        for i, line in enumerate(lines, 1):
            if rx.search(line) and rule not in _suppressed(lines, i):
                findings.append(Finding(
                    rule, path, i,
                    f"legacy surface reintroduced: {line.strip()[:80]!r}"))
    return findings


# --------------------------------------------------------------- AST rules
def _dotted(e: ast.expr) -> str:
    if isinstance(e, ast.Name):
        return e.id
    if isinstance(e, ast.Attribute):
        return f"{_dotted(e.value)}.{e.attr}"
    return ""


def _is_compile_decorator(dec: ast.expr) -> bool:
    """@torch.compile / @compile / @torch.compile(...) /
    @functools.partial(torch.compile, ...)"""
    def name(e):
        return _dotted(e).split(".")[-1]
    if name(dec) == "compile":
        return True
    if isinstance(dec, ast.Call):
        if name(dec.func) == "compile":
            return True
        if name(dec.func) == "partial" and dec.args \
                and name(dec.args[0]) == "compile":
            return True
    return False


def _is_cpu(e: Optional[ast.expr]) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(e, ast.Constant) and e.value == "cpu":
        return True
    return (isinstance(e, ast.Call) and _dotted(e.func) in ("torch.device",
                                                          "device")
            and len(e.args) == 1 and _is_cpu(e.args[0]))


_HOST_SYNC_CALLS = {"np.asarray", "np.array", "numpy.asarray",
                    "numpy.array", "torch.cuda.synchronize"}
_HOST_SYNC_METHODS = ("item", "tolist", "cpu")
_TICK_NAMES = ("tick", "route", "step_tick")
_CAST_METHODS = ("to", "float", "half", "bfloat16", "int", "type")


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, lines: list):
        self.path, self.lines = path, lines
        self.findings: list = []
        self._traced_depth = 0        # inside a compiled or per-tick body

    def _emit(self, rule: str, node: ast.AST, msg: str):
        if _exempt(rule, self.path):
            return
        line = getattr(node, "lineno", 0)
        if rule in _suppressed(self.lines, line):
            return
        self.findings.append(Finding(rule, self.path, line, msg))

    # -- imports: NL-REGISTRY-BYPASS --
    def _check_kernel_import(self, node, modname: str):
        mod = modname or ""
        if "kernels" not in mod.split("."):
            return
        # the contract module is declarations only
        if mod.endswith("kernels.contract") or mod.endswith(
                "kernels") and all(a.name == "contract"
                                   for a in getattr(node, "names", [])):
            return
        self._emit(
            "NL-REGISTRY-BYPASS", node,
            f"import of {mod!r} bypasses the policy registry: call through "
            f"repro_torch.ops so that dispatch, fallback and autotuning "
            f"stay in the loop")

    def visit_Import(self, node: ast.Import):
        for a in node.names:
            self._check_kernel_import(node, a.name)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        self._check_kernel_import(node, "." * node.level + (node.module or ""))
        self.generic_visit(node)

    # -- function defs: traced scope, mutable and CPU defaults --
    def _visit_fn(self, node):
        defaults = list(node.args.defaults) + [
            d for d in node.args.kw_defaults if d is not None]
        for default in defaults:
            if isinstance(default, (ast.List, ast.Dict, ast.Set)) or (
                    isinstance(default, ast.Call)
                    and _dotted(default.func) in ("list", "dict", "set")):
                self._emit(
                    "NL-MUTABLE-DEFAULT", default,
                    f"mutable default in {node.name}() signature: one "
                    f"instance shared by every call")
            if _is_cpu(default) and node.name != "resolve_device":
                self._emit(
                    "NL-INTERPRET-HARDCODE", default,
                    f"{node.name}() defaults to the CPU: take None and let "
                    f"the caller or resolve_device choose the device")
        traced = (any(_is_compile_decorator(d) for d in node.decorator_list)
                  or node.name in _TICK_NAMES)
        self._traced_depth += traced
        self.generic_visit(node)
        self._traced_depth -= traced

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_ClassDef(self, node: ast.ClassDef):
        for stmt in node.body:
            value = getattr(stmt, "value", None)
            if isinstance(stmt, (ast.AnnAssign, ast.Assign)) and isinstance(
                    value, (ast.List, ast.Dict, ast.Set)):
                self._emit(
                    "NL-MUTABLE-DEFAULT", stmt,
                    f"mutable class-level default in {node.name}: use "
                    f"dataclasses.field(default_factory=...)")
            if isinstance(stmt, ast.AnnAssign) and _is_cpu(value):
                self._emit(
                    "NL-INTERPRET-HARDCODE", stmt,
                    f"{node.name} defaults a field to the CPU: default it "
                    f"to None and resolve it")
        self.generic_visit(node)

    # -- calls: host syncs, bare Heavisides --
    def visit_Call(self, node: ast.Call):
        name = _dotted(node.func)
        if self._traced_depth:
            method = (node.func.attr if isinstance(node.func, ast.Attribute)
                      and not node.args else "")
            is_cast = (name in ("float", "int") and node.args
                       and not isinstance(node.args[0], ast.Constant))
            if method in _HOST_SYNC_METHODS or is_cast \
                    or name in _HOST_SYNC_CALLS:
                self._emit(
                    "NL-HOST-SYNC", node,
                    f"{name or '.' + method}() inside a compiled or "
                    f"per-tick function waits for the device on every call")
        if name == "torch.heaviside" or (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _CAST_METHODS
                and isinstance(node.func.value, ast.Compare)
                # only > / >=: a `< rate` cast is a random mask, not a
                # membrane threshold
                and all(isinstance(o, (ast.Gt, ast.GtE))
                        for o in node.func.value.ops)):
            self._emit(
                "NL-BARE-HEAVISIDE", node,
                "bare Heaviside (comparison cast): use core.surrogate.spike "
                "so that the registered pseudo-derivative flows under +grad "
                "policies")
        self.generic_visit(node)


def lint_source(src: str, path: str = "<string>") -> list:
    """Lint one Python source string. Returns the findings, suppressions
    and path exemptions applied."""
    findings = _lint_text(src, path)
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return findings + [Finding(
            "NL-REGISTRY-BYPASS", path, e.lineno or 0,
            f"unparseable Python (lint skipped): {e.msg}")]
    v = _Visitor(path, src.splitlines())
    v.visit(tree)
    return findings + v.findings


def _targets(paths: Optional[Iterable], root: Path) -> list:
    if paths:
        return [Path(p) for p in paths]
    out = []
    for pattern in DEFAULT_SCAN:
        out += sorted(root.glob(pattern)) if "*" in pattern \
            else [root / pattern]
    return out


def lint_paths(paths: Optional[Iterable] = None,
               root: Optional[Path] = None) -> tuple:
    """Lint files and directories (default: ``DEFAULT_SCAN`` under
    ``root``). Python files get the AST and regex rules, .md files the
    regex rules. Test files are out of scope (their fixtures hold every
    bad pattern). Returns (findings, files checked)."""
    root = Path(root) if root else Path.cwd()
    files: list = []
    for t in _targets(paths, root):
        if t.is_dir():
            files += sorted(t.rglob("*.py")) + sorted(t.rglob("*.md"))
        elif t.exists():
            files.append(t)
    findings, checked = [], 0
    for f in files:
        rel = str(f.relative_to(root) if f.is_absolute() and root in
                  f.parents else f)
        if "tests/" in rel.replace("\\", "/") or \
                f.name.startswith("test_"):
            continue
        checked += 1
        src = f.read_text(encoding="utf-8")
        if f.suffix == ".py":
            findings += lint_source(src, rel)
        else:
            findings += _lint_text(src, rel)
    return findings, checked
