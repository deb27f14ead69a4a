"""AST lint for the failure modes the port's hot paths actually have.

A port of the JAX package's ``analysis/lint.py`` with rules for eager
torch.  The rule names and the suppression syntax are the reference's:
``# analysis: allow(<rule>)`` on the flagged line, the line directly above,
or the first line (or the line above it) of the statement containing it —
every suppression carries an inline justification.

* ``host-sync`` — a device->host synchronisation inside the serving and
  search hot functions (``HOT_FUNCTIONS``): ``.item()``, ``.cpu()``,
  ``.tolist()`` or ``.numpy()`` of a tensor, ``torch.cuda.synchronize``,
  ``np.asarray``/``np.array``/``int()``/``float()``/``bool()`` of a
  tensor, and a Python ``if``/``while`` on a tensor (its ``__bool__``
  copies it to the host).  The next step of the serving path, a CUDA graph
  of the decode step, needs a step with no stray sync.
* ``tracer-branch`` — a Python ``if``/``while`` on a tensor value inside
  ``kernels/*.py`` and ``core/datapath.py``: in eager torch it is a host
  sync, and a captured CUDA graph would bake one branch in.  Reads of a
  tensor's metadata (``.shape``, ``.dtype``, ``.device``, ``.numel()``,
  ...) and host-valued torch calls (``torch.is_grad_enabled()``, ...) are
  not tensor values.
* ``float-int-path`` — float contamination in the integer golden-path
  functions (``horner_body``, ``apply_shift``, ``concat_add``,
  ``horner_int``, ``ppa_eval_ref``, and the reference's other names): true
  division, ``float()`` casts, float literals, and float dtypes
  (``torch.float32``, ``.float()``, ``.double()``, ...).  Their bodies are
  ``* + >> <<`` on integers only: the bit-exactness contract.
* ``nondet-iter`` — iteration over unordered producers (``glob``,
  ``iterdir``, ``listdir``, ``set(...)``) without ``sorted(...)`` in the
  store and compile modules, where iteration order can feed
  ``CompileJob.key()``, ``table_identity`` or a merge's result.

The per-function taint tracking is the reference's, deliberately tiny:
names assigned from an expression that calls a ``torch.`` function, or
from a call to ``decode_step``/``prefill`` (the model's entry points),
hold tensors, and tensor-ness propagates through assignments.  A call to
any other function is a taint boundary: its result is a host value (the
callee's own body is linted on its own).

:func:`golden_check` is the semantic complement of ``float-int-path``:
it traces the port's ``ppa_eval_ref`` on int32 inputs with
``torch.fx.experimental.proxy_tensor.make_fx`` and reports every node
whose output is floating.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set

__all__ = ["Finding", "lint_file", "lint_paths", "DEFAULT_LINT_TARGETS",
           "golden_check"]

_ALLOW_RE = re.compile(
    r"#.*?analysis:\s*allow\(([a-z\-]+(?:\s*,\s*[a-z\-]+)*)\)")
#: calls to names matching this return tensors (the model's entry points)
_DEVICE_CALL_RE = re.compile(r"(^|\.)(decode_step|prefill)$")
_FLOAT_DTYPE_RE = re.compile(
    r"\.(float16|float32|float64|bfloat16|float|half|double)\b")
#: tensor attributes and methods that read metadata, on the host
_METADATA = frozenset({
    "shape", "dtype", "device", "ndim", "is_cuda", "requires_grad",
    "layout", "numel", "dim", "size", "is_contiguous", "data_ptr",
    "element_size", "stride", "storage_offset", "is_floating_point"})
#: ``torch.`` calls whose result is a host value
_HOST_TORCH_CALLS = frozenset({
    "torch.is_grad_enabled", "torch.is_inference_mode_enabled",
    "torch.is_tensor", "torch.is_floating_point", "torch.is_complex",
    "torch.get_default_dtype", "torch.cuda.is_available",
    "torch.cuda.device_count", "torch.cuda.current_device",
    "torch.cuda.get_device_name", "torch.device", "torch.finfo",
    "torch.iinfo"})
#: calls that copy a tensor to the host
_SYNC_METHODS = (".item", ".cpu", ".tolist", ".numpy")
_SYNC_CONVERSIONS = ("np.asarray", "np.array", "numpy.asarray",
                     "numpy.array", "int", "float", "bool")

#: integer golden-path functions under the float-int-path contract (the
#: reference's names; the port has ``horner_body``, ``apply_shift``,
#: ``concat_add``, ``horner_int`` and ``ppa_eval_ref``)
GOLDEN_PATH_FUNCTIONS = frozenset({
    "horner_body", "apply_shift", "concat_add", "trunc_shift",
    "ppa_eval_block", "select_coeffs_sweep", "horner_int", "ppa_eval_ref",
})

#: hot functions under the host-sync contract, per file suffix: the
#: engine's admission, sampling and step, the tenant front's step, and
#: ``TorchSearchBackend``'s block functions, its flush and its dispatch
HOT_FUNCTIONS: Dict[str, Set[str]] = {
    "serve/engine.py": {"_admit", "_admit_group", "_sample_rows", "step"},
    "serve/tenants.py": {"step"},
    "core/searchspace.py": {"eval_block", "eval_block_multi",
                            "eval_block_batch", "flush", "_run"},
}

#: file scope of the tracer-branch contract: every module of ``kernels/``
_TRACED_DIR = "kernels/"
_TRACED_FILES = ("core/datapath.py",)

#: file suffixes under the nondet-iter contract
KEYED_FILE_SUFFIXES = ("compiler/store.py", "compiler/compile.py")

#: default lint scope — the port's hot and keyed files
DEFAULT_LINT_TARGETS = (
    "src/repro_torch/kernels",
    "src/repro_torch/serve/engine.py",
    "src/repro_torch/serve/tenants.py",
    "src/repro_torch/core/searchspace.py",
    "src/repro_torch/core/datapath.py",
    "src/repro_torch/compiler/store.py",
    "src/repro_torch/compiler/compile.py",
)


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def describe(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _allowed_rules(lines: Sequence[str], lineno: int,
                   spans: Sequence[tuple] = ()) -> Set[str]:
    """Suppressions active at 1-based ``lineno``: on the line itself, the
    line above, or the first line (or line above it) of the innermost
    statement containing it — so one comment covers a multi-line call."""
    candidates = {lineno, lineno - 1}
    containing = [s for s in spans if s[0] <= lineno <= s[1]]
    if containing:
        start = max(containing, key=lambda s: (s[0], -s[1]))[0]
        candidates.update({start, start - 1})
    rules: Set[str] = set()
    for ln in candidates:
        if 1 <= ln <= len(lines):
            m = _ALLOW_RE.search(lines[ln - 1])
            if m:
                rules.update(r.strip() for r in m.group(1).split(","))
    return rules


def _src(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:       # pragma: no cover - unparse failure
        return ""


class _FunctionLinter:
    """Per-function rule pass with the tiny tensor-taint dataflow."""

    def __init__(self, path: str, fn: ast.AST, rules: Set[str]):
        self.path = path
        self.fn = fn
        self.rules = rules
        self.tainted: Set[str] = set()
        self.findings: List[Finding] = []

    def _emit(self, node: ast.AST, rule: str, message: str):
        self.findings.append(Finding(self.path, node.lineno, rule, message))

    def is_tensor(self, node: ast.AST) -> bool:
        """Does this expression evaluate to a tensor?

        A call is a taint boundary: it is tensor-valued iff its callee is
        a ``torch.`` function other than a host-valued one, a
        ``decode_step``/``prefill`` entry point, a tainted local, or a
        method (other than a metadata read) of a tensor.  Metadata reads
        (``x.shape``, ``x.device.type``, ``x.numel()``) and bare ``torch.``
        attributes (``torch.bool``) are host values."""
        if isinstance(node, ast.Call):
            callee = _src(node.func)
            if callee.startswith("torch."):
                return callee not in _HOST_TORCH_CALLS
            if _DEVICE_CALL_RE.search(callee):
                return True
            if isinstance(node.func, ast.Name):
                return node.func.id in self.tainted
            if isinstance(node.func, ast.Attribute):
                return (node.func.attr not in _METADATA
                        and self.is_tensor(node.func.value))
            return False
        if isinstance(node, ast.Attribute):
            if node.attr in _METADATA:
                return False
            if isinstance(node.value, ast.Name) and node.value.id == "torch":
                return False
            return self.is_tensor(node.value)
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Lambda):
            return False
        if isinstance(node, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return False        # identity, never the tensor's __bool__
        return any(self.is_tensor(c) for c in ast.iter_child_nodes(node))

    def _taint_targets(self, targets: Iterable[ast.AST]):
        # only plain-name (and unpacked-tuple) targets: a store to
        # self.attr / x[i] must NOT taint `self` / `x` themselves
        stack = list(targets)
        while stack:
            t = stack.pop()
            if isinstance(t, ast.Name):
                self.tainted.add(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                stack.extend(t.elts)
            elif isinstance(t, ast.Starred):
                stack.append(t.value)

    def taint(self) -> None:
        """Tensor taint to a fixpoint (ast.walk is not source-ordered, so
        a single pass could check a use before its def taints it)."""
        changed = True
        while changed:
            changed = False
            for node in ast.walk(self.fn):
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) \
                        and node.value is not None:
                    targets, value = [node.target], node.value
                else:
                    continue
                if self.is_tensor(value):
                    before = len(self.tainted)
                    self._taint_targets(targets)
                    changed |= len(self.tainted) != before

    def run(self) -> List[Finding]:
        self.taint()
        for node in ast.walk(self.fn):
            if "host-sync" in self.rules:
                self._check_host_sync(node)
            if "float-int-path" in self.rules:
                self._check_float(node)
            if "tracer-branch" in self.rules:
                self._check_branch(node)
        return self.findings

    def _check_host_sync(self, node: ast.AST):
        if isinstance(node, ast.Call):
            callee = _src(node.func)
            if callee.endswith(_SYNC_METHODS) \
                    and isinstance(node.func, ast.Attribute) \
                    and self.is_tensor(node.func.value) \
                    and not _src(node.func.value).endswith(".cpu()"):
                # (``x.cpu().numpy()`` syncs once, at the ``.cpu()``)
                self._emit(node, "host-sync",
                           f"`{_src(node)[:60]}` syncs device->host")
            elif callee == "torch.cuda.synchronize":
                self._emit(node, "host-sync", f"`{callee}` blocks on the "
                           "device")
            elif callee in _SYNC_CONVERSIONS and node.args \
                    and self.is_tensor(node.args[0]):
                self._emit(node, "host-sync",
                           f"`{callee}(...)` of a tensor syncs device->host")
        elif isinstance(node, (ast.If, ast.While)) \
                and self.is_tensor(node.test):
            self._emit(node, "host-sync",
                       "branching on a tensor syncs via __bool__")

    def _check_branch(self, node: ast.AST):
        if isinstance(node, (ast.If, ast.While)) \
                and self.is_tensor(node.test):
            self._emit(node, "tracer-branch",
                       "Python branch on a tensor value: a host sync, and "
                       "one branch baked into a captured graph")

    def _check_float(self, node: ast.AST):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            self._emit(node, "float-int-path",
                       "true division produces floats in an integer "
                       "golden path")
        elif isinstance(node, ast.Call) and _src(node.func) == "float":
            self._emit(node, "float-int-path",
                       "float() cast in an integer golden path")
        elif isinstance(node, ast.Constant) and isinstance(node.value, float):
            self._emit(node, "float-int-path",
                       f"float literal {node.value!r} in an integer "
                       "golden path")
        elif isinstance(node, ast.Attribute) \
                and _FLOAT_DTYPE_RE.search("." + node.attr):
            self._emit(node, "float-int-path",
                       f"float dtype `.{node.attr}` in an integer "
                       "golden path")


def _iter_functions(tree: ast.Module):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _check_nondet_iter(path: str, tree: ast.Module) -> List[Finding]:
    findings = []
    unordered = {"glob", "iglob", "iterdir", "listdir", "set"}
    for node in ast.walk(tree):
        if not isinstance(node, (ast.For, ast.comprehension)):
            continue
        it = node.iter
        if isinstance(it, ast.Call):
            callee = _src(it.func)
            name = callee.rsplit(".", 1)[-1]
            if name in unordered:
                line = getattr(node, "lineno", it.lineno)
                findings.append(Finding(
                    path, line, "nondet-iter",
                    f"iterating `{callee}(...)` without sorted() — order "
                    "may feed cache keys / merge results"))
    return findings


def _rel(posix: str) -> str:
    for root in ("src/repro_torch/", "repro_torch/"):
        if root in posix:
            return posix.split(root)[-1]
    return posix


def lint_file(path: str | Path) -> List[Finding]:
    """Lint one python file with every rule whose scope matches it."""
    path = Path(path)
    src = path.read_text()
    lines = src.splitlines()
    tree = ast.parse(src, filename=str(path))
    rel = _rel(path.as_posix())

    findings: List[Finding] = []
    hot = next((fns for suf, fns in HOT_FUNCTIONS.items()
                if rel.endswith(suf)), set())
    traced = rel.startswith(_TRACED_DIR) or f"/{_TRACED_DIR}" in rel \
        or rel.endswith(_TRACED_FILES)

    for fn in _iter_functions(tree):
        rules: Set[str] = set()
        if fn.name in hot:
            rules.add("host-sync")
        if fn.name in GOLDEN_PATH_FUNCTIONS:
            rules.add("float-int-path")
        if traced:
            rules.add("tracer-branch")
        if rules:
            findings.extend(_FunctionLinter(str(path), fn, rules).run())

    if rel.endswith(KEYED_FILE_SUFFIXES):
        findings.extend(_check_nondet_iter(str(path), tree))

    # a nested function is walked with its parent too: one finding a site
    findings = list(dict.fromkeys(findings))
    spans = [(n.lineno, n.end_lineno or n.lineno)
             for n in ast.walk(tree)
             if isinstance(n, ast.stmt) and hasattr(n, "lineno")]
    return [f for f in findings
            if f.rule not in _allowed_rules(lines, f.line, spans)]


def lint_paths(paths: Optional[Sequence[str | Path]] = None,
               root: Optional[Path] = None) -> List[Finding]:
    """Lint files/directories (default: ``DEFAULT_LINT_TARGETS``)."""
    root = root or Path.cwd()
    targets = [Path(p) for p in (paths or DEFAULT_LINT_TARGETS)]
    findings: List[Finding] = []
    for t in targets:
        t = t if t.is_absolute() else root / t
        files = sorted(t.rglob("*.py")) if t.is_dir() else [t]
        for f in files:
            if f.exists():
                findings.extend(lint_file(f))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def golden_check(fn=None, shape=(8,)) -> List[str]:
    """Trace the integer golden path and return its floating nodes.

    Complements the AST rule with a semantic check: ``fn(x_int, starts,
    coefs, plan)`` (default: the port's ``ppa_eval_ref``) is traced on
    int32 inputs with ``make_fx``, and every node whose output carries a
    floating dtype is reported as ``"<target>: <dtype>"`` (empty =
    clean).  The plain-call counter ``ppa_eval_ref`` keeps is left as it
    was."""
    import torch
    from torch.fx.experimental.proxy_tensor import make_fx

    from ..core.datapath import DatapathPlan, FWLConfig
    from ..kernels import ref

    fn = fn or ref.ppa_eval_ref
    plan = DatapathPlan.from_config(
        FWLConfig(w_in=7, w_out=7, w_a=(7,), w_o=(7,), w_b=7))
    x = torch.zeros(shape, dtype=torch.int32)
    starts = torch.tensor([0, 4], dtype=torch.int32)
    coefs = torch.zeros((2, 2), dtype=torch.int32)      # (S, n+1)
    plain = ref.counts["plain"]
    try:
        gm = make_fx(lambda xx, s, c: fn(xx, s, c, plan))(x, starts, coefs)
    finally:
        ref.counts["plain"] = plain
    bad = []
    for node in gm.graph.nodes:
        val = node.meta.get("val")
        if isinstance(val, torch.Tensor) and val.dtype.is_floating_point:
            bad.append(f"{node.target}: {val.dtype}")
    return bad
