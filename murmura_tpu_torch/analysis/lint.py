# Copy of the AST engine of murmura_tpu/analysis/lint.py, its rules retargeted to torch.
"""Torch-aware AST lint engine.

Six rule classes over *round scopes* (functions that run inside the round
program every round: the aggregation protocol functions and the round
bodies marked ``# murmura: traced``, plus the functions handed to
``torch.func`` transforms) and whole-file checks:

====== ================== =====================================================
rule   name               what it catches
====== ================== =====================================================
MUR001 traced-branch      Python ``if``/``while`` on a tensor inside a round
                          scope: its implicit ``bool()`` copies the value to
                          the host and waits for the card.
MUR002 traced-assert      ``assert`` on a tensor inside a round scope — the
                          same host sync, for a check.
MUR003 host-sync          ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``,
                          ``float``/``int``/``bool`` of a tensor, ``np.*`` of
                          a tensor, ``torch.cuda.synchronize`` and ``print``
                          of a tensor inside a round scope — each a
                          device->host round trip that stalls the launch
                          queue.
MUR004 recompile-hazard   ``ops/_build.load``/``build_all`` or
                          ``torch.compile`` called inside a Python loop (a
                          build, or a fresh compile cache, per iteration),
                          and a tensor used as a ``range`` bound.
MUR005 import-time-alloc  module-scope tensor factories, ``torch.cuda.*``
                          calls and ``.cuda()``/``.to("cuda")``: CUDA
                          initialised at import breaks the spawned ranks of
                          parallel/launch.py.
MUR006 dtype-promotion    ``torch.zeros/ones/full/empty/tensor/arange``
                          without an explicit ``dtype`` combined directly
                          with round state — the float32 default widens the
                          bfloat16 rows utils/factories.py selects from 64
                          nodes up.
====== ================== =====================================================

Round scopes are found by: the aggregation protocol names (``aggregate``,
``aggregate_circulant``, ``aggregate_sparse`` — AggregatorDef's contract);
an explicit ``# murmura: traced`` marker on the ``def`` line; functions
passed by name to ``vmap``/``grad``/``torch.compile`` in the same module;
and anything lexically nested inside one of those.

Inside a round scope a forward taint pass tracks which names hold tensors:
parameters seed the set; results of calls involving tainted values
propagate it; static accessors (``.shape``, ``.dtype``, ``.size()``,
``.dim()``, ``len()``, ``is None``/``in`` comparisons, the static
AggContext fields) break it.  This keeps ``if x.shape[0] > 4`` and ``if
ctx.evidential`` legal while ``if x.sum() > 0`` is flagged.

Suppression: append ``# murmura: ignore[MUR003]`` (comma-separated ids, or
bare ``ignore`` for all rules) to the flagged line.
"""

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

RULES: Dict[str, str] = {
    "MUR000": "syntax-error",
    "MUR001": "traced-branch",
    "MUR002": "traced-assert",
    "MUR003": "host-sync",
    "MUR004": "recompile-hazard",
    "MUR005": "import-time-alloc",
    "MUR006": "dtype-promotion",
    # 1xx = cross-layer contract checks (analysis/contracts.py)
    "MUR100": "contract-import-failure",
    "MUR101": "registry-schema-sync",
    "MUR102": "per-rule-test-coverage",
    "MUR103": "topology-zero-diagonal",
    # 3xx = fault-model contracts (analysis/contracts.py)
    "MUR300": "fault-import-failure",
    "MUR301": "fault-mask-zero-diagonal",
    # 4xx = telemetry contracts (analysis/contracts.py)
    "MUR401": "telemetry-schema-migration-note",
    # 6xx = sparse exchange / population contracts (analysis/contracts.py)
    "MUR602": "sparse-population-bijections",
    # 9xx = durability contracts (analysis/contracts.py MUR900;
    # analysis/durability.py MUR901/902)
    "MUR900": "snapshot-completeness",
    "MUR901": "resume-determinism",
    "MUR902": "resume-recompile",
    # 10xx = adaptive-adversary contracts (analysis/adaptive.py; the
    # collective parity in analysis/sharded.py)
    "MUR1000": "attack-state-registry",
    "MUR1001": "adaptive-attack-recompile",
    "MUR1002": "adaptive-collective-inventory",
    # 11xx = bounded-staleness contracts (analysis/staleness.py)
    "MUR1100": "stale-state-registry",
    "MUR1101": "stale-recompile",
    "MUR1102": "stale-collective-inventory",
    # 12xx = pipelined-rounds contracts (analysis/pipeline.py)
    "MUR1200": "pipeline-state-registry",
    "MUR1201": "pipeline-recompile",
    "MUR1202": "pipeline-collective-inventory",
    # 13xx = param-axis sharding contracts (analysis/sharded.py)
    "MUR1300": "sharded-collective-inventory",
    "MUR1301": "sharded-recompile",
    "MUR1302": "sharded-bit-parity",
    "MUR1303": "sharded-execution-parity",
    # 14xx = cross-feature composition contracts (analysis/composition.py)
    "MUR1400": "manifest-bijection",
    "MUR1401": "composition-grid",
    "MUR1402": "composition-state-stages",
    # 16xx = serving contracts (analysis/serve.py)
    "MUR1600": "serve-bucket-key",
    "MUR1601": "serve-admission-recompile",
    "MUR1602": "serve-frozen-lane",
    "MUR1603": "serve-resume-completeness",
    # 17xx = observability contracts (analysis/observe.py)
    "MUR1700": "metrics-ledger-parity",
    "MUR1701": "scrape-non-interference",
    "MUR1702": "span-well-formedness",
    "MUR1703": "observability-schema-discipline",
}


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str
    # Optional machine-readable payload for `check --json`.  Excluded from
    # eq/hash so findings stay dedupable.
    data: Optional[dict] = field(default=None, compare=False)

    @property
    def name(self) -> str:
        return RULES.get(self.rule, "unknown")


# Attribute reads that yield host values even on tensors, plus the static
# fields of AggContext (aggregation/base.py) and CompressionSpec —
# branching on these is ordinary Python control flow.
STATIC_ATTRS = {
    "shape", "dtype", "ndim", "device", "is_cuda", "layout", "requires_grad",
    "itemsize", "nbytes",
    # AggContext static fields
    "evidential", "num_classes", "total_rounds", "audit",
    # CompressionSpec fields the round program branches on
    "algorithm", "error_feedback",
}

# Tensor methods whose result is a host value with no device sync.
STATIC_METHODS = {
    "size", "dim", "numel", "element_size", "stride", "is_contiguous",
    "is_floating_point", "is_complex", "data_ptr", "get_device",
}

# Callables whose function-position argument runs under a torch.func
# transform or a compiler, mapped to (positional indices, keyword names).
_FUN0 = ((0,), ("func", "fn", "f", "model"))
TRACING_CALLS: Dict[str, Tuple[Tuple[int, ...], Tuple[str, ...]]] = {
    "vmap": _FUN0, "torch.vmap": _FUN0, "torch.func.vmap": _FUN0,
    "grad": _FUN0, "torch.func.grad": _FUN0,
    "grad_and_value": _FUN0, "torch.func.grad_and_value": _FUN0,
    "torch.compile": _FUN0,
}

# Function names the repo's protocols guarantee run in the round program:
# AggregatorDef's aggregate functions (core/rounds.py calls them every round).
PROTOCOL_TRACED_NAMES = {"aggregate", "aggregate_circulant", "aggregate_sparse"}

COMPILE_NAMES = {"torch.compile"}
# Kernel builds (ops/_build.py) and compiles: a loop around one builds per
# iteration.
BUILD_NAMES = {"torch.compile", "_build.load", "_build.build_all", "build_all"}

# Tensor constructors whose dtype defaults to float32 for float data (MUR006);
# torch takes dtype as a keyword only.
F32_DEFAULT_CTORS = {
    "torch.zeros", "torch.ones", "torch.empty", "torch.full", "torch.tensor",
    "torch.arange",
}

# torch.tensor keeps a tensor operand's dtype and a bare scalar makes a
# 0-dim tensor (which does not promote); only list/tuple literals commit to
# the float32 default.
DTYPE_PRESERVING_CTORS = {"torch.tensor"}

# Module-scope calls that create tensors (and so may initialise a device).
TENSOR_FACTORIES = {
    "torch.zeros", "torch.ones", "torch.empty", "torch.full", "torch.tensor",
    "torch.arange", "torch.as_tensor", "torch.rand", "torch.randn",
    "torch.randint", "torch.eye", "torch.linspace", "torch.from_numpy",
    "torch.zeros_like", "torch.ones_like", "torch.empty_like", "torch.full_like",
}

HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
HOST_SYNC_BUILTINS = {"float", "int", "bool", "complex"}

_IGNORE_RE = re.compile(r"#\s*murmura:\s*ignore(?:\[([A-Z0-9,\s]+)\])?")
_TRACED_MARK_RE = re.compile(r"#\s*murmura:\s*traced\b")


def _dotted(node: ast.AST) -> str:
    """Dotted-name repr of a Name/Attribute chain ('' if not a plain chain)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _has_dtype(call: ast.Call) -> bool:
    return any(kw.arg == "dtype" for kw in call.keywords)


def _to_cuda(call: ast.Call) -> bool:
    """``x.cuda()`` or ``x.to("cuda"...)``/``x.to(device="cuda...")``."""
    if not isinstance(call.func, ast.Attribute):
        return False
    if call.func.attr == "cuda":
        return True
    if call.func.attr != "to":
        return False
    values = list(call.args[:1]) + [kw.value for kw in call.keywords if kw.arg == "device"]
    return any(
        isinstance(v, ast.Constant) and isinstance(v.value, str) and v.value.startswith("cuda")
        for v in values
    )


class _ModuleScanner:
    """Whole-file pass: round-scope discovery, MUR004 (build-in-loop) and
    MUR005 (import-time allocation)."""

    def __init__(self, tree: ast.Module, source_lines: List[str], path: str):
        self.tree = tree
        self.lines = source_lines
        self.path = path
        self.findings: List[Finding] = []
        self.traced_names: Set[str] = set(PROTOCOL_TRACED_NAMES)
        self.traced_lambdas: List[ast.Lambda] = []

    def emit(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 1)
        self.findings.append(Finding(rule, self.path, line, message))

    def scan(self) -> List[Finding]:
        self._collect_traced_names()
        self._scan_import_time(self.tree.body)
        self._scan_build_in_loop(self.tree)
        for fn in self._traced_roots(self.tree):
            _TaintScanner(self, fn, inherited=set()).run()
        for lam in self.traced_lambdas:
            _TaintScanner(self, _lambda_as_fn(lam), inherited=set()).run()
        # A lambda handed to vmap inside a round scope is scanned twice —
        # dedupe, keeping first-seen order.
        return list(dict.fromkeys(self.findings))

    # -- round-scope discovery ---------------------------------------------

    def _collect_traced_names(self) -> None:
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            spec = TRACING_CALLS.get(_dotted(node.func))
            if spec is None:
                continue
            positions, kw_names = spec
            fn_args = [node.args[i] for i in positions if i < len(node.args)]
            fn_args += [kw.value for kw in node.keywords if kw.arg in kw_names]
            for el in fn_args:
                if (
                    isinstance(el, ast.Call)
                    and _dotted(el.func) in {"functools.partial", "partial"}
                    and el.args
                ):
                    el = el.args[0]
                if isinstance(el, ast.Name):
                    self.traced_names.add(el.id)
                elif isinstance(el, ast.Lambda):
                    self.traced_lambdas.append(el)

    def _is_traced(self, fn: ast.FunctionDef) -> bool:
        if fn.name in self.traced_names:
            return True
        for dec in fn.decorator_list:
            if _dotted(dec) in COMPILE_NAMES:
                return True
            if isinstance(dec, ast.Call) and _dotted(dec.func) in COMPILE_NAMES:
                return True
        line = self.lines[fn.lineno - 1] if fn.lineno <= len(self.lines) else ""
        return bool(_TRACED_MARK_RE.search(line))

    def _traced_roots(self, node) -> Iterator[ast.FunctionDef]:
        """Outermost round-scope functions anywhere in the file; functions
        nested in a root are covered by the root's scan."""
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if self._is_traced(child):
                    yield child
                else:
                    yield from self._traced_roots(child)
            elif not isinstance(child, ast.Lambda):
                yield from self._traced_roots(child)

    # -- module-level checks ------------------------------------------------

    def _scan_import_time(self, body) -> None:
        """MUR005: calls executed at module import (module and class scope,
        pruning function/lambda bodies — those run later)."""

        def walk_pruned(node) -> Iterator[ast.AST]:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    import_time_exprs = (
                        child.decorator_list
                        + child.args.defaults
                        + [d for d in child.args.kw_defaults if d is not None]
                    )
                    for expr in import_time_exprs:
                        yield expr
                        yield from walk_pruned(expr)
                    continue
                if isinstance(child, ast.Lambda):
                    continue
                yield child
                yield from walk_pruned(child)

        root = ast.Module(body=list(body), type_ignores=[])
        for sub in walk_pruned(root):
            if not isinstance(sub, ast.Call):
                continue
            f = _dotted(sub.func)
            if f in TENSOR_FACTORIES or f.startswith("torch.cuda."):
                self.emit(
                    "MUR005", sub,
                    f"module-import-time call to {f}() creates a tensor or "
                    "touches CUDA at import, before parallel/launch.py's "
                    "spawned ranks pick their device — move it inside a "
                    "function",
                )
            elif _to_cuda(sub):
                self.emit(
                    "MUR005", sub,
                    "module-import-time move to CUDA initialises the card at "
                    "import, which breaks the spawned ranks of "
                    "parallel/launch.py — move it inside a function",
                )

    def _scan_build_in_loop(self, fn) -> None:
        """MUR004(a): a kernel build or torch.compile lexically inside a
        for/while body runs once per iteration."""

        def walk(node, in_loop: bool) -> None:
            for child in ast.iter_child_nodes(node):
                child_in_loop = in_loop or isinstance(child, (ast.For, ast.While))
                if isinstance(child, ast.Call) and _dotted(child.func) in BUILD_NAMES:
                    if in_loop:
                        self.emit(
                            "MUR004", child,
                            f"{_dotted(child.func)}() called inside a loop "
                            "body: each iteration builds (or compiles) "
                            "again — hoist it out of the loop",
                        )
                walk(child, child_in_loop)

        walk(fn, False)


class _TaintScanner:
    """Forward taint pass over one round-scope function (statements in
    order).  ``tainted`` holds names bound to tensors; nested function defs
    recurse with the enclosing taint plus their own params."""

    def __init__(self, module: _ModuleScanner, fn, inherited: Set[str]):
        self.m = module
        self.fn = fn
        self.tainted: Set[str] = set(inherited)
        a = fn.args
        for arg in a.posonlyargs + a.args + a.kwonlyargs:
            self.tainted.add(arg.arg)
        if a.vararg is not None:
            self.tainted.add(a.vararg.arg)
        # **kwargs holds static configuration by convention — not tainted.

    def run(self) -> None:
        self._visit_body(self.fn.body)

    # -- statements ---------------------------------------------------------

    def _visit_body(self, body) -> None:
        for stmt in body:
            self._visit_stmt(stmt)

    def _visit_stmt(self, stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _TaintScanner(self.m, stmt, inherited=set(self.tainted)).run()
            return
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = stmt.value
            t = self._expr(value) if value is not None else False
            targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            for target in targets:
                if isinstance(stmt, ast.AugAssign):
                    t = t or self._expr(target)
                self._bind(target, t)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            if self._expr(stmt.test):
                kind = "if" if isinstance(stmt, ast.If) else "while"
                self.m.emit(
                    "MUR001", stmt,
                    f"Python `{kind}` on a tensor inside a round scope — its "
                    "bool() copies the value to the host and waits for the "
                    "card; use torch.where (or test a host value)",
                )
            self._visit_body(stmt.body)
            self._visit_body(stmt.orelse)
            return
        if isinstance(stmt, ast.For):
            # Iterating a tensor slices it on the device (no sync); only a
            # tensor iterable taints the target.
            self._bind(stmt.target, self._expr(stmt.iter))
            self._visit_body(stmt.body)
            self._visit_body(stmt.orelse)
            return
        if isinstance(stmt, ast.Assert):
            if self._expr(stmt.test):
                self.m.emit(
                    "MUR002", stmt,
                    "`assert` on a tensor inside a round scope forces a host "
                    "sync every round; check it outside the round or record "
                    "it as a metric",
                )
            return
        if isinstance(stmt, (ast.Return, ast.Expr)):
            if stmt.value is not None:
                self._expr(stmt.value)
            return
        if isinstance(stmt, ast.With):
            for item in stmt.items:
                t = self._expr(item.context_expr)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, t)
            self._visit_body(stmt.body)
            return
        if isinstance(stmt, ast.Try):
            self._visit_body(stmt.body)
            for handler in stmt.handlers:
                self._visit_body(handler.body)
            self._visit_body(stmt.orelse)
            self._visit_body(stmt.finalbody)
            return
        for sub in ast.iter_child_nodes(stmt):
            if isinstance(sub, ast.expr):
                self._expr(sub)

    def _bind(self, target, tainted: bool) -> None:
        if isinstance(target, ast.Name):
            if tainted:
                self.tainted.add(target.id)
            else:
                self.tainted.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._bind(el, tainted)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, tainted)

    # -- expressions --------------------------------------------------------

    def _expr(self, node) -> bool:
        """Evaluate taint of an expression, emitting findings on the way."""
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Attribute):
            if node.attr in STATIC_ATTRS:
                self._expr(node.value)
                return False
            return self._expr(node.value)
        if isinstance(node, ast.Subscript):
            self._expr(node.slice)
            return self._expr(node.value)
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, ast.BinOp):
            lt = self._expr(node.left)
            rt = self._expr(node.right)
            self._dtype_promotion(node, lt, rt)
            return lt or rt
        if isinstance(node, ast.UnaryOp):
            return self._expr(node.operand)
        if isinstance(node, ast.BoolOp):
            return any([self._expr(v) for v in node.values])
        if isinstance(node, ast.Compare):
            ts = [self._expr(node.left)] + [self._expr(c) for c in node.comparators]
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in node.ops):
                return False
            return any(ts)
        if isinstance(node, ast.IfExp):
            self._expr(node.test)
            return self._expr(node.body) or self._expr(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any([self._expr(el) for el in node.elts])
        if isinstance(node, ast.Dict):
            return any([self._expr(v) for v in list(node.keys) + list(node.values) if v])
        if isinstance(node, ast.Starred):
            return self._expr(node.value)
        if isinstance(node, (ast.JoinedStr, ast.FormattedValue)):
            for sub in ast.iter_child_nodes(node):
                if isinstance(sub, ast.expr):
                    self._expr(sub)
            return False
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)):
            t = False
            for gen in node.generators:
                if self._expr(gen.iter):
                    t = True
                self._bind(gen.target, t)
                for cond in gen.ifs:
                    self._expr(cond)
            if isinstance(node, ast.DictComp):
                return self._expr(node.key) or self._expr(node.value) or t
            return self._expr(node.elt) or t
        if isinstance(node, ast.Lambda):
            _TaintScanner(self.m, _lambda_as_fn(node), set(self.tainted)).run()
            return False
        if isinstance(node, ast.NamedExpr):
            t = self._expr(node.value)
            self._bind(node.target, t)
            return t
        return any(
            [self._expr(sub) for sub in ast.iter_child_nodes(node) if isinstance(sub, ast.expr)]
        )

    def _call(self, node: ast.Call) -> bool:
        func = _dotted(node.func)
        arg_taints = [self._expr(a) for a in node.args]
        kw_taints = [self._expr(kw.value) for kw in node.keywords]
        any_arg_tainted = any(arg_taints) or any(kw_taints)

        if func in ("len", "isinstance"):
            return False
        if isinstance(node.func, ast.Attribute) and node.func.attr in STATIC_METHODS:
            self._expr(node.func.value)
            return False

        # MUR003: host-sync calls on tensors
        if isinstance(node.func, ast.Attribute) and node.func.attr in HOST_SYNC_METHODS:
            if self._expr(node.func.value):
                self.m.emit(
                    "MUR003", node,
                    f".{node.func.attr}() on a tensor forces a device->host "
                    "sync inside the round scope",
                )
                return False
        if func in HOST_SYNC_BUILTINS and any_arg_tainted:
            self.m.emit(
                "MUR003", node,
                f"{func}() of a tensor forces a device->host sync inside "
                "the round scope (keep it a tensor: .to(dtype))",
            )
            return False
        if func.startswith(("np.", "numpy.")) and any_arg_tainted:
            self.m.emit(
                "MUR003", node,
                f"{func}() pulls a tensor to the host inside the round "
                "scope — use the torch equivalent",
            )
            return False
        if func == "torch.cuda.synchronize":
            self.m.emit(
                "MUR003", node,
                "torch.cuda.synchronize inside a round scope waits for the "
                "card every round — synchronise once per chunk, outside",
            )
            return False
        if func == "print" and any_arg_tainted:
            self.m.emit(
                "MUR003", node,
                "print() of a tensor inside the round scope copies it to "
                "the host and waits for the card",
            )
            return False

        # MUR004(b): a tensor as a Python range bound
        if func == "range" and any_arg_tainted:
            self.m.emit(
                "MUR004", node,
                "tensor used as a range() bound — its int() is a host sync "
                "and the loop's length changes with the data; use a host "
                "value",
            )
            return False

        func_obj_tainted = isinstance(node.func, ast.Attribute) and self._expr(node.func.value)
        return func_obj_tainted or any_arg_tainted

    def _dtype_promotion(self, binop: ast.BinOp, lt: bool, rt: bool) -> None:
        """MUR006: dtype-less float32-default constructor as a direct
        arithmetic operand of round state."""
        for ctor, other_tainted in ((binop.left, rt), (binop.right, lt)):
            if not other_tainted or not isinstance(ctor, ast.Call):
                continue
            func = _dotted(ctor.func)
            if func not in F32_DEFAULT_CTORS or _has_dtype(ctor):
                continue
            if func in DTYPE_PRESERVING_CTORS and not (
                ctor.args and isinstance(ctor.args[0], (ast.Tuple, ast.List))
            ):
                continue
            self.m.emit(
                "MUR006", ctor,
                f"{func}() without an explicit dtype defaults to float32 and "
                "widens bfloat16 round state (tpu.param_dtype) — pass dtype= "
                "(e.g. the operand's .dtype)",
            )


def _lambda_as_fn(node: ast.Lambda):
    """Wrap a Lambda so _TaintScanner can treat it like a FunctionDef."""
    return ast.FunctionDef(
        name="<lambda>", args=node.args,
        body=[ast.Return(value=node.body, lineno=node.lineno, col_offset=0)],
        decorator_list=[], returns=None, type_comment=None,
        lineno=node.lineno, col_offset=node.col_offset,
    )


def _suppressed(findings: List[Finding], lines: List[str]) -> List[Finding]:
    out = []
    for f in findings:
        line = lines[f.line - 1] if 0 < f.line <= len(lines) else ""
        m = _IGNORE_RE.search(line)
        if m:
            ids = m.group(1)
            if ids is None or f.rule in {s.strip() for s in ids.split(",")}:
                continue
        out.append(f)
    return out


def apply_suppressions(findings: List[Finding]) -> List[Finding]:
    """Line suppressions at each finding's anchor (the executable families
    anchor at a rule's factory ``def`` or the machinery under contract)."""
    out: List[Finding] = []
    by_path: Dict[str, List[Finding]] = {}
    for f in findings:
        by_path.setdefault(f.path, []).append(f)
    for path, fs in by_path.items():
        try:
            lines = Path(path).read_text().splitlines()
        except OSError:
            out.extend(fs)
            continue
        out.extend(_suppressed(fs, lines))
    return out


def lint_file(path) -> List[Finding]:
    """Lint one Python file; returns findings after suppression filtering."""
    p = Path(path)
    try:
        source = p.read_text()
    except (OSError, UnicodeDecodeError) as e:
        return [Finding("MUR000", str(p), 1, f"unreadable file: {e}")]
    try:
        tree = ast.parse(source, filename=str(p))
    except SyntaxError as e:
        return [Finding("MUR000", str(p), e.lineno or 1, f"syntax error: {e.msg}")]
    lines = source.splitlines()
    findings = _ModuleScanner(tree, lines, str(p)).scan()
    return _suppressed(findings, lines)


def lint_paths(paths: Sequence) -> List[Finding]:
    """Lint every ``*.py`` under each path (files or directories)."""
    findings: List[Finding] = []
    for path in paths:
        p = Path(path)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            findings.extend(lint_file(f))
    return findings
