"""DSD lint rules of the port (the reference's ``repro/analysis/rules.py``
retargeted from jit/Pallas hazards to those of PyTorch on the card).

- DSD001  host sync inside a captured step: ``.item()``/``.tolist()``/
          ``.cpu()``/``.numpy()``, ``int()``/``float()``/``bool()`` of a
          tensor, a Python ``if``/``while`` on a tensor, numpy on a tensor,
          ``torch.cuda.synchronize`` or an event's ``.synchronize()``, in
          any function reachable from a ``body`` given to ``CapturedStep``
          (``core/capture.py``) — directly, or through a function that
          hands its own parameter on as the body (a session's
          ``_captured``), worker programs included
- DSD002  a captured step's static output read after the step's next call
          without a copy (a replay overwrites the buffers in place: the
          port's form of the reference's donated-buffer reuse)
- DSD003  wire-schema parity (``encode_*``/``decode_*`` must cover every
          field of the matching ``*Msg`` dataclass; device pass-through
          fields opt out with a ``wire-passthrough`` comment; every
          ``FRAME_*`` kind routed through both codec tables)
- DSD004  kernel-wrapper device routing: a function that reaches
          ``library()`` names the meta device in its routing, raises on a
          device it does not take, counts its launch with ``count_launch``
          and wraps no launch in a ``try`` that falls back
- DSD005  launch-grid divisibility: a ``//`` in what a kernel launch is
          given (its arguments, or a Triton ``kernel[grid]``) needs a
          matching ``X % tile`` check in the wrapper, or a ceil-div
          (``-(-a // b)``, ``(a + b - 1) // b``, ``triton.cdiv``)

All rules are pure AST: nothing here imports torch, so the linter runs
without the runtime stack.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Iterator, Optional

from .lint import Finding, ModuleInfo, Project, display_path, rule


# ---------------------------------------------------------------------------
# shared AST helpers (the reference's)
# ---------------------------------------------------------------------------

def _dotted(node: ast.AST) -> str | None:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _own_nodes(func: ast.AST) -> Iterator[ast.AST]:
    """Walk a function's nodes, not descending into nested defs/classes."""
    stack = list(ast.iter_child_nodes(func))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, _DEFS + (ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


@dataclasses.dataclass
class FuncInfo:
    module: ModuleInfo
    qualname: str
    node: ast.FunctionDef | ast.AsyncFunctionDef
    root_via: str = ""          # the captured body it is reachable from


def _is_package(mod: ModuleInfo) -> bool:
    return mod.path.name == "__init__.py"


def _resolve_from(mod: ModuleInfo, node: ast.ImportFrom) -> str:
    if node.level == 0:
        return node.module or ""
    parts = mod.name.split(".")
    drop = node.level - 1 if _is_package(mod) else node.level
    parts = parts[:len(parts) - drop] if drop <= len(parts) else []
    if node.module:
        parts = parts + node.module.split(".")
    return ".".join(parts)


def _import_table(mod: ModuleInfo) -> dict[str, str]:
    """Local binding name -> absolute dotted target it refers to."""
    table: dict[str, str] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    table[a.asname] = a.name
                else:
                    head = a.name.split(".")[0]
                    table[head] = head
        elif isinstance(node, ast.ImportFrom):
            base = _resolve_from(mod, node)
            for a in node.names:
                if a.name == "*":
                    continue
                target = f"{base}.{a.name}" if base else a.name
                table[a.asname or a.name] = target
    return table


def _full_name(d: str | None, imports: dict[str, str]) -> str | None:
    """Expand a dotted source name through the module's import aliases."""
    if not d:
        return None
    head, _, rest = d.partition(".")
    target = imports.get(head)
    if target is None:
        return d
    return f"{target}.{rest}" if rest else target


def _collect_functions(mod: ModuleInfo) -> list[FuncInfo]:
    funcs: list[FuncInfo] = []

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _DEFS):
                qual = f"{prefix}.{child.name}" if prefix else child.name
                funcs.append(FuncInfo(mod, qual, child))
                visit(child, qual)
            elif isinstance(child, ast.ClassDef):
                cls_prefix = f"{prefix}.{child.name}" if prefix else child.name
                visit(child, cls_prefix)
            else:
                visit(child, prefix)

    visit(mod.tree, "")
    return funcs


def _last(node: ast.AST) -> str:
    """The called name: ``f`` of ``a.b.f`` and of ``library().f``."""
    if isinstance(node, ast.Attribute):
        return node.attr
    return (_dotted(node) or "").split(".")[-1]


def _params(node) -> list[ast.arg]:
    a = node.args
    return a.posonlyargs + a.args + a.kwonlyargs


class _Index:
    """Project-wide function index and call-graph edges for reachability.
    Beside the reference's resolution (same-module names, ``self.x``,
    imports), an attribute call ``obj.name(...)`` on anything else resolves
    to every function of that name in the project (the port's steps call
    their model's and workers' methods through objects)."""

    def __init__(self, project: Project):
        self.project = project
        self.funcs: list[FuncInfo] = []
        self.by_key: dict[tuple[str, str], list[FuncInfo]] = {}
        self.by_name: dict[str, list[FuncInfo]] = {}
        self.imports: dict[str, dict[str, str]] = {}
        self.of_node: dict[int, FuncInfo] = {}
        for mod in project.modules.values():
            self.imports[mod.name] = _import_table(mod)
            for f in _collect_functions(mod):
                self.funcs.append(f)
                self.by_key.setdefault((mod.name, f.node.name), []).append(f)
                self.by_name.setdefault(f.node.name, []).append(f)
                self.of_node[id(f.node)] = f

    def _lookup_dotted(self, full: str, depth: int = 0) -> list[FuncInfo]:
        """A function by absolute dotted name, following re-exports (a
        package's ``from .mod import name``)."""
        parts = full.split(".")
        if len(parts) < 2:
            return []
        modname, fname = ".".join(parts[:-1]), parts[-1]
        mod = self.project.resolve_module(modname)
        if mod is None:
            return []
        hits = self.by_key.get((mod.name, fname), [])
        target = self.imports[mod.name].get(fname)
        if not hits and target and target != full and depth < 4:
            return self._lookup_dotted(target, depth + 1)
        return hits

    def resolve(self, mod: ModuleInfo, name: str) -> list[FuncInfo]:
        """Functions a dotted callee name may denote from ``mod``."""
        imports = self.imports[mod.name]
        parts = name.split(".")
        if len(parts) == 1:
            local = self.by_key.get((mod.name, name), [])
            if local:
                return local
            target = imports.get(name)
            return self._lookup_dotted(target) if target else []
        if parts[0] in ("self", "cls"):
            same = self.by_key.get((mod.name, parts[-1]), [])
            if same and len(parts) == 2:
                return same
        full = _full_name(name, imports)
        hits = self._lookup_dotted(full) if full else []
        if hits or (parts[0] in imports and parts[0] not in ("self", "cls")):
            return hits
        if parts[-1].startswith("__"):
            return []
        return self.by_name.get(parts[-1], [])

    def closures(self, f: FuncInfo, depth: int = 0) -> list[FuncInfo]:
        """What a call of factory ``f`` hands back to run: its nested defs,
        and the closures of the factories its ``return`` calls."""
        out = [self.of_node[id(n)] for n in ast.walk(f.node)
               if isinstance(n, _DEFS) and n is not f.node
               and id(n) in self.of_node]
        if depth < 4:
            for n in _own_nodes(f.node):
                if isinstance(n, ast.Return) and isinstance(n.value,
                                                            ast.Call):
                    for g in self.resolve(f.module, _dotted(n.value.func)
                                          or ""):
                        out.extend(self.closures(g, depth + 1))
        return out

    def callees(self, node: ast.AST, mod: ModuleInfo,
                scope: Optional[FuncInfo] = None) -> list[FuncInfo]:
        """Functions called (or named) by ``node``'s own code; a call of a
        local variable bound to a factory's result (``fn =
        eng._step_fn(g)``, in ``node`` or its enclosing ``scope``) reaches
        that factory's closures."""
        out: list[FuncInfo] = []
        for child in ast.iter_child_nodes(node):
            for sub in ast.walk(child):
                if isinstance(sub, _DEFS) and id(sub) in self.of_node:
                    out.append(self.of_node[id(sub)])
        bound = _factory_bindings(node)
        if scope is not None:
            for name, callees in _factory_bindings(scope.node).items():
                bound.setdefault(name, []).extend(callees)
        walk = _own_nodes(node) if not isinstance(node, ast.Lambda) \
            else ast.walk(node.body)
        for n in walk:
            name: Optional[str] = None
            if isinstance(n, ast.Call):
                name = _dotted(n.func)
            elif isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
                name = n.id
            if not name:
                continue
            if name in bound:
                for callee in bound[name]:
                    for g in self.resolve(mod, callee):
                        out.extend(self.closures(g))
                continue
            if isinstance(n, ast.Name) and not self.by_key.get(
                    (mod.name, name)) and name not in self.imports[mod.name]:
                continue
            out.extend(self.resolve(mod, name))
        return out


def _factory_bindings(node: ast.AST) -> dict[str, list[str]]:
    """Local names bound to the result of a call: name → its callees (every
    assignment of the name)."""
    out: dict[str, list[str]] = {}
    for n in _own_nodes(node):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
            callee = _dotted(n.value.func)
            if callee:
                for t in n.targets:
                    for name in _assign_targets(t):
                        out.setdefault(name, []).append(callee)
    return out


def _assign_targets(node: ast.AST) -> Iterator[str]:
    if isinstance(node, ast.Name):
        yield node.id
    elif isinstance(node, (ast.Tuple, ast.List)):
        for elt in node.elts:
            yield from _assign_targets(elt)
    elif isinstance(node, ast.Starred):
        yield from _assign_targets(node.value)


# ---------------------------------------------------------------------------
# captured-step bodies
# ---------------------------------------------------------------------------

_STEP_CLASS = "CapturedStep"


def _body_arg(call: ast.Call, pos: int, kw: str) -> Optional[ast.AST]:
    for k in call.keywords:
        if k.arg == kw:
            return k.value
    return call.args[pos] if len(call.args) > pos else None


def _body_slots(index: _Index) -> dict[str, tuple[int, str]]:
    """Callables whose argument becomes a captured body: ``CapturedStep``
    (argument 0, ``body``) and every function that passes one of its own
    parameters on as that argument (name → (call position, keyword))."""
    slots = {_STEP_CLASS: (0, "body")}
    changed = True
    while changed:
        changed = False
        for f in index.funcs:
            if f.node.name in slots:
                continue
            params = [a.arg for a in _params(f.node)]
            for n in _own_nodes(f.node):
                if not isinstance(n, ast.Call):
                    continue
                slot = slots.get(_last(n.func))
                if slot is None:
                    continue
                arg = _body_arg(n, *slot)
                if isinstance(arg, ast.Name) and arg.id in params:
                    i = params.index(arg.id)
                    if params and params[0] in ("self", "cls"):
                        i -= 1
                    slots[f.node.name] = (i, arg.id)
                    changed = True
                    break
    return slots


@dataclasses.dataclass
class _Root:
    """A captured body: a def or a lambda, with the function it was built
    in (whose local names its calls may refer to)."""
    node: ast.AST
    module: ModuleInfo
    scope: Optional[FuncInfo]
    via: str


def _captured_roots(index: _Index) -> list[_Root]:
    slots = _body_slots(index)
    roots: list[_Root] = []
    scopes = [(f.module, f, f.node) for f in index.funcs]
    scopes += [(m, None, m.tree) for m in index.project.modules.values()]
    for mod, f, node in scopes:
        if f is not None:
            own = list(_own_nodes(node))
        else:                           # module level, outside any def
            own = [n for top in node.body
                   if not isinstance(top, _DEFS + (ast.ClassDef,))
                   for n in ast.walk(top)]
        for n in own:
            if not isinstance(n, ast.Call):
                continue
            name = _last(n.func)
            slot = slots.get(name)
            if slot is None:
                continue
            arg = _body_arg(n, *slot)
            via = f"{name}(...) in `{f.qualname if f else mod.name}`"
            if isinstance(arg, ast.Lambda):
                roots.append(_Root(arg, mod, f, via))
            elif isinstance(arg, ast.Name) and f is not None:
                params = {a.arg for a in _params(f.node)}
                if arg.id in params:
                    continue            # a slot: its callers are roots
                for m in _own_nodes(f.node):
                    if isinstance(m, _DEFS) and m.name == arg.id:
                        roots.append(_Root(m, mod, f, via))
                    elif isinstance(m, ast.Assign) and isinstance(
                            m.value, ast.Lambda) and arg.id in {
                            t for tt in m.targets
                            for t in _assign_targets(tt)}:
                        roots.append(_Root(m.value, mod, f, via))
    return roots


def reachable_from_captures(index: _Index) -> tuple[list[_Root],
                                                    dict[int, FuncInfo]]:
    """The captured bodies, and every function reachable from them."""
    roots = _captured_roots(index)
    seen: dict[int, FuncInfo] = {}
    frontier: list[FuncInfo] = []
    for r in roots:
        for g in index.callees(r.node, r.module, r.scope):
            if id(g) not in seen:
                g.root_via = g.root_via or r.via
                seen[id(g)] = g
                frontier.append(g)
        if id(r.node) in index.of_node:
            f = index.of_node[id(r.node)]
            f.root_via = f.root_via or r.via
            if id(f) not in seen:
                seen[id(f)] = f
                frontier.append(f)
    while frontier:
        nxt: list[FuncInfo] = []
        for f in frontier:
            for callee in index.callees(f.node, f.module):
                if id(callee) not in seen:
                    callee.root_via = callee.root_via or f.root_via
                    seen[id(callee)] = callee
                    nxt.append(callee)
        frontier = nxt
    return roots, seen


# ---------------------------------------------------------------------------
# DSD001 — host syncs inside captured steps
# ---------------------------------------------------------------------------

# tensor attributes and methods that read metadata, not device memory
_SAFE_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "is_meta",
               "layout", "requires_grad", "is_leaf", "itemsize"}
_SAFE_METHODS = {"dim", "size", "numel", "data_ptr", "stride",
                 "element_size", "is_contiguous", "nbytes", "get_device",
                 "untyped_storage", "is_floating_point"}
_SAFE_CALLS = {"len", "isinstance", "hasattr", "getattr", "type",
               "issubclass", "callable", "repr", "str", "format", "id"}
# torch.* callables that do not return tensors
_NONTENSOR_TORCH = ("torch.device", "torch.dtype", "torch.Generator",
                    "torch.no_grad", "torch.enable_grad",
                    "torch.inference_mode", "torch.is_grad_enabled",
                    "torch.get_default_dtype", "torch.Size", "torch.finfo",
                    "torch.iinfo", "torch.is_tensor", "torch.cuda.",
                    "torch.autograd.", "torch.utils.", "torch.backends.")
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
# parameter annotations that say "not a tensor"
_STATIC_ANNOTATIONS = re.compile(
    r"^(Optional\[)?(int|float|bool|str|bytes|ModelConfig|TreeSpec|"
    r"torch\.dtype|torch\.device|dict|list|tuple)\b")


def _is_tensor_producer(call: ast.Call, imports: dict[str, str]) -> bool:
    full = _full_name(_dotted(call.func), imports)
    if not full or not (full == "torch" or full.startswith("torch.")):
        return False
    return not any(full == p or (p.endswith(".") and full.startswith(p))
                   for p in _NONTENSOR_TORCH)


def _expr_tensor(e: ast.AST, tensors: set[str],
                 imports: dict[str, str],
                 static_fns: frozenset = frozenset()) -> bool:
    """Whether ``e`` may be a tensor: a name in ``tensors``, a torch call,
    or an expression over those; metadata reads, identity tests and calls
    of ``static_fns`` (this module's functions annotated to return a
    non-tensor) are not."""
    def rec(x):
        return _expr_tensor(x, tensors, imports, static_fns)

    if isinstance(e, ast.Name):
        return e.id in tensors
    if isinstance(e, ast.Attribute):
        if e.attr in _SAFE_ATTRS:
            return False
        return rec(e.value)
    if isinstance(e, ast.Call):
        if _is_tensor_producer(e, imports):
            return True
        if isinstance(e.func, ast.Name) and (e.func.id in _SAFE_CALLS
                                             or e.func.id in static_fns):
            return False
        if isinstance(e.func, ast.Attribute) and (
                e.func.attr in _SAFE_METHODS
                or e.func.attr in _SYNC_METHODS):
            return False
        return (rec(e.func)
                or any(rec(a) for a in e.args))
    if isinstance(e, ast.BinOp):
        return (rec(e.left)
                or rec(e.right))
    if isinstance(e, ast.UnaryOp):
        return rec(e.operand)
    if isinstance(e, ast.BoolOp):
        return any(rec(v) for v in e.values)
    if isinstance(e, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in e.ops):
            return False            # identity: a Python bool, no read
        return (rec(e.left)
                or any(rec(c)
                       for c in e.comparators))
    if isinstance(e, ast.IfExp):
        return any(rec(x)
                   for x in (e.body, e.orelse))
    if isinstance(e, ast.Subscript):
        return rec(e.value)
    if isinstance(e, ast.Starred):
        return rec(e.value)
    return False


def _static_test(test: ast.AST) -> bool:
    """True for tests of identity or structure (``x is None``)."""
    if isinstance(test, ast.Compare):
        return all(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops)
    if isinstance(test, ast.BoolOp):
        return all(_static_test(v) for v in test.values)
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _static_test(test.operand)
    return False


def _static_returners(mod: ModuleInfo) -> frozenset:
    """Names of the module's functions annotated to return a non-tensor."""
    out = set()
    for n in ast.walk(mod.tree):
        if isinstance(n, _DEFS) and n.returns is not None:
            ann = ast.unparse(n.returns)
            if ann == "None" or _STATIC_ANNOTATIONS.match(ann):
                out.add(n.name)
    return frozenset(out)


class _SyncScan:
    """One function (or lambda) of a captured step: tensors are what torch
    calls return and what is computed from them; unannotated and
    tensor-annotated parameters may be tensors (they count for the
    host-forcing calls, not for the ``if`` check)."""

    def __init__(self, node, module: ModuleInfo, qualname: str, via: str,
                 imports: dict[str, str]):
        self.node, self.module = node, module
        self.qualname, self.via = qualname, via
        self.imports = imports
        self.static_fns = _static_returners(module)
        self.tensors: set[str] = set()
        self.maybe: set[str] = set()
        for a in _params(node):
            if a.arg in ("self", "cls"):
                continue
            ann = ast.unparse(a.annotation) if a.annotation else ""
            if ann and _STATIC_ANNOTATIONS.match(ann):
                continue
            (self.tensors if "Tensor" in ann else self.maybe).add(a.arg)
        self.findings: list[Finding] = []

    def _tensor(self, e: ast.AST, names: Optional[set] = None) -> bool:
        return _expr_tensor(e, self.tensors if names is None else names,
                            self.imports, self.static_fns)

    def _emit(self, node: ast.AST, what: str) -> None:
        via = f" (reachable from {self.via})" if self.via else ""
        self.findings.append(Finding(
            display_path(self.module.path), node.lineno, node.col_offset,
            "DSD001", f"{what} inside a captured step in "
                      f"`{self.qualname}`{via}"))

    def check_expr(self, expr: Optional[ast.AST]) -> None:
        if expr is None:
            return
        wide = self.tensors | self.maybe
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func)
            if d in ("int", "float", "bool", "complex"):
                if any(self._tensor(a, wide) for a in node.args):
                    self._emit(node, f"Python {d}() of a tensor reads it "
                                     "on the host")
                continue
            if isinstance(node.func, ast.Attribute):
                attr = node.func.attr
                if attr in _SYNC_METHODS and not isinstance(
                        node.func.value, ast.Constant):
                    self._emit(node, f".{attr}() copies a tensor to the "
                                     "host")
                    continue
                if attr == "synchronize":
                    self._emit(node, f"`{d or attr}()` waits for the "
                                     "device")
                    continue
            full = _full_name(d, self.imports)
            if full and (full == "numpy" or full.startswith("numpy.")):
                if (any(self._tensor(a, wide) for a in node.args)
                        or any(self._tensor(k.value, wide)
                               for k in node.keywords)):
                    self._emit(node, f"numpy call `{d}` on a tensor")

    def _mark(self, target: ast.AST) -> None:
        for name in _assign_targets(target):
            self.tensors.add(name)

    def scan(self, stmts: list[ast.stmt]) -> None:
        for s in stmts:
            if isinstance(s, _DEFS + (ast.ClassDef,)):
                continue
            if isinstance(s, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                self.check_expr(s.value)
                if s.value is not None and self._tensor(s.value):
                    targets = s.targets if isinstance(s, ast.Assign) \
                        else [s.target]
                    for t in targets:
                        self._mark(t)
            elif isinstance(s, (ast.If, ast.While)):
                self.check_expr(s.test)
                if (self._tensor(s.test)
                        and not _static_test(s.test)):
                    self._emit(s, "Python control flow on a tensor (use "
                                  "torch.where or a device-side mask)")
                self.scan(s.body)
                self.scan(s.orelse)
            elif isinstance(s, ast.For):
                self.check_expr(s.iter)
                if self._tensor(s.iter):
                    self._mark(s.target)
                self.scan(s.body)
                self.scan(s.orelse)
            elif isinstance(s, ast.With):
                for item in s.items:
                    self.check_expr(item.context_expr)
                self.scan(s.body)
            elif isinstance(s, ast.Try):
                self.scan(s.body)
                for h in s.handlers:
                    self.scan(h.body)
                self.scan(s.orelse)
                self.scan(s.finalbody)
            elif isinstance(s, (ast.Return, ast.Expr)):
                self.check_expr(s.value)
            elif isinstance(s, (ast.Assert, ast.Raise, ast.Delete)):
                for child in ast.iter_child_nodes(s):
                    self.check_expr(child)


@rule("DSD001")
def check_captured_host_syncs(project: Project) -> Iterator[Finding]:
    index = _Index(project)
    roots, reach = reachable_from_captures(index)
    for r in roots:
        if isinstance(r.node, ast.Lambda):
            scan = _SyncScan(r.node, r.module, "<lambda>", r.via,
                             index.imports[r.module.name])
            scan.check_expr(r.node.body)
            yield from scan.findings
    for f in reach.values():
        scan = _SyncScan(f.node, f.module, f.qualname, f.root_via,
                         index.imports[f.module.name])
        scan.scan(f.node.body)
        yield from scan.findings


# ---------------------------------------------------------------------------
# DSD002 — a captured step's static outputs read after its next call
# ---------------------------------------------------------------------------

def _is_alias(expr: ast.AST) -> bool:
    """A plain read of a buffer (a name, an attribute, an index or a slice
    of one), no call that would copy it."""
    while isinstance(expr, (ast.Attribute, ast.Subscript)):
        expr = expr.value
    return isinstance(expr, ast.Name)


class _ReplayScan:
    """Within one function: names bound to captured steps, names bound to
    plain reads made after a step ran (aliases of its static outputs), and
    reads of those aliases after the step ran again."""

    def __init__(self, f: FuncInfo, slots: dict):
        self.f = f
        self.slots = slots
        self.steps: set[str] = set()
        self.called: Optional[str] = None       # the step that ran last
        self.aliases: dict[str, str] = {}       # alias → its step
        self.stale: dict[str, int] = {}         # alias → overwriting line
        self.findings: list[Finding] = []

    def _emit(self, node: ast.AST, name: str, line: int) -> None:
        self.findings.append(Finding(
            display_path(self.f.module.path), node.lineno, node.col_offset,
            "DSD002",
            f"`{name}` aliases a captured step's static output and is read "
            f"after the step ran again at line {line} (a replay overwrites "
            f"it in place; copy it first) in `{self.f.qualname}`"))

    def scan(self, stmts: list[ast.stmt]) -> None:
        for s in stmts:
            if isinstance(s, _DEFS + (ast.ClassDef,)):
                continue
            for node in ast.walk(s):
                if isinstance(node, ast.Name) and isinstance(node.ctx,
                                                             ast.Load):
                    if node.id in self.stale:
                        self._emit(node, node.id, self.stale.pop(node.id))
            for node in ast.walk(s):
                if not isinstance(node, ast.Call):
                    continue
                name = _dotted(node.func)
                if name in self.steps:
                    self.called = name
                    for alias, step in self.aliases.items():
                        if step == name:
                            self.stale[alias] = node.lineno
            if isinstance(s, (ast.Assign, ast.AnnAssign)):
                targets = s.targets if isinstance(s, ast.Assign) \
                    else [s.target]
                names = [n for t in targets for n in _assign_targets(t)]
                for n in names:
                    self.stale.pop(n, None)
                    self.aliases.pop(n, None)
                v = s.value
                if isinstance(v, ast.Call) and _last(v.func) in self.slots:
                    self.steps.update(names)
                elif v is not None and self.called and _is_alias(v):
                    for n in names:
                        self.aliases[n] = self.called
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(s, attr, None)
                if isinstance(sub, list) and sub and isinstance(
                        sub[0], ast.stmt):
                    self.scan(sub)
            for h in getattr(s, "handlers", []):
                self.scan(h.body)


@rule("DSD002")
def check_replay_overwrite(project: Project) -> Iterator[Finding]:
    index = _Index(project)
    slots = _body_slots(index)
    for f in index.funcs:
        scan = _ReplayScan(f, slots)
        scan.scan(f.node.body)
        yield from scan.findings


# ---------------------------------------------------------------------------
# DSD003 — wire-schema parity (the reference's rule)
# ---------------------------------------------------------------------------

def _snake(name: str) -> str:
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()


def _msg_classes(mod: ModuleInfo) -> Iterator[tuple[ast.ClassDef, list[str],
                                                    set[str]]]:
    for node in mod.tree.body:
        if not isinstance(node, ast.ClassDef) or not node.name.endswith("Msg"):
            continue
        is_dc = any(
            (_dotted(d) or _dotted(getattr(d, "func", ast.Pass())) or "")
            .split(".")[-1] == "dataclass"
            for d in node.decorator_list)
        if not is_dc:
            continue
        fields: list[str] = []
        passthrough: set[str] = set()
        for item in node.body:
            if isinstance(item, ast.AnnAssign) and isinstance(
                    item.target, ast.Name):
                fields.append(item.target.id)
                if "wire-passthrough" in mod.source_line(item.lineno):
                    passthrough.add(item.target.id)
        yield node, fields, passthrough


@rule("DSD003")
def check_wire_parity(project: Project) -> Iterator[Finding]:
    for mod in project.modules.values():
        path = display_path(mod.path)
        top_funcs = {n.name: n for n in mod.tree.body if isinstance(n, _DEFS)}
        for cls, fields, passthrough in _msg_classes(mod):
            stem = _snake(cls.name[:-len("Msg")])
            enc = top_funcs.get(f"encode_{stem}")
            dec = top_funcs.get(f"decode_{stem}")
            if enc is None and dec is None:
                continue  # not a wire type
            required = [f for f in fields if f not in passthrough]
            if enc is None:
                yield Finding(path, cls.lineno, cls.col_offset, "DSD003",
                              f"`{cls.name}` has decode_{stem} but no "
                              f"encode_{stem}")
            else:
                arg = enc.args.args[0].arg if enc.args.args else None
                seen = {n.attr for n in ast.walk(enc)
                        if isinstance(n, ast.Attribute)
                        and isinstance(n.value, ast.Name)
                        and n.value.id == arg}
                for f in required:
                    if f not in seen:
                        yield Finding(
                            path, enc.lineno, enc.col_offset, "DSD003",
                            f"encode_{stem} does not serialize "
                            f"`{cls.name}.{f}` (mark wire-passthrough if "
                            f"intentionally device-local)")
            if dec is None:
                yield Finding(path, cls.lineno, cls.col_offset, "DSD003",
                              f"`{cls.name}` has encode_{stem} but no "
                              f"decode_{stem}")
            else:
                ctor = None
                for n in ast.walk(dec):
                    if isinstance(n, ast.Call) and (
                            _dotted(n.func) or "").split(".")[-1] == cls.name:
                        ctor = n
                        break
                if ctor is None:
                    yield Finding(path, dec.lineno, dec.col_offset, "DSD003",
                                  f"decode_{stem} never constructs "
                                  f"`{cls.name}`")
                    continue
                provided = set(fields[:len(ctor.args)])
                provided |= {kw.arg for kw in ctor.keywords if kw.arg}
                for f in required:
                    if f not in provided:
                        yield Finding(
                            path, ctor.lineno, ctor.col_offset, "DSD003",
                            f"decode_{stem} does not reconstruct "
                            f"`{cls.name}.{f}`")
        yield from _check_frame_tables(mod, path)


def _check_frame_tables(mod: ModuleInfo, path: str) -> Iterator[Finding]:
    """Length-prefix framing parity: a module declaring ``FRAME_*`` kind
    constants (the socket transport's frame-kind tags) must route EVERY
    kind through both codec tables — a kind missing from
    ``FRAME_ENCODERS``/``FRAME_DECODERS`` is a frame the wire can carry
    but one side cannot (de)serialize."""
    consts: dict[str, ast.Assign] = {}
    tables: dict[str, ast.Assign] = {}
    for node in mod.tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        name = node.targets[0].id
        if re.fullmatch(r"FRAME_[A-Z_]+", name) \
                and name not in ("FRAME_ENCODERS", "FRAME_DECODERS") \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, int):
            consts[name] = node
        elif name in ("FRAME_ENCODERS", "FRAME_DECODERS") \
                and isinstance(node.value, ast.Dict):
            tables[name] = node
    if not consts:
        return
    for tbl in ("FRAME_ENCODERS", "FRAME_DECODERS"):
        node = tables.get(tbl)
        if node is None:
            first = min(consts.values(), key=lambda n: n.lineno)
            yield Finding(path, first.lineno, first.col_offset, "DSD003",
                          f"module declares frame kinds "
                          f"{sorted(consts)} but no {tbl} codec table")
            continue
        keys = {k.id for k in node.value.keys if isinstance(k, ast.Name)}
        for name in sorted(set(consts) - keys):
            yield Finding(path, node.lineno, node.col_offset, "DSD003",
                          f"{tbl} does not route frame kind {name} — a "
                          f"framed message of that kind cannot cross the "
                          f"wire")


# ---------------------------------------------------------------------------
# DSD004 / DSD005 — kernel-wrapper hygiene
# ---------------------------------------------------------------------------

def _reaches_library(f: FuncInfo) -> list[ast.Call]:
    return [n for n in _own_nodes(f.node)
            if isinstance(n, ast.Call) and _last(n.func) == "library"]


def _launch_calls(f: FuncInfo) -> list[ast.Call]:
    """Kernel launches: a C entry ``*_launch(...)`` (through the library
    or a name bound to it) or a Triton ``kernel[grid](...)``."""
    out = []
    for n in _own_nodes(f.node):
        if not isinstance(n, ast.Call):
            continue
        if _last(n.func).endswith("_launch"):
            out.append(n)
        elif isinstance(n.func, ast.Subscript):
            out.append(n)
    return out


def _device_names(f: FuncInfo) -> set[str]:
    """String constants the function compares against."""
    out = set()
    for n in _own_nodes(f.node):
        if isinstance(n, ast.Compare):
            for side in [n.left, *n.comparators]:
                for c in ast.walk(side):
                    if isinstance(c, ast.Constant) and isinstance(c.value,
                                                                  str):
                        out.add(c.value)
    return out


def _raises(f: FuncInfo, index: _Index) -> bool:
    """A ``raise`` in the function, or in a same-module helper it calls."""
    if any(isinstance(n, ast.Raise) for n in _own_nodes(f.node)):
        return True
    for n in _own_nodes(f.node):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name):
            for g in index.by_key.get((f.module.name, n.func.id), []):
                if any(isinstance(m, ast.Raise) for m in _own_nodes(g.node)):
                    return True
    return False


def _falls_back(f: FuncInfo, launches: list[ast.Call]) -> Optional[ast.Try]:
    """A ``try`` around a launch with a handler that does not re-raise."""
    ids = {id(c) for c in launches}
    for n in _own_nodes(f.node):
        if not isinstance(n, ast.Try):
            continue
        inside = any(id(c) in ids or (isinstance(c, ast.Call)
                                      and _last(c.func) == "library")
                     for s in n.body for c in ast.walk(s))
        if inside and any(not any(isinstance(m, ast.Raise)
                                  for m in ast.walk(h))
                          for h in n.handlers):
            return n
    return None


@rule("DSD004")
def check_device_routing(project: Project) -> Iterator[Finding]:
    index = _Index(project)
    for f in index.funcs:
        calls = _reaches_library(f)
        if not calls or f.node.name == "library":
            continue
        path = display_path(f.module.path)
        first = calls[0]
        names = _device_names(f)
        if "meta" not in names:
            yield Finding(path, first.lineno, first.col_offset, "DSD004",
                          f"`{f.qualname}` reaches library() without a "
                          f"named meta branch (meta tensors take the plain "
                          f"version's shapes)")
        if not _raises(f, index):
            yield Finding(path, first.lineno, first.col_offset, "DSD004",
                          f"`{f.qualname}` reaches library() but raises on "
                          f"no device it does not take")
        if not any(isinstance(n, ast.Call) and _last(n.func) == "count_launch"
                   for n in _own_nodes(f.node)):
            yield Finding(path, first.lineno, first.col_offset, "DSD004",
                          f"`{f.qualname}` launches without count_launch()")
        bad = _falls_back(f, _launch_calls(f))
        if bad is not None:
            yield Finding(path, bad.lineno, bad.col_offset, "DSD004",
                          f"`{f.qualname}` wraps a launch in a try that "
                          f"falls back instead of raising")


def _is_ceil_div(node: ast.AST) -> bool:
    """``-(-a // b)``, ``(a + b - 1) // b`` or ``cdiv(a, b)``."""
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        inner = node.operand
        return (isinstance(inner, ast.BinOp)
                and isinstance(inner.op, ast.FloorDiv)
                and isinstance(inner.left, ast.UnaryOp)
                and isinstance(inner.left.op, ast.USub))
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.FloorDiv):
        left = node.left
        return (isinstance(left, ast.BinOp) and isinstance(left.op, ast.Sub)
                and isinstance(left.left, ast.BinOp)
                and isinstance(left.left.op, ast.Add))
    return False


def _floor_divs(expr: ast.AST) -> list[ast.BinOp]:
    """Floor divisions of ``expr`` that are not part of a ceil-div."""
    ceil_parts: set[int] = set()
    for n in ast.walk(expr):
        if _is_ceil_div(n):
            ceil_parts.update(id(m) for m in ast.walk(n))
    return [n for n in ast.walk(expr)
            if isinstance(n, ast.BinOp) and isinstance(n.op, ast.FloorDiv)
            and id(n) not in ceil_parts]


def _launch_exprs(f: FuncInfo, launches: list[ast.Call]) -> list[ast.AST]:
    """What the launches are given, one level of local names resolved."""
    assigns: dict[str, ast.AST] = {}
    for n in _own_nodes(f.node):
        if isinstance(n, ast.Assign):
            for t in n.targets:
                for name in _assign_targets(t):
                    assigns.setdefault(name, n.value)
    out: list[ast.AST] = []
    for call in launches:
        given = list(call.args) + [k.value for k in call.keywords]
        if isinstance(call.func, ast.Subscript):
            given.append(call.func.slice)
        for e in given:
            out.append(e)
            for n in ast.walk(e):
                if isinstance(n, ast.Name) and n.id in assigns:
                    out.append(assigns[n.id])
    return out


@rule("DSD005")
def check_grid_divisibility(project: Project) -> Iterator[Finding]:
    index = _Index(project)
    for f in index.funcs:
        launches = _launch_calls(f)
        if not launches:
            continue
        divs = [d for e in _launch_exprs(f, launches)
                for d in _floor_divs(e)]
        if not divs:
            continue
        checked = any(
            isinstance(n, (ast.Assert, ast.If))
            and any(isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Mod)
                    for sub in ast.walk(n.test))
            for n in _own_nodes(f.node))
        if not checked:
            yield Finding(
                display_path(f.module.path), launches[0].lineno,
                launches[0].col_offset, "DSD005",
                f"`{f.qualname}` tiles a launch with `//` but checks no "
                f"divisibility (`assert X % tile == 0`) and uses no ceil-div")
