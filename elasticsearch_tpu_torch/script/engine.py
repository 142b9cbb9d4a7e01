"""Sandboxed scripting — the painless analog.

Reference analogs: modules/lang-painless (PainlessScriptEngine.java:57 —
compile + allowlist sandbox), script/ScriptService.java:61 (compile cache +
rate limiting), and the typed script contexts (ScoreScript, FieldScript,
IngestScript, update scripts).

TPU-first divergence: instead of compiling a Java-ish grammar to JVM
bytecode, scripts are parsed with Python's ``ast`` and interpreted over an
allowlist of node types with an operation budget (loop/bomb protection).
Painless's common idioms are expression-compatible
(``ctx._source.counter += params.count``, ``doc['f'].value * 2``): attribute
access on script values maps to mapping access, so both spellings work.
Vectorizable score scripts take the fast device path in search/execute.py;
this interpreter is the general fallback and the engine for update/ingest/
field scripts (host-side by design — they run in the control plane).
"""

from __future__ import annotations

import ast
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.utils.errors import SearchEngineError


class ScriptException(SearchEngineError):
    status = 400


class CircuitBreakingScriptError(ScriptException):
    status = 429


_MAX_OPS = 200_000          # interpreter step budget per execution
_CACHE_MAX = 512            # compiled-script cache entries (ScriptCache)


_ALLOWED_NODES = (
    ast.Module, ast.Expr, ast.Assign, ast.AugAssign, ast.If, ast.For,
    ast.While, ast.Break, ast.Continue, ast.Pass, ast.Compare, ast.BoolOp,
    ast.BinOp, ast.UnaryOp, ast.Call, ast.Name, ast.Attribute,
    ast.Subscript, ast.Constant, ast.List, ast.Dict, ast.Tuple, ast.Set,
    ast.IfExp, ast.Slice, ast.Load, ast.Store, ast.Del, ast.Delete,
    ast.And, ast.Or, ast.Not, ast.USub, ast.UAdd,
    ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod, ast.Pow,
    ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.In, ast.NotIn,
    ast.Is, ast.IsNot, ast.keyword, ast.comprehension, ast.ListComp,
    ast.GeneratorExp, ast.JoinedStr, ast.FormattedValue,
)

_MAX_RANGE = 1_000_000      # largest range() a script may materialize
_MAX_SEQ = 1_000_000        # largest string/list a script op may build


def _bounded_range(*a: Any) -> range:
    r = range(*(int(x) for x in a))
    if len(r) > _MAX_RANGE:
        raise CircuitBreakingScriptError(
            f"range of {len(r)} exceeds the script limit [{_MAX_RANGE}]")
    return r


_SAFE_BUILTINS: Dict[str, Any] = {
    "abs": abs, "min": min, "max": max, "len": len, "round": round,
    "sum": sum, "sorted": sorted, "float": float, "int": int, "str": str,
    "bool": bool, "range": _bounded_range,
    "list": list, "dict": dict, "set": set,
}

_MATH_NS = {name: getattr(math, name) for name in (
    "sqrt", "log", "log10", "exp", "pow", "floor", "ceil", "sin", "cos",
    "tan", "atan2", "pi", "e")}
_MATH_NS["max"] = max
_MATH_NS["min"] = min
_MATH_NS["abs"] = abs

# methods callable on values (Java-ish niceties painless scripts lean on)
_VALUE_METHODS = {
    "add", "append", "remove", "contains", "containsKey", "get", "put",
    "keys", "values", "items", "size", "length", "substring", "indexOf",
    "toLowerCase", "toUpperCase", "lower", "upper", "strip", "trim",
    "startsWith", "endsWith", "startswith", "endswith", "split", "replace",
    "join", "pop", "insert", "isEmpty", "sort", "index", "extend", "count",
}


class ScriptValue:
    """Attribute-access shim so ``ctx._source.field`` works over dicts."""

    __slots__ = ("_v",)

    def __init__(self, v: Any) -> None:
        self._v = v


def _unwrap(v: Any) -> Any:
    return v._v if isinstance(v, ScriptValue) else v


class CompiledScript:
    def __init__(self, source: str, tree: ast.Module):
        self.source = source
        self.tree = tree

    def execute(self, variables: Dict[str, Any]) -> Any:
        interp = _Interpreter(variables)
        return interp.run(self.tree)


class ScriptEngine:
    """Compile cache + sandboxed execution (ScriptService analog)."""

    def __init__(self, cache_max: int = _CACHE_MAX):
        self._cache: Dict[str, CompiledScript] = {}
        self._cache_max = cache_max
        self._lock = threading.Lock()
        self.stats = {"compilations": 0, "cache_evictions": 0,
                      "executions": 0}

    def compile(self, source: str) -> CompiledScript:
        with self._lock:
            hit = self._cache.get(source)
            if hit is not None:
                return hit
        try:
            tree = ast.parse(_preprocess(source), mode="exec")
        except SyntaxError as e:
            raise ScriptException(
                f"compile error in script [{source!r}]: {e}") from e
        for node in ast.walk(tree):
            if not isinstance(node, _ALLOWED_NODES):
                raise ScriptException(
                    f"illegal construct [{type(node).__name__}] "
                    f"in script [{source!r}]")
            if isinstance(node, ast.Name) and node.id.startswith("__"):
                raise ScriptException("dunder names are not allowed")
            if isinstance(node, ast.Attribute) and node.attr.startswith("_") \
                    and node.attr not in ("_source", "_score", "_id",
                                          "_index", "_routing", "_ingest"):
                raise ScriptException(
                    f"illegal attribute [{node.attr}] in script")
        compiled = CompiledScript(source, tree)
        with self._lock:
            if len(self._cache) >= self._cache_max:
                self._cache.pop(next(iter(self._cache)))
                self.stats["cache_evictions"] += 1
            self._cache[source] = compiled
            self.stats["compilations"] += 1
        return compiled

    def execute(self, source: str, variables: Dict[str, Any]) -> Any:
        self.stats["executions"] += 1
        return self.compile(source).execute(variables)


import re

_STRING_RE = re.compile(
    r"'''(?:\\.|[^\\])*?'''|\"\"\"(?:\\.|[^\\])*?\"\"\"|"
    r"'(?:\\.|[^'\\])*'|\"(?:\\.|[^\"\\])*\"")


def _preprocess(source: str) -> str:
    """Painless-compat shims that keep the grammar Python-parseable:
    ';' statement separators → newlines; '&&'/'||' → and/or; 'null' → None;
    'true'/'false' → True/False. String literals are carved out first so
    their contents are never rewritten."""
    literals: List[str] = []

    def stash(m: re.Match) -> str:
        literals.append(m.group(0))
        return f"\x00{len(literals) - 1}\x00"

    out = _STRING_RE.sub(stash, source)
    out = out.replace("&&", " and ").replace("||", " or ")
    # ';' separators become newlines carrying the line's own indentation
    if ";" in out:
        lines = []
        for line in out.split("\n"):
            indent = line[: len(line) - len(line.lstrip())]
            parts = [p.strip() for p in line.split(";")]
            lines.append(("\n" + indent).join(
                [indent + parts[0]] + [p for p in parts[1:] if p]))
        out = "\n".join(lines)
    out = re.sub(r"\bnull\b", "None", out)
    out = re.sub(r"\btrue\b", "True", out)
    out = re.sub(r"\bfalse\b", "False", out)
    out = re.sub(r"\breturn\s+", "_return_value = ", out)
    for i, lit in enumerate(literals):
        out = out.replace(f"\x00{i}\x00", lit)
    return out


class _Interpreter:
    def __init__(self, variables: Dict[str, Any]):
        self.scope: Dict[str, Any] = dict(variables)
        self.scope.setdefault("Math", ScriptValue(_MATH_NS))
        self.ops = 0

    def _tick(self) -> None:
        self.ops += 1
        if self.ops > _MAX_OPS:
            raise CircuitBreakingScriptError(
                "script exceeded the operation budget "
                f"[{_MAX_OPS}] (possible runaway loop)")

    def run(self, tree: ast.Module) -> Any:
        for stmt in tree.body:
            self._stmt(stmt)
            if "_return_value" in self.scope:
                break
        return self.scope.get("_return_value")

    # -- statements ----------------------------------------------------

    def _stmt(self, node: ast.stmt) -> None:
        self._tick()
        if isinstance(node, ast.Expr):
            self.scope["_last_expr"] = self._eval(node.value)
        elif isinstance(node, ast.Assign):
            value = self._eval(node.value)
            for target in node.targets:
                self._assign(target, value)
        elif isinstance(node, ast.AugAssign):
            current = self._eval_target(node.target)
            value = self._binop(node.op, current, self._eval(node.value))
            self._assign(node.target, value)
        elif isinstance(node, ast.If):
            branch = node.body if self._truth(self._eval(node.test)) \
                else node.orelse
            for inner in branch:
                self._stmt(inner)
                if "_return_value" in self.scope:
                    return
        elif isinstance(node, ast.For):
            for item in _unwrap(self._eval(node.iter)):
                self._assign(node.target, item)
                try:
                    for inner in node.body:
                        self._stmt(inner)
                        if "_return_value" in self.scope:
                            return
                except _Break:
                    break
                except _Continue:
                    continue
        elif isinstance(node, ast.While):
            while self._truth(self._eval(node.test)):
                self._tick()
                try:
                    for inner in node.body:
                        self._stmt(inner)
                        if "_return_value" in self.scope:
                            return
                except _Break:
                    break
                except _Continue:
                    continue
        elif isinstance(node, ast.Break):
            raise _Break()
        elif isinstance(node, ast.Continue):
            raise _Continue()
        elif isinstance(node, ast.Pass):
            pass
        elif isinstance(node, ast.Delete):
            for target in node.targets:
                self._delete(target)
        else:
            raise ScriptException(
                f"unsupported statement [{type(node).__name__}]")

    def _assign(self, target: ast.expr, value: Any) -> None:
        if isinstance(target, ast.Name):
            self.scope[target.id] = value
        elif isinstance(target, ast.Subscript):
            obj = _unwrap(self._eval(target.value))
            obj[_unwrap(self._eval(target.slice))] = _unwrap(value)
        elif isinstance(target, ast.Attribute):
            obj = _unwrap(self._eval(target.value))
            if isinstance(obj, dict):
                obj[target.attr] = _unwrap(value)
            else:
                raise ScriptException(
                    f"cannot assign attribute [{target.attr}]")
        elif isinstance(target, (ast.Tuple, ast.List)):
            vals = list(_unwrap(value))
            for t, v in zip(target.elts, vals):
                self._assign(t, v)
        else:
            raise ScriptException(
                f"unsupported assignment target [{type(target).__name__}]")

    def _delete(self, target: ast.expr) -> None:
        if isinstance(target, ast.Subscript):
            obj = _unwrap(self._eval(target.value))
            del obj[_unwrap(self._eval(target.slice))]
        elif isinstance(target, ast.Attribute):
            obj = _unwrap(self._eval(target.value))
            if isinstance(obj, dict):
                obj.pop(target.attr, None)
        elif isinstance(target, ast.Name):
            self.scope.pop(target.id, None)
        else:
            raise ScriptException("unsupported delete target")

    def _eval_target(self, target: ast.expr) -> Any:
        try:
            return self._eval(target)
        except (KeyError, ScriptException):
            return 0

    # -- expressions ---------------------------------------------------

    def _eval(self, node: ast.expr) -> Any:
        self._tick()
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Name):
            if node.id in self.scope:
                return self.scope[node.id]
            if node.id in _SAFE_BUILTINS:
                return _SAFE_BUILTINS[node.id]
            raise ScriptException(f"unknown variable [{node.id}]")
        if isinstance(node, ast.Attribute):
            obj = _unwrap(self._eval(node.value))
            return self._attr(obj, node.attr)
        if isinstance(node, ast.Subscript):
            obj = _unwrap(self._eval(node.value))
            if isinstance(node.slice, ast.Slice):
                lo = _unwrap(self._eval(node.slice.lower)) \
                    if node.slice.lower else None
                hi = _unwrap(self._eval(node.slice.upper)) \
                    if node.slice.upper else None
                return obj[lo:hi]
            return obj[_unwrap(self._eval(node.slice))]
        if isinstance(node, ast.BinOp):
            return self._binop(node.op, self._eval(node.left),
                               self._eval(node.right))
        if isinstance(node, ast.UnaryOp):
            v = _unwrap(self._eval(node.operand))
            if isinstance(node.op, ast.Not):
                return not self._truth(v)
            if isinstance(node.op, ast.USub):
                return -v
            return +v
        if isinstance(node, ast.BoolOp):
            if isinstance(node.op, ast.And):
                result: Any = True
                for v in node.values:
                    result = self._eval(v)
                    if not self._truth(result):
                        return result
                return result
            for v in node.values:
                result = self._eval(v)
                if self._truth(result):
                    return result
            return result
        if isinstance(node, ast.Compare):
            left = _unwrap(self._eval(node.left))
            for op, comparator in zip(node.ops, node.comparators):
                right = _unwrap(self._eval(comparator))
                if not self._compare(op, left, right):
                    return False
                left = right
            return True
        if isinstance(node, ast.IfExp):
            return self._eval(node.body) if self._truth(self._eval(node.test)) \
                else self._eval(node.orelse)
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, ast.List):
            return [_unwrap(self._eval(e)) for e in node.elts]
        if isinstance(node, ast.Tuple):
            return tuple(_unwrap(self._eval(e)) for e in node.elts)
        if isinstance(node, ast.Set):
            return {_unwrap(self._eval(e)) for e in node.elts}
        if isinstance(node, ast.Dict):
            return {_unwrap(self._eval(k)): _unwrap(self._eval(v))
                    for k, v in zip(node.keys, node.values)}
        if isinstance(node, (ast.ListComp, ast.GeneratorExp)):
            return self._comprehension(node)
        if isinstance(node, ast.JoinedStr):
            parts = []
            for v in node.values:
                if isinstance(v, ast.FormattedValue):
                    parts.append(str(_unwrap(self._eval(v.value))))
                else:
                    parts.append(str(_unwrap(self._eval(v))))
            return "".join(parts)
        raise ScriptException(
            f"unsupported expression [{type(node).__name__}]")

    def _comprehension(self, node) -> List[Any]:
        gen = node.generators[0]
        out = []
        for item in _unwrap(self._eval(gen.iter)):
            self._tick()
            self._assign(gen.target, item)
            if all(self._truth(self._eval(cond)) for cond in gen.ifs):
                out.append(_unwrap(self._eval(node.elt)))
        return out

    def _attr(self, obj: Any, attr: str) -> Any:
        # mapping access first (ctx._source.field style)
        if isinstance(obj, dict):
            if attr in obj:
                return obj[attr]
            if attr in _VALUE_METHODS:
                return self._method(obj, attr)
            raise KeyError(attr)
        if attr == "value":
            # doc-values semantics: .value = first value (doc['f'].value)
            if hasattr(obj, "value"):
                return obj.value
            if isinstance(obj, (list, tuple)):
                return obj[0] if obj else None
            return obj
        if attr == "values":
            # .values = all values as a list
            if hasattr(obj, "values") and not isinstance(obj, (list, tuple,
                                                               str)):
                return obj.values
            if isinstance(obj, (list, tuple)):
                return list(obj)
            return [obj]
        if attr == "length" and hasattr(obj, "__len__"):
            # painless: .length is a PROPERTY on arrays/strings
            return len(obj)
        if attr == "size" and hasattr(obj, "__len__"):
            # painless: .size() is a METHOD on collections — return it
            # bound so `doc['f'].size()` calls it instead of calling an int
            return lambda: len(obj)
        if attr in _VALUE_METHODS:
            return self._method(obj, attr)
        raise ScriptException(f"unknown attribute [{attr}]")

    def _method(self, obj: Any, name: str) -> Callable[..., Any]:
        java_to_py = {
            "add": "append", "contains": "__contains__",
            "containsKey": "__contains__", "size": "__len__",
            "length": "__len__", "substring": None, "indexOf": None,
            "toLowerCase": "lower", "toUpperCase": "upper", "trim": "strip",
            "startsWith": "startswith", "endsWith": "endswith",
            "put": "__setitem__", "isEmpty": None, "sort": "sort",
        }
        if name == "substring":
            return lambda lo, hi=None: obj[int(lo):None if hi is None
                                           else int(hi)]
        if name == "indexOf":
            def index_of(x):
                try:
                    return (obj.index(x) if not isinstance(obj, str)
                            else obj.find(x))
                except ValueError:
                    return -1
            return index_of
        if name == "isEmpty":
            return lambda: len(obj) == 0
        if name == "remove" and isinstance(obj, dict):
            return lambda k: obj.pop(k, None)
        py = java_to_py.get(name, name)
        if py is not None and hasattr(obj, py):
            return getattr(obj, py)
        if hasattr(obj, name):
            return getattr(obj, name)
        raise ScriptException(
            f"no method [{name}] on [{type(obj).__name__}]")

    def _call(self, node: ast.Call) -> Any:
        fn = self._eval(node.func)
        fn = _unwrap(fn)
        args = [_unwrap(self._eval(a)) for a in node.args]
        kwargs = {kw.arg: _unwrap(self._eval(kw.value))
                  for kw in node.keywords if kw.arg}
        if not callable(fn):
            raise ScriptException(f"[{fn!r}] is not callable")
        self._guard_amplifying_call(fn, args)
        try:
            return fn(*args, **kwargs)
        except (ScriptException, CircuitBreakingScriptError):
            raise
        except Exception as e:  # noqa: BLE001 — surfaced as script error
            raise ScriptException(f"script runtime error: {e}") from e

    @staticmethod
    def _guard_amplifying_call(fn: Any, args: List[Any]) -> None:
        """Native str methods can amplify a bounded input into an unbounded
        allocation in ONE interpreter step, sidestepping the per-op breaker
        on Add/Mult — bound their result size before the call runs."""
        name = getattr(fn, "__name__", "")
        owner = getattr(fn, "__self__", None)
        if name == "replace" and isinstance(owner, str) and len(args) >= 2 \
                and isinstance(args[0], str) and isinstance(args[1], str):
            occurrences = len(owner) // max(len(args[0]), 1) + 1
            if len(args) >= 3 and isinstance(args[2], int) and args[2] >= 0:
                occurrences = min(occurrences, args[2])
            worst = len(owner) + occurrences * len(args[1])
            if worst > _MAX_SEQ:
                raise CircuitBreakingScriptError(
                    "script replace() result exceeds the size limit")
        elif name == "join" and isinstance(owner, str) and args:
            try:
                items = list(args[0])
            except TypeError:
                return
            args[0] = items   # measured once, consumed once
            total = sum(len(x) if isinstance(x, str) else 32 for x in items)
            total += len(owner) * max(len(items) - 1, 0)
            if total > _MAX_SEQ:
                raise CircuitBreakingScriptError(
                    "script join() result exceeds the size limit")

    @staticmethod
    def _truth(v: Any) -> bool:
        return bool(_unwrap(v))

    def _binop(self, op: ast.operator, left: Any, right: Any) -> Any:
        left, right = _unwrap(left), _unwrap(right)
        if isinstance(op, ast.Add):
            if isinstance(left, (str, list, tuple)) and \
                    len(left) + (len(right) if hasattr(right, "__len__")
                                 else 0) > _MAX_SEQ:
                raise CircuitBreakingScriptError(
                    "script concatenation exceeds the size limit")
            return left + right
        if isinstance(op, ast.Sub):
            return left - right
        if isinstance(op, ast.Mult):
            # a single 'x' * 10**9 costs one interpreter step but unbounded
            # memory: bound sequence repetition explicitly
            for seq, n in ((left, right), (right, left)):
                if isinstance(seq, (str, list, tuple)) and \
                        isinstance(n, int) and len(seq) * max(n, 0) > _MAX_SEQ:
                    raise CircuitBreakingScriptError(
                        "script repetition exceeds the size limit")
            return left * right
        if isinstance(op, ast.Div):
            return left / right
        if isinstance(op, ast.FloorDiv):
            return left // right
        if isinstance(op, ast.Mod):
            return left % right
        if isinstance(op, ast.Pow):
            # bigint pow bombs (9**9**9) are one step yet unbounded compute
            if isinstance(left, int) and isinstance(right, int) and \
                    abs(left) > 1 and abs(right) > 4096:
                raise CircuitBreakingScriptError(
                    "script exponent exceeds the limit [4096]")
            return left ** right
        raise ScriptException(f"unsupported operator [{type(op).__name__}]")

    @staticmethod
    def _compare(op: ast.cmpop, left: Any, right: Any) -> bool:
        if isinstance(op, ast.Eq):
            return left == right
        if isinstance(op, ast.NotEq):
            return left != right
        if isinstance(op, ast.Lt):
            return left < right
        if isinstance(op, ast.LtE):
            return left <= right
        if isinstance(op, ast.Gt):
            return left > right
        if isinstance(op, ast.GtE):
            return left >= right
        if isinstance(op, ast.In):
            return left in right
        if isinstance(op, ast.NotIn):
            return left not in right
        if isinstance(op, ast.Is):
            return left is right
        if isinstance(op, ast.IsNot):
            return left is not right
        raise ScriptException("unsupported comparison")


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


default_engine = ScriptEngine()


# ---------------------------------------------------------------------------
# typed contexts
# ---------------------------------------------------------------------------

def execute_update_script(source: Dict[str, Any],
                          script: Any) -> Optional[Dict[str, Any]]:
    """Update-context script over ctx._source. Returns the new source, or
    None when the script sets ctx.op = 'delete' (the reference's update
    script contract, UpdateHelper)."""
    spec = _normalize(script)
    ctx = {"_source": source, "op": "index"}
    variables = {"ctx": ctx, "params": spec.get("params", {})}
    default_engine.execute(spec["source"], variables)
    if ctx.get("op") in ("delete",):
        return None
    if ctx.get("op") == "none" or ctx.get("op") == "noop":
        return source
    return ctx["_source"]


def execute_op_script(source: Dict[str, Any], script: Any
                      ) -> Tuple[str, Dict[str, Any]]:
    """Update-context script returning the op verdict explicitly:
    ('index' | 'noop' | 'delete', new_source). Reindex and
    update-by-query need the tri-state (the reference's
    AbstractAsyncBulkByScrollAction op switch)."""
    spec = _normalize(script)
    ctx = {"_source": source, "op": "index"}
    variables = {"ctx": ctx, "params": spec.get("params", {})}
    default_engine.execute(spec["source"], variables)
    op = ctx.get("op", "index")
    if op in ("none", "noop"):
        op = "noop"
    elif op != "delete":
        op = "index"
    return op, ctx["_source"]


def execute_field_script(script: Any, doc: Dict[str, Any],
                         source: Dict[str, Any]) -> Any:
    """FieldScript context: script fields in search responses."""
    spec = _normalize(script)
    variables = {"doc": doc, "params": spec.get("params", {}),
                 "_source": source, "ctx": {"_source": source}}
    interp = _Interpreter(variables)
    result = interp.run(default_engine.compile(spec["source"]).tree)
    if result is None:
        result = interp.scope.get("_last_expr")
    return _unwrap(result)


def execute_score_script(script: Any, doc: Dict[str, Any],
                         score: float) -> float:
    """ScoreScript context fallback (per-doc host eval)."""
    spec = _normalize(script)
    variables = {"doc": doc, "params": spec.get("params", {}),
                 "_score": score}
    interp = _Interpreter(variables)
    result = interp.run(default_engine.compile(spec["source"]).tree)
    if result is None:
        result = interp.scope.get("_last_expr")
    return float(_unwrap(result))


def _normalize(script: Any) -> Dict[str, Any]:
    if isinstance(script, str):
        return {"source": script, "params": {}}
    if isinstance(script, dict):
        if "source" not in script and "inline" in script:
            script = {**script, "source": script["inline"]}
        if "source" not in script:
            raise ScriptException("script is missing [source]")
        return script
    raise ScriptException(f"invalid script spec [{script!r}]")
