"""EQL: event query language over timestamped event indices.

Reference: x-pack/plugin/eql — an ANTLR grammar compiling to the shared
ql planner, executed as search requests plus a sequence state machine
(x-pack/plugin/eql/src/main/java/org/elasticsearch/xpack/eql/execution/
sequence/TumblingWindow.java). This build hand-rolls the recursive-descent
parser and compiles conditions straight onto the query DSL; sequences run
as one filtered, time-ordered sweep joined host-side by key — the
TumblingWindow's job collapsed into a single pass, practical because the
per-stage candidate sets come back from the device top-k already sorted.

Supported surface:
  <category> where <condition>
  sequence [by f1, f2] [with maxspan=<N><unit>]
      [cat1 where c1] [cat2 where c2] ...
  condition: comparisons (== != < <= > >=), and/or/not, parentheses,
      field in ("a", "b"), like~ / like "wild*card", field regex~ "...",
      true/false/null literals, function calls length(f), wildcard(f, p)
Pipes: | head N, | tail N.

POST /{index}/_eql/search with {"query": "..."}; events responses carry
hits.events, sequence responses hits.sequences with join_keys.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError

DEFAULT_SIZE = 10
SWEEP_SIZE = 10_000          # events fetched per sequence sweep

_TOKEN_RX = re.compile(r"""
    \s*(?:
      (?P<num>-?\d+(?:\.\d+)?)
    | "(?P<dstr>(?:[^"\\]|\\.)*)"
    | '(?P<sstr>(?:[^'\\]|\\.)*)'
    | (?P<op>==|!=|<=|>=|=|<|>|\(|\)|\[|\]|,|\|)
    | (?P<word>[A-Za-z_][A-Za-z0-9_.]*~?)
    )""", re.VERBOSE)

_UNITS_MS = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000,
             "d": 86_400_000}


def tokenize(text: str) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RX.match(text, pos)
        if m is None:
            if text[pos:].strip() == "":
                break
            raise IllegalArgumentError(
                f"EQL: cannot tokenize at [{text[pos:pos + 20]!r}]")
        pos = m.end()
        if m.group("num") is not None:
            n = float(m.group("num"))
            out.append(("num", int(n) if n.is_integer() else n))
        elif m.group("dstr") is not None:
            out.append(("str", re.sub(r"\\(.)", r"\1", m.group("dstr"))))
        elif m.group("sstr") is not None:
            out.append(("str", re.sub(r"\\(.)", r"\1", m.group("sstr"))))
        elif m.group("op") is not None:
            out.append(("op", m.group("op")))
        else:
            out.append(("word", m.group("word")))
    return out


class _P:
    def __init__(self, toks: List[Tuple[str, Any]]):
        self.toks = toks
        self.i = 0

    def peek(self) -> Optional[Tuple[str, Any]]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> Tuple[str, Any]:
        t = self.peek()
        if t is None:
            raise IllegalArgumentError("EQL: unexpected end of query")
        self.i += 1
        return t

    def eat_word(self, *words: str) -> bool:
        t = self.peek()
        if t is not None and t[0] == "word" and t[1].lower() in words:
            self.i += 1
            return True
        return False

    def expect_op(self, op: str) -> None:
        t = self.next()
        if t != ("op", op):
            raise IllegalArgumentError(f"EQL: expected [{op}], got {t}")


# ---------------------------------------------------------------------------
# condition -> DSL body
# ---------------------------------------------------------------------------

def _cond_or(p: _P) -> Dict[str, Any]:
    left = _cond_and(p)
    clauses = [left]
    while p.eat_word("or"):
        clauses.append(_cond_and(p))
    if len(clauses) == 1:
        return left
    return {"bool": {"should": clauses, "minimum_should_match": 1}}


def _cond_and(p: _P) -> Dict[str, Any]:
    left = _cond_not(p)
    clauses = [left]
    while p.eat_word("and"):
        clauses.append(_cond_not(p))
    if len(clauses) == 1:
        return left
    return {"bool": {"filter": clauses}}


def _cond_not(p: _P) -> Dict[str, Any]:
    if p.eat_word("not"):
        inner = _cond_not(p)
        return {"bool": {"must_not": [inner]}}
    return _cond_cmp(p)


def _literal(p: _P) -> Any:
    t = p.next()
    if t[0] in ("num", "str"):
        return t[1]
    if t[0] == "word":
        w = t[1].lower()
        if w == "true":
            return True
        if w == "false":
            return False
        if w == "null":
            return None
    raise IllegalArgumentError(f"EQL: expected a literal, got {t}")


def _cond_cmp(p: _P) -> Dict[str, Any]:
    t = p.peek()
    if t == ("op", "("):
        p.next()
        inner = _cond_or(p)
        p.expect_op(")")
        return inner
    t = p.next()
    if t[0] != "word":
        raise IllegalArgumentError(f"EQL: expected a field, got {t}")
    field = t[1]
    nxt = p.peek()
    # bare boolean condition: 'where true' / 'where false'
    if field.lower() in ("true", "false") and (
            nxt is None or nxt[0] != "op" or nxt[1] in (")", "]", "|")):
        if field.lower() == "true":
            return {"match_all": {}}
        return {"bool": {"must_not": [{"match_all": {}}]}}
    if nxt is None:
        raise IllegalArgumentError(
            f"EQL: dangling field [{field}] without an operator")
    if nxt[0] == "op":
        op = p.next()[1]
        value = _literal(p)
        if op == "=":
            op = "=="
        if op == "==":
            if value is None:
                return {"bool": {"must_not": [{"exists": {"field": field}}]}}
            return {"term": {field: value}}
        if op == "!=":
            if value is None:
                return {"exists": {"field": field}}
            return {"bool": {"must_not": [{"term": {field: value}}]}}
        rng = {">": "gt", ">=": "gte", "<": "lt", "<=": "lte"}[op]
        return {"range": {field: {rng: value}}}
    if nxt[0] == "word" and nxt[1].lower() == "in":
        p.next()
        p.expect_op("(")
        values = [_literal(p)]
        while p.peek() == ("op", ","):
            p.next()
            values.append(_literal(p))
        p.expect_op(")")
        return {"terms": {field: values}}
    if nxt[0] == "word" and nxt[1].lower() in ("like", "like~"):
        p.next()
        pat = _literal(p)
        return {"wildcard": {field: {"value": str(pat)}}}
    if nxt[0] == "word" and nxt[1].lower() in ("regex", "regex~"):
        p.next()
        pat = _literal(p)
        return {"regexp": {field: {"value": str(pat)}}}
    raise IllegalArgumentError(
        f"EQL: unsupported operator after [{field}]: {nxt}")


# ---------------------------------------------------------------------------
# query parsing
# ---------------------------------------------------------------------------

def _parse_stage(p: _P, category_field: str) -> Dict[str, Any]:
    """'<category> where <cond>' -> filter body."""
    t = p.next()
    if t[0] != "word":
        raise IllegalArgumentError(f"EQL: expected event category, got {t}")
    category = t[1]
    if not p.eat_word("where"):
        raise IllegalArgumentError("EQL: expected [where]")
    cond = _cond_or(p)
    clauses: List[Dict[str, Any]] = []
    if category != "any":
        clauses.append({"term": {category_field: category}})
    clauses.append(cond)
    return {"bool": {"filter": clauses}}


def parse_eql(text: str, category_field: str = "event.category"
              ) -> Dict[str, Any]:
    p = _P(tokenize(text))
    out: Dict[str, Any] = {"pipes": []}
    if p.eat_word("sequence"):
        by: List[str] = []
        maxspan: Optional[float] = None
        if p.eat_word("by"):
            t = p.next()
            by.append(t[1])
            while p.peek() == ("op", ","):
                p.next()
                by.append(p.next()[1])
        if p.eat_word("with"):
            t = p.next()
            if t[0] != "word" or t[1].lower() != "maxspan":
                raise IllegalArgumentError("EQL: expected maxspan=<span>")
            if p.peek() in (("op", "="), ("op", "==")):
                p.next()
            span_t = p.next()
            if span_t[0] == "num":
                # "10s" tokenizes as num 10 + unit word
                unit = p.peek()
                if unit is not None and unit[0] == "word" and \
                        unit[1].lower() in _UNITS_MS:
                    maxspan = float(span_t[1]) * \
                        _UNITS_MS[p.next()[1].lower()]
                else:
                    maxspan = float(span_t[1])
            else:
                maxspan = _span_ms(span_t)
        stages = []
        stage_by: List[List[str]] = []
        while p.peek() == ("op", "["):
            p.next()
            stages.append(_parse_stage(p, category_field))
            p.expect_op("]")
            # per-stage "by" keys JOIN POSITIONALLY across stages
            # ([a] by src [b] by dest joins a.src == b.dest); the global
            # "sequence by" keys prefix every stage's list
            sb: List[str] = []
            if p.eat_word("by"):
                sb.append(p.next()[1])
                while p.peek() == ("op", ","):
                    p.next()
                    sb.append(p.next()[1])
            stage_by.append(sb)
        if len(stages) < 2:
            raise IllegalArgumentError(
                "EQL: sequence requires at least 2 stages")
        arities = {len(sb) for sb in stage_by}
        if len(arities) > 1:
            raise IllegalArgumentError(
                "EQL: every sequence stage must declare the same number "
                "of [by] keys")
        out.update({"kind": "sequence", "stages": stages, "by": by,
                    "stage_by": stage_by, "maxspan_ms": maxspan})
    else:
        out.update({"kind": "event",
                    "filter": _parse_stage(p, category_field)})
    while p.peek() == ("op", "|"):
        p.next()
        t = p.next()
        if t[0] != "word" or t[1].lower() not in ("head", "tail"):
            raise IllegalArgumentError(f"EQL: unsupported pipe {t}")
        n = p.next()
        if n[0] != "num":
            raise IllegalArgumentError("EQL: pipe requires a count")
        out["pipes"].append((t[1].lower(), int(n[1])))
    if p.peek() is not None:
        raise IllegalArgumentError(
            f"EQL: trailing input at {p.peek()}")
    return out


def _span_ms(tok: Tuple[str, Any]) -> float:
    if tok[0] == "num":
        return float(tok[1])
    m = re.fullmatch(r"(\d+(?:\.\d+)?)(ms|s|m|h|d)", str(tok[1]))
    if not m:
        raise IllegalArgumentError(f"EQL: bad maxspan [{tok[1]}]")
    return float(m.group(1)) * _UNITS_MS[m.group(2)]


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

class EqlService:
    """Compiles and runs EQL searches against the node's search action
    (TransportEqlSearchAction analog)."""

    def __init__(self, node) -> None:
        self.node = node

    def search(self, index: str, body: Dict[str, Any],
               on_done: Callable) -> None:
        text = (body or {}).get("query")
        if not text:
            on_done(None, IllegalArgumentError(
                "EQL search requires [query]"))
            return
        ts_field = (body or {}).get("timestamp_field", "@timestamp")
        cat_field = (body or {}).get("event_category_field",
                                     "event.category")
        size = int((body or {}).get("size", DEFAULT_SIZE))
        try:
            plan = parse_eql(text, category_field=cat_field)
        except IllegalArgumentError as e:
            on_done(None, e)
            return
        if plan["kind"] == "event":
            self._event_search(index, plan, ts_field, size, on_done)
        else:
            self._sequence_search(index, plan, ts_field, size, on_done)

    def _apply_pipes(self, rows: List[Any], pipes) -> List[Any]:
        for kind, n in pipes:
            rows = rows[:n] if kind == "head" else rows[-n:]
        return rows

    def _event_search(self, index, plan, ts_field, size, on_done) -> None:
        want = size
        for kind, n in plan["pipes"]:
            want = max(want, n)
            if kind == "tail":
                # tail needs the LAST events overall, not the last of a
                # truncated ascending window
                want = SWEEP_SIZE

        def cb(resp, err):
            if err is not None:
                on_done(None, err)
                return
            hits = resp["hits"]["hits"]
            # a tail over a window that filled up may be missing the true
            # latest events — report partiality like the sequence path
            truncated = any(k == "tail" for k, _n in plan["pipes"]) \
                and len(hits) >= SWEEP_SIZE
            hits = self._apply_pipes(hits, plan["pipes"])[:size]
            on_done({
                "is_partial": truncated, "timed_out": False,
                "hits": {"total": resp["hits"]["total"],
                         "events": [self._event(h) for h in hits]}}, None)
        self.node.search_action.execute(index, {
            "query": plan["filter"], "size": max(want, size),
            "sort": [{ts_field: "asc"}]}, cb)

    def _event(self, hit) -> Dict[str, Any]:
        return {"_index": hit.get("_index"), "_id": hit["_id"],
                "_source": hit.get("_source", {})}

    def _sequence_search(self, index, plan, ts_field, size,
                         on_done) -> None:
        """One time-ordered sweep per stage, then a host-side ordered join
        keyed by the by-fields (TumblingWindow collapsed — sound for
        result sets within SWEEP_SIZE, reported via is_partial)."""
        stages = plan["stages"]
        results: List[Optional[List[Dict[str, Any]]]] = [None] * len(stages)
        pending = {"n": len(stages), "err": None}

        def stage_cb(idx):
            def cb(resp, err):
                if err is not None:
                    pending["err"] = pending["err"] or err
                else:
                    results[idx] = resp["hits"]["hits"]
                pending["n"] -= 1
                if pending["n"] == 0:
                    if pending["err"] is not None:
                        on_done(None, pending["err"])
                        return
                    self._join(plan, results, ts_field, size, on_done)
            return cb

        for i, stage in enumerate(stages):
            self.node.search_action.execute(index, {
                "query": stage, "size": SWEEP_SIZE,
                "sort": [{ts_field: "asc"}]}, stage_cb(i))

    def _join(self, plan, results, ts_field, size, on_done) -> None:
        by = plan["by"]
        stage_by = plan.get("stage_by") or [[] for _ in results]
        maxspan = plan["maxspan_ms"]
        from elasticsearch_tpu_torch.mapping.mappers import parse_date_millis

        def key_of(hit, stage_idx: int):
            src = hit.get("_source", {})
            fields = list(by) + list(stage_by[stage_idx])
            return tuple(_dotted(src, f) for f in fields)

        def ts_of(hit):
            src = hit.get("_source", {})
            v = _dotted(src, ts_field)
            try:
                return parse_date_millis(v)
            except Exception:  # noqa: BLE001 — unparseable ts sorts first
                return 0.0

        # per stage: key -> time-ordered events
        staged: List[Dict[Any, List[Tuple[float, Dict]]]] = []
        for si, hits in enumerate(results):
            d: Dict[Any, List[Tuple[float, Dict]]] = {}
            for h in hits:
                d.setdefault(key_of(h, si), []).append((ts_of(h), h))
            for lst in d.values():
                lst.sort(key=lambda x: x[0])
            staged.append(d)

        sequences = []
        for key in staged[0]:
            if any(key not in d for d in staged[1:]):
                continue
            # greedy earliest-completion matching per key, non-reusing
            used = [set() for _ in staged]
            while True:
                seq = self._match_one(staged, key, used, maxspan)
                if seq is None:
                    break
                sequences.append((key, seq))
        sequences.sort(key=lambda s: s[1][-1][0])   # by completion time
        sequences = self._apply_pipes(sequences, plan["pipes"])[:size]
        on_done({
            "is_partial": any(len(r) >= SWEEP_SIZE for r in results),
            "timed_out": False,
            "hits": {"total": {"value": len(sequences),
                               "relation": "eq"},
                     "sequences": [{
                         "join_keys": list(k),
                         "events": [self._event(h) for _t, h in seq]}
                         for k, seq in sequences]}}, None)

    def _match_one(self, staged, key, used, maxspan):
        """Earliest sequence of one event per stage, strictly ordered in
        time, within maxspan of the first event; events are consumed."""
        first_list = staged[0][key]
        for i0, (t0, h0) in enumerate(first_list):
            if i0 in used[0]:
                continue
            chosen = [(t0, h0)]
            idxs = [i0]
            ok = True
            t_prev = t0
            for s in range(1, len(staged)):
                found = False
                for j, (t, h) in enumerate(staged[s][key]):
                    if j in used[s] or t < t_prev:
                        continue
                    if maxspan is not None and t - t0 > maxspan:
                        break
                    chosen.append((t, h))
                    idxs.append(j)
                    t_prev = t
                    found = True
                    break
                if not found:
                    ok = False
                    break
            if ok:
                for s, j in enumerate(idxs):
                    used[s].add(j)
                return chosen
        return None


def _dotted(src: Dict[str, Any], path: str) -> Any:
    node: Any = src
    for part in path.split("."):
        if isinstance(node, dict):
            node = node.get(part)
        else:
            return None
    return node
