"""SQL: a typed subset of the reference's x-pack SQL, compiled to the DSL.

Reference: x-pack/plugin/sql — parser -> logical plan -> QueryContainer
translated into a search request, rows streamed back with a columns
header. This build implements the high-traffic subset with a hand-rolled
tokenizer + recursive-descent parser (no ANTLR):

  SELECT */cols/aggfns FROM index [WHERE cond] [GROUP BY cols]
      [ORDER BY col [ASC|DESC], ...] [LIMIT n]

  cond: comparisons (= != <> > >= < <=), AND/OR/NOT, parentheses,
        IN (...), BETWEEN a AND b, LIKE 'pat%' (%/_ -> wildcard),
        IS [NOT] NULL
  aggs: COUNT(*), COUNT(col), SUM/AVG/MIN/MAX(col) with GROUP BY
        compiled onto the composite aggregation

POST /_sql returns {columns, rows}; POST /_sql/translate returns the
search body the query compiles to (the reference's translate API).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError

MAX_ROWS = 1000
MAX_GROUPS = 10_000

_TOKEN_RX = re.compile(r"""
    \s*(?:
      (?P<num>-?\d+(?:\.\d+)?)
    | '(?P<str>(?:[^']|'')*)'
    | "(?P<qid>(?:[^"]|"")*)"
    | (?P<op><=|>=|<>|!=|=|<|>|\(|\)|,|\*)
    | (?P<word>[A-Za-z_][A-Za-z0-9_.\-]*)
    )""", re.VERBOSE)

_KEYWORDS = {"SELECT", "FROM", "WHERE", "GROUP", "BY", "ORDER", "LIMIT",
             "AND", "OR", "NOT", "IN", "BETWEEN", "LIKE", "IS", "NULL",
             "AS", "ASC", "DESC", "TRUE", "FALSE", "HAVING"}
_AGG_FNS = {"COUNT", "SUM", "AVG", "MIN", "MAX"}


def tokenize(text: str) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RX.match(text, pos)
        if m is None:
            if text[pos:].strip() == "":
                break
            raise IllegalArgumentError(
                f"SQL: cannot tokenize at [{text[pos:pos + 20]!r}]")
        pos = m.end()
        if m.group("num") is not None:
            n = float(m.group("num"))
            out.append(("num", int(n) if n.is_integer() else n))
        elif m.group("str") is not None:
            out.append(("str", m.group("str").replace("''", "'")))
        elif m.group("qid") is not None:
            out.append(("ident", m.group("qid").replace('""', '"')))
        elif m.group("op") is not None:
            out.append(("op", m.group("op")))
        else:
            word = m.group("word")
            if word.upper() in _KEYWORDS or word.upper() in _AGG_FNS:
                out.append(("kw", word.upper()))
            else:
                out.append(("ident", word))
    out.append(("end", None))
    return out


class _Parser:
    def __init__(self, tokens: List[Tuple[str, Any]]):
        self.tokens = tokens
        self.i = 0

    def peek(self) -> Tuple[str, Any]:
        return self.tokens[self.i]

    def next(self) -> Tuple[str, Any]:
        tok = self.tokens[self.i]
        self.i += 1
        return tok

    def expect_kw(self, word: str) -> None:
        kind, value = self.next()
        if kind != "kw" or value != word:
            raise IllegalArgumentError(f"SQL: expected {word}, got {value!r}")

    def accept_kw(self, word: str) -> bool:
        kind, value = self.peek()
        if kind == "kw" and value == word:
            self.i += 1
            return True
        return False

    def accept_op(self, op: str) -> bool:
        kind, value = self.peek()
        if kind == "op" and value == op:
            self.i += 1
            return True
        return False

    def ident(self) -> str:
        kind, value = self.next()
        if kind != "ident":
            raise IllegalArgumentError(
                f"SQL: expected identifier, got {value!r}")
        return value

    # -- grammar ----------------------------------------------------------

    def parse(self) -> Dict[str, Any]:
        self.expect_kw("SELECT")
        select = self._select_items()
        self.expect_kw("FROM")
        index = self.ident()
        where = None
        if self.accept_kw("WHERE"):
            where = self._expr()
        group_by: List[str] = []
        if self.accept_kw("GROUP"):
            self.expect_kw("BY")
            group_by.append(self.ident())
            while self.accept_op(","):
                group_by.append(self.ident())
        if self.accept_kw("HAVING"):
            raise IllegalArgumentError("SQL: HAVING is not supported")
        order_by: List[Tuple[str, str]] = []
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            while True:
                col = self.ident()
                direction = "asc"
                if self.accept_kw("DESC"):
                    direction = "desc"
                else:
                    self.accept_kw("ASC")
                order_by.append((col, direction))
                if not self.accept_op(","):
                    break
        limit = None
        if self.accept_kw("LIMIT"):
            kind, value = self.next()
            if kind != "num":
                raise IllegalArgumentError("SQL: LIMIT expects a number")
            limit = int(value)
        kind, value = self.next()
        if kind != "end":
            raise IllegalArgumentError(f"SQL: unexpected trailing {value!r}")
        return {"select": select, "index": index, "where": where,
                "group_by": group_by, "order_by": order_by, "limit": limit}

    def _select_items(self) -> List[Dict[str, Any]]:
        if self.accept_op("*"):
            return [{"kind": "star"}]
        items = []
        while True:
            kind, value = self.peek()
            if kind == "kw" and value in _AGG_FNS:
                self.next()
                fn = value
                if not self.accept_op("("):
                    raise IllegalArgumentError(f"SQL: {fn} expects (...)")
                if self.accept_op("*"):
                    arg = "*"
                else:
                    arg = self.ident()
                if not self.accept_op(")"):
                    raise IllegalArgumentError(f"SQL: {fn} missing )")
                name = f"{fn}({arg})"
                if self.accept_kw("AS"):
                    name = self.ident()
                items.append({"kind": "agg", "fn": fn, "arg": arg,
                              "name": name})
            else:
                col = self.ident()
                name = col
                if self.accept_kw("AS"):
                    name = self.ident()
                items.append({"kind": "col", "col": col, "name": name})
            if not self.accept_op(","):
                return items

    def _expr(self):
        node = self._and_expr()
        while self.accept_kw("OR"):
            rhs = self._and_expr()
            node = {"bool": {"should": [node, rhs],
                             "minimum_should_match": 1}}
        return node

    def _and_expr(self):
        node = self._not_expr()
        while self.accept_kw("AND"):
            rhs = self._not_expr()
            node = {"bool": {"must": [node, rhs]}}
        return node

    def _not_expr(self):
        if self.accept_kw("NOT"):
            return {"bool": {"must_not": [self._not_expr()]}}
        return self._primary()

    def _literal(self) -> Any:
        kind, value = self.next()
        if kind in ("num", "str"):
            return value
        if kind == "kw" and value in ("TRUE", "FALSE"):
            return value == "TRUE"
        raise IllegalArgumentError(f"SQL: expected literal, got {value!r}")

    def _primary(self):
        if self.accept_op("("):
            node = self._expr()
            if not self.accept_op(")"):
                raise IllegalArgumentError("SQL: missing )")
            return node
        col = self.ident()
        if self.accept_kw("IS"):
            negate = self.accept_kw("NOT")
            self.expect_kw("NULL")
            exists = {"exists": {"field": col}}
            return exists if negate else \
                {"bool": {"must_not": [exists]}}
        if self.accept_kw("IN"):
            if not self.accept_op("("):
                raise IllegalArgumentError("SQL: IN expects (...)")
            values = [self._literal()]
            while self.accept_op(","):
                values.append(self._literal())
            if not self.accept_op(")"):
                raise IllegalArgumentError("SQL: IN missing )")
            return {"terms": {col: values}}
        if self.accept_kw("BETWEEN"):
            lo = self._literal()
            self.expect_kw("AND")
            hi = self._literal()
            return {"range": {col: {"gte": lo, "lte": hi}}}
        if self.accept_kw("LIKE"):
            pat = self._literal()
            # literal wildcard metachars in the pattern must stay literal
            # (SQL LIKE has no '*'/'?'); fnmatch-class escapes via [..]
            wildcard = (str(pat)
                        .replace("[", "[[]").replace("*", "[*]")
                        .replace("?", "[?]")
                        .replace("%", "*").replace("_", "?"))
            return {"wildcard": {col: {"value": wildcard}}}
        for op, clause in (("<=", "lte"), (">=", "gte"),
                           ("<", "lt"), (">", "gt")):
            if self.accept_op(op):
                return {"range": {col: {clause: self._literal()}}}
        if self.accept_op("="):
            return {"term": {col: {"value": self._literal()}}}
        if self.accept_op("!=") or self.accept_op("<>"):
            return {"bool": {"must_not": [
                {"term": {col: {"value": self._literal()}}}]}}
        raise IllegalArgumentError(
            f"SQL: expected operator after [{col}]")


# ---------------------------------------------------------------------------
# translation + execution
# ---------------------------------------------------------------------------

def parse_sql(text: str) -> Dict[str, Any]:
    return _Parser(tokenize(text)).parse()


def _agg_body(item: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The metric-agg body for one select item; None when doc_count (or
    hit total) answers it. COUNT(col) counts docs WITH the column —
    value_count, never doc_count."""
    if item["fn"] == "COUNT" and item["arg"] == "*":
        return None
    if item["fn"] == "COUNT":
        return {"value_count": {"field": item["arg"]}}
    return {item["fn"].lower(): {"field": item["arg"]}}


def _validate_order_by(plan: Dict[str, Any]) -> None:
    """GROUP BY ordering applies host-side to SELECTed names — reject
    unknown columns BEFORE any search work runs."""
    names = [i["name"] for i in plan["select"]]
    for col, _d in plan["order_by"]:
        if col not in names:
            raise IllegalArgumentError(
                f"SQL: ORDER BY [{col}] must appear in SELECT")


def translate(plan: Dict[str, Any]) -> Dict[str, Any]:
    """The search body a parsed SQL plan compiles to (_sql/translate)."""
    body: Dict[str, Any] = {}
    if plan["where"] is not None:
        body["query"] = plan["where"]
    limit = plan["limit"] if plan["limit"] is not None else MAX_ROWS
    has_aggs = any(i["kind"] == "agg" for i in plan["select"])
    if plan["group_by"]:
        _validate_order_by(plan)
        aggs = {}
        for item in plan["select"]:
            if item["kind"] != "agg":
                continue
            agg = _agg_body(item)
            if agg is not None:
                aggs[item["name"]] = agg
        body["size"] = 0
        body["aggs"] = {"groups": {
            "composite": {
                # all groups in one page (capped) — ORDER BY/LIMIT apply
                # to the full group set host-side
                "size": MAX_GROUPS,
                "sources": [{col: {"terms": {"field": col}}}
                            for col in plan["group_by"]],
            },
            **({"aggs": aggs} if aggs else {}),
        }}
        return body
    if has_aggs:
        # implicit global group: SELECT COUNT(*), MAX(x) FROM idx is one
        # row over every match (the reference's implicit grouping)
        if any(i["kind"] != "agg" for i in plan["select"]):
            raise IllegalArgumentError(
                "SQL: mixing aggregates and columns requires GROUP BY")
        body["size"] = 0
        body["track_total_hits"] = True
        aggs = {}
        for item in plan["select"]:
            agg = _agg_body(item)
            if agg is not None:
                aggs[item["name"]] = agg
        if aggs:
            body["aggs"] = aggs
        return body
    body["size"] = min(limit, MAX_ROWS)
    cols = [item["col"] for item in plan["select"]
            if item["kind"] == "col"]
    if cols:
        body["_source"] = cols
    if plan["order_by"]:
        # ORDER BY a SELECT alias sorts the underlying field; anything
        # else passes through as a document field name
        aliases = {i["name"]: i["col"] for i in plan["select"]
                   if i["kind"] == "col"}
        body["sort"] = [{aliases.get(c, c): d}
                        for c, d in plan["order_by"]]
    return body


def _field_from(source: Dict[str, Any], path: str) -> Any:
    node: Any = source
    for part in path.split("."):
        if isinstance(node, dict) and part in node:
            node = node[part]
        else:
            return None
    return node


class SqlService:
    def __init__(self, node) -> None:
        self.node = node

    def query(self, sql_text: str, on_done: Callable) -> None:
        try:
            plan = parse_sql(sql_text)
            body = translate(plan)
        except IllegalArgumentError as e:
            on_done(None, e)
            return
        if plan["group_by"]:
            self._grouped(plan, body, on_done)
        elif any(i["kind"] == "agg" for i in plan["select"]):
            self._global_aggs(plan, body, on_done)
        else:
            self._rows(plan, body, on_done)

    # -- implicit global grouping -----------------------------------------

    def _global_aggs(self, plan, body, on_done) -> None:
        def cb(resp, err):
            if err is not None:
                on_done(None, err)
                return
            aggs = resp.get("aggregations") or {}
            row = []
            for item in plan["select"]:
                if item["fn"] == "COUNT" and item["arg"] == "*":
                    row.append(resp["hits"]["total"]["value"])
                else:
                    row.append((aggs.get(item["name"]) or {}).get("value"))
            names = [i["name"] for i in plan["select"]]
            on_done({"columns": [{"name": n, "type": _col_type([row], i)}
                                 for i, n in enumerate(names)],
                     "rows": [row]}, None)
        self.node.search_action.execute(plan["index"], body, cb)

    # -- plain SELECT ------------------------------------------------------

    def _rows(self, plan, body, on_done) -> None:
        def cb(resp, err):
            if err is not None:
                on_done(None, err)
                return
            hits = resp["hits"]["hits"]
            star = any(i["kind"] == "star" for i in plan["select"])
            if star:
                names: List[str] = []
                for h in hits:
                    for k in (h.get("_source") or {}):
                        if k not in names:
                            names.append(k)
                paths = {n: n for n in names}
            else:
                names = [i["name"] for i in plan["select"]]
                paths = {i["name"]: i["col"] for i in plan["select"]
                         if i["kind"] == "col"}
            rows = []
            for h in hits:
                src = h.get("_source") or {}
                rows.append([_field_from(src, paths.get(n, n))
                             for n in names])
            on_done({"columns": [{"name": n, "type": _col_type(rows, i)}
                                 for i, n in enumerate(names)],
                     "rows": rows}, None)
        self.node.search_action.execute(plan["index"], body, cb)

    # -- GROUP BY ----------------------------------------------------------

    def _grouped(self, plan, body, on_done) -> None:
        def cb(resp, err):
            if err is not None:
                on_done(None, err)
                return
            buckets = resp["aggregations"]["groups"]["buckets"]
            names = [i["name"] for i in plan["select"]]
            rows = []
            for b in buckets:
                row = []
                for item in plan["select"]:
                    if item["kind"] == "col":
                        row.append(b["key"].get(item["col"]))
                    elif item["kind"] == "star" or (
                            item["fn"] == "COUNT" and item["arg"] == "*"):
                        row.append(b["doc_count"])
                    else:
                        # COUNT(col) rides its value_count agg, so docs
                        # missing the column are excluded, unlike doc_count
                        row.append((b.get(item["name"]) or {}).get("value"))
                rows.append(row)
            # ORDER BY on group keys or aggregate aliases, host-side
            # (validated against SELECT names before execution)
            for col, direction in reversed(plan["order_by"]):
                idx = names.index(col)
                rows.sort(key=lambda r: (r[idx] is None, r[idx]),
                          reverse=(direction == "desc"))
            if plan["limit"] is not None:
                rows = rows[: plan["limit"]]
            on_done({"columns": [{"name": n, "type": _col_type(rows, i)}
                                 for i, n in enumerate(names)],
                     "rows": rows}, None)
        self.node.search_action.execute(plan["index"], body, cb)


def _col_type(rows: List[List[Any]], i: int) -> str:
    for row in rows:
        v = row[i]
        if isinstance(v, bool):
            return "boolean"
        if isinstance(v, int):
            return "long"
        if isinstance(v, float):
            return "double"
        if isinstance(v, str):
            return "keyword"
    return "null"
