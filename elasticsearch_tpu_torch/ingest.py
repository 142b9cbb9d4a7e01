"""Ingest pipelines: pre-index document transformation.

Reference analogs: ingest/IngestService.java:75 (pipeline registry lives in
cluster state; executed before routing to the primary), Pipeline/
CompoundProcessor/ConditionalProcessor, and the processor pack of
modules/ingest-common/ (grok, dissect, date, convert, set/remove/rename,
script, …). Pipelines run on the coordinating node here (this framework
routes ingest through whichever node takes the request — the ingest-role
split is a deployment choice, not a code path).

A processor is ``fn(doc) -> doc | None`` where ``doc`` is the mutable
ingest document view {"_source": {...}, "_index": ..., "_id": ...,
"_routing": ...}; ``None`` means the document was dropped.
"""

from __future__ import annotations

import json as json_mod
import re
from typing import Any, Callable, Dict, List, Optional

from elasticsearch_tpu_torch.utils.errors import (
    IllegalArgumentError, SearchEngineError,
)

PIPELINE_SETTING_PREFIX = "pipeline."


class IngestProcessorError(SearchEngineError):
    status = 400


# ---------------------------------------------------------------------------
# dotted-path field access over _source
# ---------------------------------------------------------------------------

def _resolve_field(doc: Dict[str, Any], path: str):
    """(container, key) for a dotted path; metadata fields hit the doc
    root, everything else lives under _source."""
    if path.startswith("_") and "." not in path:
        return doc, path
    container = doc["_source"]
    parts = path.split(".")
    for p in parts[:-1]:
        nxt = container.get(p)
        if not isinstance(nxt, dict):
            return None, parts[-1]
        container = nxt
    return container, parts[-1]


def get_field(doc: Dict[str, Any], path: str, default=None):
    container, key = _resolve_field(doc, path)
    if container is None:
        return default
    return container.get(key, default)


def has_field(doc: Dict[str, Any], path: str) -> bool:
    container, key = _resolve_field(doc, path)
    return container is not None and key in container

def set_field(doc: Dict[str, Any], path: str, value: Any) -> None:
    if path.startswith("_") and "." not in path:
        doc[path] = value
        return
    container = doc["_source"]
    parts = path.split(".")
    for p in parts[:-1]:
        nxt = container.get(p)
        if not isinstance(nxt, dict):
            nxt = {}
            container[p] = nxt
        container = nxt
    container[parts[-1]] = value


def remove_field(doc: Dict[str, Any], path: str) -> bool:
    container, key = _resolve_field(doc, path)
    if container is not None and key in container:
        del container[key]
        return True
    return False


def _render_template(tmpl: Any, doc: Dict[str, Any]) -> Any:
    """'{{field}}' mustache-lite substitution in string values."""
    if not isinstance(tmpl, str) or "{{" not in tmpl:
        return tmpl

    def sub(m):
        v = get_field(doc, m.group(1).strip())
        return "" if v is None else str(v)
    return re.sub(r"\{\{\s*([^}]+?)\s*\}\}", sub, tmpl)


# ---------------------------------------------------------------------------
# processors
# ---------------------------------------------------------------------------

Processor = Callable[[Dict[str, Any]], Optional[Dict[str, Any]]]


def _p_set(cfg):
    field, value = _req(cfg, "set", "field"), cfg.get("value")
    copy_from = cfg.get("copy_from")
    override = cfg.get("override", True)

    def run(doc):
        if not override and get_field(doc, field) is not None:
            return doc
        v = (get_field(doc, copy_from) if copy_from
             else _render_template(value, doc))
        set_field(doc, field, v)
        return doc
    return run


def _p_remove(cfg):
    fields = _req(cfg, "remove", "field")
    fields = fields if isinstance(fields, list) else [fields]
    ignore_missing = cfg.get("ignore_missing", False)

    def run(doc):
        for f in fields:
            if not remove_field(doc, f) and not ignore_missing:
                raise IngestProcessorError(f"field [{f}] not present")
        return doc
    return run


def _p_rename(cfg):
    field, target = _req(cfg, "rename", "field"), \
        _req(cfg, "rename", "target_field")
    ignore_missing = cfg.get("ignore_missing", False)

    def run(doc):
        if not has_field(doc, field):
            if ignore_missing:
                return doc
            raise IngestProcessorError(f"field [{field}] not present")
        v = get_field(doc, field)
        remove_field(doc, field)
        set_field(doc, target, v)
        return doc
    return run


def _p_append(cfg):
    field, value = _req(cfg, "append", "field"), cfg.get("value")

    def run(doc):
        cur = get_field(doc, field)
        add = value if isinstance(value, list) else [value]
        add = [_render_template(v, doc) for v in add]
        if cur is None:
            set_field(doc, field, list(add))
        elif isinstance(cur, list):
            cur.extend(add)
        else:
            set_field(doc, field, [cur, *add])
        return doc
    return run


_CONVERTERS = {
    "integer": int,
    "long": int,
    "float": float, "double": float,
    "string": str,
    "boolean": lambda v: (v if isinstance(v, bool) else
                          str(v).lower() in ("true", "1", "yes")),
    "auto": lambda v: _auto_convert(v),
}


def _auto_convert(v):
    if not isinstance(v, str):
        return v
    for fn in (int, float):
        try:
            return fn(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v


def _p_convert(cfg):
    field = _req(cfg, "convert", "field")
    ctype = _req(cfg, "convert", "type")
    target = cfg.get("target_field", field)
    ignore_missing = cfg.get("ignore_missing", False)
    conv = _CONVERTERS.get(ctype)
    if conv is None:
        raise IllegalArgumentError(f"convert type [{ctype}] not supported")

    def run(doc):
        v = get_field(doc, field)
        if v is None:
            if ignore_missing:
                return doc
            raise IngestProcessorError(f"field [{field}] not present")
        try:
            if isinstance(v, list):
                set_field(doc, target, [conv(x) for x in v])
            else:
                set_field(doc, target, conv(v))
        except (ValueError, TypeError) as e:
            raise IngestProcessorError(
                f"failed to convert field [{field}]: {e}")
        return doc
    return run


def _p_date(cfg):
    field = _req(cfg, "date", "field")
    target = cfg.get("target_field", "@timestamp")
    formats = cfg.get("formats", ["ISO8601"])

    def run(doc):
        from elasticsearch_tpu_torch.mapping.mappers import parse_date_millis
        v = get_field(doc, field)
        if v is None:
            raise IngestProcessorError(f"field [{field}] not present")
        last: Optional[Exception] = None
        for fmt in formats:
            try:
                if fmt in ("ISO8601", "strict_date_optional_time"):
                    millis = parse_date_millis(v)
                elif fmt == "UNIX":
                    millis = int(float(v) * 1000)
                elif fmt == "UNIX_MS":
                    millis = int(v)
                else:
                    import datetime as dt
                    millis = int(dt.datetime.strptime(
                        str(v), fmt).replace(
                        tzinfo=dt.timezone.utc).timestamp() * 1000)
                import datetime as dt
                iso = dt.datetime.fromtimestamp(
                    millis / 1000.0, tz=dt.timezone.utc).strftime(
                    "%Y-%m-%dT%H:%M:%S.%f")[:-3] + "Z"
                set_field(doc, target, iso)
                return doc
            except (ValueError, TypeError) as e:
                last = e
        raise IngestProcessorError(
            f"unable to parse date [{v}]: {last}")
    return run


def _str_proc(name, fn):
    def make(cfg):
        field = _req(cfg, name, "field")
        target = cfg.get("target_field", field)
        ignore_missing = cfg.get("ignore_missing", False)

        def run(doc):
            v = get_field(doc, field)
            if v is None:
                if ignore_missing:
                    return doc
                raise IngestProcessorError(f"field [{field}] not present")
            set_field(doc, target,
                      [fn(cfg, x) for x in v] if isinstance(v, list)
                      else fn(cfg, v))
            return doc
        return run
    return make


def _p_split(cfg):
    sep = _req(cfg, "split", "separator")
    return _str_proc("split", lambda c, v: re.split(sep, v))(cfg)


def _p_join(cfg):
    # operates on the list itself (not per element like other str procs)
    field = _req(cfg, "join", "field")
    sep = _req(cfg, "join", "separator")
    target = cfg.get("target_field", field)

    def run(doc):
        v = get_field(doc, field)
        if not isinstance(v, list):
            raise IngestProcessorError(f"field [{field}] is not a list")
        set_field(doc, target, sep.join(str(x) for x in v))
        return doc
    return run


def _p_gsub(cfg):
    pattern = re.compile(_req(cfg, "gsub", "pattern"))
    replacement = _req(cfg, "gsub", "replacement")
    return _str_proc("gsub",
                     lambda c, v: pattern.sub(replacement, v))(cfg)


def _p_json(cfg):
    field = _req(cfg, "json", "field")
    target = cfg.get("target_field")
    add_to_root = cfg.get("add_to_root", False)

    def run(doc):
        v = get_field(doc, field)
        try:
            parsed = json_mod.loads(v)
        except (TypeError, ValueError) as e:
            raise IngestProcessorError(f"invalid json in [{field}]: {e}")
        if add_to_root and isinstance(parsed, dict):
            doc["_source"].update(parsed)
        else:
            set_field(doc, target or field, parsed)
        return doc
    return run


def _p_kv(cfg):
    field = _req(cfg, "kv", "field")
    field_split = _req(cfg, "kv", "field_split")
    value_split = _req(cfg, "kv", "value_split")
    target = cfg.get("target_field")

    def run(doc):
        v = get_field(doc, field)
        if not isinstance(v, str):
            raise IngestProcessorError(f"field [{field}] is not a string")
        out = {}
        for pair in re.split(field_split, v):
            if not pair:
                continue
            parts = re.split(value_split, pair, maxsplit=1)
            if len(parts) == 2:
                out[parts[0]] = parts[1]
        base = target or ""
        for k, val in out.items():
            set_field(doc, f"{base}.{k}" if base else k, val)
        return doc
    return run


def _p_script(cfg):
    script = cfg.get("script", cfg)

    def run(doc):
        from elasticsearch_tpu_torch.script.engine import execute_update_script
        result = execute_update_script(doc["_source"], script)
        if result is None:
            return None      # ctx.op = 'delete' → drop
        doc["_source"] = result
        return doc
    return run


def _p_fail(cfg):
    message = _req(cfg, "fail", "message")

    def run(doc):
        raise IngestProcessorError(_render_template(message, doc))
    return run


def _p_drop(cfg):
    def run(doc):
        return None
    return run


def _p_trim(cfg):
    return _str_proc("trim", lambda c, v: v.strip())(cfg)


def _p_lowercase(cfg):
    return _str_proc("lowercase", lambda c, v: v.lower())(cfg)


def _p_uppercase(cfg):
    return _str_proc("uppercase", lambda c, v: v.upper())(cfg)


def _p_html_strip(cfg):
    return _str_proc("html_strip",
                     lambda c, v: re.sub(r"<[^>]*>", "", v))(cfg)


def _p_bytes(cfg):
    units = {"b": 1, "kb": 1024, "mb": 1024**2, "gb": 1024**3,
             "tb": 1024**4, "pb": 1024**5}

    def conv(c, v):
        m = re.fullmatch(r"\s*([\d.]+)\s*([kmgtp]?b)\s*", str(v).lower())
        if not m:
            raise IngestProcessorError(f"cannot parse bytes [{v}]")
        return int(float(m.group(1)) * units[m.group(2)])
    return _str_proc("bytes", conv)(cfg)


# -- dissect ---------------------------------------------------------------

def _p_dissect(cfg):
    field = _req(cfg, "dissect", "field")
    pattern = _req(cfg, "dissect", "pattern")
    append_sep = cfg.get("append_separator", "")
    keys: List[str] = []
    regex_parts: List[str] = []
    last = 0
    for m in re.finditer(r"%\{([^}]*)\}", pattern):
        regex_parts.append(re.escape(pattern[last:m.start()]))
        key = m.group(1)
        keys.append(key)
        regex_parts.append("(.*?)" if m.end() != len(pattern) else "(.*)")
        last = m.end()
    regex_parts.append(re.escape(pattern[last:]))
    rx = re.compile("".join(regex_parts), re.DOTALL)

    def run(doc):
        v = get_field(doc, field)
        if not isinstance(v, str):
            raise IngestProcessorError(f"field [{field}] is not a string")
        m = rx.fullmatch(v)
        if m is None:
            raise IngestProcessorError(
                f"dissect pattern does not match field value [{v}]")
        appended: Dict[str, List[str]] = {}
        for key, val in zip(keys, m.groups()):
            if not key or key.startswith("?"):
                continue
            if key.startswith("+"):
                appended.setdefault(key[1:], []).append(val)
            else:
                set_field(doc, key, val)
        for key, vals in appended.items():
            prev = get_field(doc, key)
            parts = ([prev] if prev is not None else []) + vals
            set_field(doc, key, append_sep.join(parts))
        return doc
    return run


# -- grok ------------------------------------------------------------------

GROK_PATTERNS = {
    "WORD": r"\b\w+\b",
    "NOTSPACE": r"\S+",
    "SPACE": r"\s*",
    "DATA": r".*?",
    "GREEDYDATA": r".*",
    "INT": r"[+-]?(?:[0-9]+)",
    "NUMBER": r"[+-]?(?:[0-9]+(?:\.[0-9]+)?)",
    "BASE10NUM": r"[+-]?(?:[0-9]+(?:\.[0-9]+)?)",
    "POSINT": r"\b[1-9][0-9]*\b",
    "IP": r"(?:\d{1,3}\.){3}\d{1,3}",
    "IPORHOST": r"(?:(?:\d{1,3}\.){3}\d{1,3}|[\w.-]+)",
    "HOSTNAME": r"[\w.-]+",
    "USER": r"[a-zA-Z0-9._-]+",
    "USERNAME": r"[a-zA-Z0-9._-]+",
    "EMAILADDRESS": r"[^@\s]+@[^@\s]+",
    "UUID": r"[0-9a-fA-F]{8}(?:-[0-9a-fA-F]{4}){3}-[0-9a-fA-F]{12}",
    "TIMESTAMP_ISO8601":
        r"\d{4}-\d{2}-\d{2}[T ]\d{2}:\d{2}(?::\d{2}(?:\.\d+)?)?"
        r"(?:Z|[+-]\d{2}:?\d{2})?",
    "LOGLEVEL": r"(?:TRACE|DEBUG|INFO|NOTICE|WARN(?:ING)?|ERROR|"
                r"CRIT(?:ICAL)?|FATAL|SEVERE|EMERG(?:ENCY)?)",
    "HTTPDATE": r"\d{2}/\w{3}/\d{4}:\d{2}:\d{2}:\d{2} [+-]\d{4}",
    "QS": r"\"[^\"]*\"",
    "QUOTEDSTRING": r"\"[^\"]*\"",
    "PATH": r"(?:/[\w.-]*)+",
    "URIPATH": r"(?:/[\w.,:;=@#%&!$'*+()\[\]~-]*)+",
}


def _grok_to_regex(pattern: str) -> re.Pattern:
    out = []
    last = 0
    for m in re.finditer(r"%\{(\w+)(?::([\w.\[\]@]+))?(?::\w+)?\}",
                        pattern):
        out.append(pattern[last:m.start()])
        name, capture = m.group(1), m.group(2)
        base = GROK_PATTERNS.get(name)
        if base is None:
            raise IllegalArgumentError(f"unknown grok pattern [{name}]")
        if capture:
            group = capture.replace(".", "__DOT__").replace(
                "[", "").replace("]", "").replace("@", "__AT__")
            out.append(f"(?P<{group}>{base})")
        else:
            out.append(f"(?:{base})")
        last = m.end()
    out.append(pattern[last:])
    return re.compile("".join(out))


def _p_grok(cfg):
    field = _req(cfg, "grok", "field")
    patterns = cfg.get("patterns") or [cfg.get("pattern")]
    ignore_missing = cfg.get("ignore_missing", False)
    compiled = [_grok_to_regex(p) for p in patterns if p]
    if not compiled:
        raise IllegalArgumentError("grok requires [patterns]")

    def run(doc):
        v = get_field(doc, field)
        if v is None:
            if ignore_missing:
                return doc
            raise IngestProcessorError(f"field [{field}] not present")
        for rx in compiled:
            m = rx.search(str(v))
            if m:
                for group, val in m.groupdict().items():
                    if val is not None:
                        path = group.replace("__DOT__", ".").replace(
                            "__AT__", "@")
                        set_field(doc, path, val)
                return doc
        raise IngestProcessorError(
            f"grok patterns do not match field value [{v}]")
    return run


def _req(cfg: Dict[str, Any], proc: str, key: str):
    v = cfg.get(key)
    if v is None:
        raise IllegalArgumentError(
            f"[{proc}] processor requires [{key}]")
    return v


def _p_inference(cfg: Dict[str, Any], device=None) -> Processor:
    """Learned sparse expansion at ingest time (InferenceProcessor analog,
    x-pack/plugin/ml/.../inference/ingest/InferenceProcessor.java): runs
    the text_expansion model on a source text field and writes the
    (feature, weight) map to a rank_features target — the document half of
    the ELSER pipeline. The bulk path prewarms the model's expansion cache
    with ONE batched device dispatch for the whole chunk
    (IngestService.prewarm_inference), so the per-document run here is a
    cache hit; standalone (simulate / single doc) it dispatches once.
    ``device``: where the model runs (the node's device; None = the CUDA
    card)."""
    field = _req(cfg, "inference", "field")
    target = cfg.get("target_field", "ml.tokens")
    model_id = cfg.get("model_id")
    ignore_missing = cfg.get("ignore_missing", False)

    def run(doc):
        v = get_field(doc, field)
        if v is None:
            if ignore_missing:
                return doc
            raise IngestProcessorError(f"field [{field}] not present")
        from elasticsearch_tpu_torch.ml import get_model
        set_field(doc, target, get_model(model_id, device).expand(str(v)))
        return doc
    return run


_UA_BROWSERS = [
    # (name, regex with version groups) — order matters: specific first
    # (modules/ingest-user-agent UserAgentParser's regexes, distilled to
    # the dominant families)
    ("Edge", r"Edg(?:e|A|iOS)?/(\d+)(?:\.(\d+))?"),
    ("Opera", r"OPR/(\d+)(?:\.(\d+))?"),
    ("Chrome", r"Chrome/(\d+)(?:\.(\d+))?"),
    ("Firefox", r"Firefox/(\d+)(?:\.(\d+))?"),
    ("Safari", r"Version/(\d+)(?:\.(\d+))?.*Safari"),
    ("IE", r"MSIE (\d+)(?:\.(\d+))?|Trident/.*rv:(\d+)"),
    ("curl", r"curl/(\d+)(?:\.(\d+))?"),
]

_UA_OS = [
    ("Windows", r"Windows NT (\d+)(?:\.(\d+))?"),
    ("iOS", r"iPhone OS (\d+)(?:[._](\d+))?"),
    ("Mac OS X", r"Mac OS X (\d+)(?:[._](\d+))?"),
    ("Android", r"Android (\d+)(?:\.(\d+))?"),
    ("Linux", r"Linux"),
]

# Spider FIRST: smartphone-crawler UAs carry both "Android/Mobile" and
# "bot" markers and must classify as Spider (ingest-user-agent parity)
_UA_DEVICE = [("Spider", r"bot|crawler|spider"),
              ("iPhone", r"iPhone"), ("iPad", r"iPad"),
              ("Mobile", r"Mobile|Android")]


def _p_user_agent(cfg):
    """modules/ingest-user-agent UserAgentProcessor analog: parse a UA
    string into name/version/os/device fields."""
    import re as _re
    field = _req(cfg, "user_agent", "field")
    target = cfg.get("target_field", "user_agent")
    ignore_missing = cfg.get("ignore_missing", False)

    def run(doc):
        ua = get_field(doc, field)
        if ua is None:
            if ignore_missing:
                return doc
            raise IngestProcessorError(f"field [{field}] not present")
        ua = str(ua)
        out: Dict[str, Any] = {"name": "Other", "original": ua}
        for name, rx in _UA_BROWSERS:
            m = _re.search(rx, ua)
            if m:
                out["name"] = name
                groups = [g for g in m.groups() if g]
                if groups:
                    out["version"] = ".".join(groups[:2])
                    out["major"] = groups[0]
                break
        for name, rx in _UA_OS:
            m = _re.search(rx, ua)
            if m:
                os_out: Dict[str, Any] = {"name": name}
                groups = [g for g in m.groups() if g]
                if groups:
                    os_out["version"] = ".".join(groups[:2])
                    os_out["full"] = f"{name} {os_out['version']}"
                out["os"] = os_out
                break
        for name, rx in _UA_DEVICE:
            if _re.search(rx, ua, _re.IGNORECASE):
                out["device"] = {"name": name}
                break
        else:
            out["device"] = {"name": "Other"}
        set_field(doc, target, out)
        return doc
    return run


def _p_geoip(cfg):
    """modules/ingest-geoip GeoIpProcessor analog. The reference reads
    MaxMind .mmdb databases shipped with the plugin; this image carries
    none, so lookups run against (a) a user-supplied CIDR table in the
    processor config ("database": {"10.0.0.0/8": {...geo fields...}})
    and (b) a tiny built-in table for well-known test ranges. Unmatched
    addresses are a no-op like the reference's missing-database case."""
    import ipaddress as _ip
    field = _req(cfg, "geoip", "field")
    target = cfg.get("target_field", "geoip")
    ignore_missing = cfg.get("ignore_missing", False)
    table = []
    builtin = {
        "127.0.0.0/8": {"country_iso_code": "XX",
                        "country_name": "Loopback"},
    }
    for cidr, geo in {**builtin, **(cfg.get("database") or {})}.items():
        try:
            # strict=False tolerates host bits (203.0.113.7/24), an easy
            # config mistake the reference's CIDR parsing also accepts
            table.append((_ip.ip_network(cidr, strict=False), dict(geo)))
        except ValueError as e:
            raise IllegalArgumentError(
                f"[geoip] invalid database CIDR [{cidr}]: {e}")
    # longest prefix first so specific entries win
    table.sort(key=lambda e: -e[0].prefixlen)

    def run(doc):
        raw = get_field(doc, field)
        if raw is None:
            if ignore_missing:
                return doc
            raise IngestProcessorError(f"field [{field}] not present")
        try:
            addr = _ip.ip_address(str(raw))
        except ValueError:
            raise IngestProcessorError(
                f"[{raw}] is not a valid ip address")
        for net, geo in table:
            if addr in net:
                set_field(doc, target, dict(geo))
                break
        return doc
    return run


PROCESSORS: Dict[str, Callable[[Dict[str, Any]], Processor]] = {
    "set": _p_set, "remove": _p_remove, "rename": _p_rename,
    "append": _p_append, "convert": _p_convert, "date": _p_date,
    "split": _p_split, "join": _p_join, "gsub": _p_gsub,
    "json": _p_json, "kv": _p_kv, "script": _p_script,
    "fail": _p_fail, "drop": _p_drop, "trim": _p_trim,
    "lowercase": _p_lowercase, "uppercase": _p_uppercase,
    "html_strip": _p_html_strip, "bytes": _p_bytes,
    "dissect": _p_dissect, "grok": _p_grok, "inference": _p_inference,
    "user_agent": _p_user_agent, "geoip": _p_geoip,
}


# ---------------------------------------------------------------------------
# pipeline compilation + execution
# ---------------------------------------------------------------------------

class CompiledProcessor:
    def __init__(self, ptype: str, cfg: Dict[str, Any],
                 service: "IngestService"):
        self.ptype = ptype
        self.cfg = cfg
        self.tag = cfg.get("tag")
        self.condition = cfg.get("if")
        self.ignore_failure = cfg.get("ignore_failure", False)
        self.on_failure = [service.compile_processor(p)
                           for p in cfg.get("on_failure", [])]
        if ptype == "pipeline":
            ref = _req(cfg, "pipeline", "name")
            self.run_inner: Processor = \
                lambda doc: service.execute_pipeline(ref, doc)
        elif ptype == "enrich":
            # joins against the node's executed policy tables
            # (x-pack/plugin/enrich MatchProcessor analog). Config shape
            # validates even without a node (the static validate() path);
            # only RUNNING requires the cluster context.
            from elasticsearch_tpu_torch.xpack.enrich import (
                make_enrich_processor, validate_enrich_config,
            )
            validate_enrich_config(cfg)
            if service.node is not None:
                self.run_inner = make_enrich_processor(service.node, cfg)
            else:
                def _no_cluster(_doc):
                    raise IllegalArgumentError(
                        "[enrich] processor requires a cluster context")
                self.run_inner = _no_cluster
        elif ptype == "inference":
            # the model runs on the owning node's device
            self.run_inner = _p_inference(cfg, service.device)
        else:
            factory = PROCESSORS.get(ptype)
            if factory is None:
                raise IllegalArgumentError(
                    f"No processor type exists with name [{ptype}]")
            self.run_inner = factory(cfg)

    def run(self, doc):
        if self.condition is not None:
            from elasticsearch_tpu_torch.script.engine import default_engine
            src = self.condition
            ctx_doc = {"_source": doc["_source"], **{
                k: v for k, v in doc.items() if k.startswith("_")}}
            try:
                ok = default_engine.execute(
                    src if src.strip().startswith("return")
                    else f"return {src}",
                    {"ctx": ctx_doc})
            except Exception:
                ok = False
            if not ok:
                return doc
        try:
            return self.run_inner(doc)
        except Exception as e:  # noqa: BLE001 — on_failure chain
            if self.on_failure:
                set_field(doc, "_ingest_on_failure_message", str(e))
                for p in self.on_failure:
                    doc = p.run(doc)
                    if doc is None:
                        return None
                remove_field(doc, "_ingest_on_failure_message")
                return doc
            if self.ignore_failure:
                return doc
            raise


class IngestService:
    """Compiles + caches pipelines from cluster-state settings and runs
    them over bulk items before routing."""

    def __init__(self, state_supplier: Callable[[], Any], node: Any = None):
        self.state = state_supplier
        # the owning node, for processors that join against cluster-level
        # lookups (enrich); None in standalone pipeline tests
        self.node = node
        # where model-backed processors run (the node's device; None =
        # the CUDA card)
        self.device = getattr(node, "device", None)
        self._cache: Dict[str, Any] = {}   # id -> (raw_def, [processors])

    # -- registry --------------------------------------------------------

    def pipeline_def(self, pipeline_id: str) -> Optional[Dict[str, Any]]:
        settings = self.state().metadata.persistent_settings
        return settings.get(PIPELINE_SETTING_PREFIX + pipeline_id)

    def list_pipelines(self) -> Dict[str, Dict[str, Any]]:
        settings = self.state().metadata.persistent_settings
        return {k[len(PIPELINE_SETTING_PREFIX):]: v
                for k, v in settings.items()
                if k.startswith(PIPELINE_SETTING_PREFIX)}

    def compile_processor(self, pdef: Dict[str, Any]) -> CompiledProcessor:
        if len(pdef) != 1:
            raise IllegalArgumentError(
                f"processor must define exactly one type, got "
                f"{sorted(pdef)}")
        (ptype, cfg), = pdef.items()
        return CompiledProcessor(ptype, cfg or {}, self)

    def _compiled(self, pipeline_id: str) -> List[CompiledProcessor]:
        raw = self.pipeline_def(pipeline_id)
        if raw is None:
            raise IllegalArgumentError(
                f"pipeline with id [{pipeline_id}] does not exist")
        cached = self._cache.get(pipeline_id)
        if cached is not None and cached[0] == raw:
            return cached[1]
        compiled = [self.compile_processor(p)
                    for p in raw.get("processors", [])]
        self._cache[pipeline_id] = (raw, compiled)
        return compiled

    @staticmethod
    def validate(body: Dict[str, Any]) -> None:
        svc = IngestService(lambda: None)
        for p in (body or {}).get("processors", []):
            svc.compile_processor(p)

    # -- execution -------------------------------------------------------

    def execute_pipeline(self, pipeline_id: str,
                         doc: Dict[str, Any]
                         ) -> Optional[Dict[str, Any]]:
        for proc in self._compiled(pipeline_id):
            doc = proc.run(doc)
            if doc is None:
                return None
        return doc

    def prewarm_inference(self, pipeline_id: str,
                          items: List[Dict[str, Any]]) -> None:
        """Batch half of the inference processor: expand every item's text
        in ONE device dispatch and prime the model's expansion cache, so
        the per-document processor run is a host-side cache hit. Best
        effort — the per-doc path stays correct without it."""
        try:
            procs = [p for p in self._compiled(pipeline_id)
                     if p.ptype == "inference"]
        except Exception:  # noqa: BLE001 — unknown pipeline errors later
            return
        if not procs:
            return
        from elasticsearch_tpu_torch.ml import get_model
        for proc in procs:
            field = proc.cfg.get("field")
            if not field:
                continue
            texts = []
            for item in items:
                doc = {"_source": item.get("source") or {}}
                v = get_field(doc, field)
                if v is not None:
                    texts.append(str(v))
            if texts:
                try:
                    get_model(proc.cfg.get("model_id"),
                              self.device).expand_batch(
                        sorted(set(texts)))
                except Exception:  # noqa: BLE001 — surfaces per-doc later
                    return

    def process_item(self, pipeline_id: str, item: Dict[str, Any]
                     ) -> Optional[Dict[str, Any]]:
        """Run one bulk item through a pipeline; returns the item with the
        transformed source/metadata, or None when dropped."""
        import copy
        # deep-copy: a mid-pipeline failure must not leave the caller's
        # item half-transformed (IngestDocument copies the same way)
        doc = {"_source": copy.deepcopy(item.get("source") or {}),
               "_index": item["index"], "_id": item.get("id"),
               "_routing": item.get("routing")}
        doc = self.execute_pipeline(pipeline_id, doc)
        if doc is None:
            return None
        item = dict(item)
        item["source"] = doc["_source"]
        item["index"] = doc["_index"]
        item["id"] = doc["_id"]
        if doc.get("_routing") is not None:
            item["routing"] = doc["_routing"]
        return item
