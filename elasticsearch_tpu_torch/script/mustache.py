"""Search templates: mustache-lite rendering + stored scripts.

Reference analog: modules/lang-mustache/ — _search/template renders a
mustache source with params into a search body; templates can be inline or
stored via the _scripts API (stored scripts live in cluster state). The
subset implemented: {{var}} substitution (dotted paths), {{#var}}...{{/var}}
sections (truthy/list), {{^var}} inverted sections, {{{var}}} unescaped
(same as escaped here — bodies are JSON, not HTML), and {{#toJson}}var{{/toJson}}.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, Optional

from elasticsearch_tpu_torch.utils.errors import (
    IllegalArgumentError, ResourceNotFoundError,
)

STORED_SCRIPT_PREFIX = "stored_script."


def _lookup(params: Any, path: str) -> Any:
    if path == ".":
        return params
    cur = params
    for part in path.split("."):
        if isinstance(cur, dict):
            cur = cur.get(part)
        else:
            return None
    return cur


_SECTION = re.compile(
    r"\{\{([#^])\s*(?!toJson\b)([\w.]+)\s*\}\}(.*?)\{\{/\s*\2\s*\}\}",
    re.DOTALL)
_TOJSON = re.compile(
    r"\{\{#toJson\}\}\s*([\w.]+)\s*\{\{/toJson\}\}")
_TRIPLE_VAR = re.compile(r"\{\{\{\s*([\w.]+)\s*\}\}\}")
_VAR = re.compile(r"\{\{\s*([\w.]+)\s*\}\}")


def render(source: str, params: Optional[Dict[str, Any]]) -> str:
    params = params or {}

    def render_part(tmpl: str, scope: Any) -> str:
        def do_section(m: re.Match) -> str:
            kind, path, body = m.group(1), m.group(2), m.group(3)
            value = _lookup(scope, path)
            if kind == "^":
                return render_part(body, scope) if not value else ""
            if not value:
                return ""
            if isinstance(value, list):
                return "".join(render_part(body, item)
                               for item in value)
            if isinstance(value, dict):
                return render_part(body, value)
            return render_part(body, scope)
        tmpl = _SECTION.sub(do_section, tmpl)
        # toJson AFTER section expansion so per-item scopes resolve
        tmpl = _TOJSON.sub(
            lambda m: json.dumps(_lookup(scope, m.group(1))), tmpl)

        def do_var(m: re.Match) -> str:
            v = _lookup(scope, m.group(1))
            if v is None:
                return ""
            if isinstance(v, bool):
                return "true" if v else "false"
            if isinstance(v, (dict, list)):
                return json.dumps(v)
            if isinstance(v, str):
                # JSON-escape (bodies are JSON): quotes/backslashes/
                # newlines in params must not break the render
                return json.dumps(v)[1:-1]
            return str(v)
        # triple-stache first, or its braces bleed into the JSON around it
        tmpl = _TRIPLE_VAR.sub(do_var, tmpl)
        return _VAR.sub(do_var, tmpl)
    return render_part(source, params)


def render_search_body(template: Dict[str, Any],
                       stored_lookup) -> Dict[str, Any]:
    """{source|id, params} → rendered search body dict."""
    source = template.get("source")
    if source is None and template.get("id") is not None:
        stored = stored_lookup(template["id"])
        if stored is None:
            raise ResourceNotFoundError(
                f"stored script [{template['id']}] does not exist")
        source = stored.get("source", stored)
    if source is None:
        raise IllegalArgumentError(
            "search template requires [source] or [id]")
    if isinstance(source, dict):
        source = json.dumps(source)
    rendered = render(source, template.get("params"))
    try:
        return json.loads(rendered)
    except json.JSONDecodeError as e:
        raise IllegalArgumentError(
            f"rendered template is not valid JSON: {e}: {rendered}")
