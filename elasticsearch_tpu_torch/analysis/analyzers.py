"""Host-side text analysis: char filters → tokenizer → token filters.

Mirrors the structure of the reference's analysis chain
(server/.../index/analysis/, modules/analysis-common/): an ``Analyzer`` is a
composition of char filters, one tokenizer, and token filters; custom
analyzers are declared in index settings and resolved by the registry.

Analysis is host CPU by design (SURVEY.md §7 design stance): everything after
term ids is device-side.
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

from elasticsearch_tpu_torch.analysis.porter import porter_stem
from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError


@dataclass
class Token:
    """One analyzed token with its position (for phrase queries) and offsets."""
    term: str
    position: int
    start_offset: int = 0
    end_offset: int = 0


# ---------------------------------------------------------------------------
# Tokenizers
# ---------------------------------------------------------------------------

_WORD_RE = re.compile(r"[^\W_]+(?:['’][^\W_]+)*", re.UNICODE)
_LETTER_RE = re.compile(r"[^\W\d_]+", re.UNICODE)
_WS_RE = re.compile(r"\S+")


def _regex_tokenize(text: str, pattern: re.Pattern) -> List[Token]:
    return [
        Token(m.group(0), pos, m.start(), m.end())
        for pos, m in enumerate(pattern.finditer(text))
    ]


def standard_tokenizer(text: str) -> List[Token]:
    """Unicode word-boundary tokenizer (reference: StandardTokenizer).

    The unicode regex is the whole implementation: this package builds
    no host-side native helpers, only its device kernels."""
    return _regex_tokenize(text, _WORD_RE)


def whitespace_tokenizer(text: str) -> List[Token]:
    return _regex_tokenize(text, _WS_RE)


def letter_tokenizer(text: str) -> List[Token]:
    return _regex_tokenize(text, _LETTER_RE)


def keyword_tokenizer(text: str) -> List[Token]:
    return [Token(text, 0, 0, len(text))] if text else []


def make_pattern_tokenizer(pattern: str) -> Callable[[str], List[Token]]:
    """Splits on the pattern (like the reference's PatternTokenizer default mode)."""
    rx = re.compile(pattern)

    def tokenize(text: str) -> List[Token]:
        out, pos, last = [], 0, 0
        for m in rx.finditer(text):
            piece = text[last : m.start()]
            if piece:
                out.append(Token(piece, pos, last, m.start()))
                pos += 1
            last = m.end()
        piece = text[last:]
        if piece:
            out.append(Token(piece, pos, last, len(text)))
        return out

    return tokenize


def make_ngram_tokenizer(min_gram: int = 1, max_gram: int = 2) -> Callable[[str], List[Token]]:
    def tokenize(text: str) -> List[Token]:
        out, pos = [], 0
        for n in range(min_gram, max_gram + 1):
            for i in range(0, max(0, len(text) - n + 1)):
                out.append(Token(text[i : i + n], pos, i, i + n))
                pos += 1
        return out

    return tokenize


def make_edge_ngram_tokenizer(min_gram: int = 1, max_gram: int = 2) -> Callable[[str], List[Token]]:
    def tokenize(text: str) -> List[Token]:
        out = []
        for pos, n in enumerate(range(min_gram, min(max_gram, len(text)) + 1)):
            out.append(Token(text[:n], pos, 0, n))
        return out

    return tokenize


# ---------------------------------------------------------------------------
# Token filters
# ---------------------------------------------------------------------------

# Lucene's default English stopword set (public, from the original English
# stopword list used by StandardAnalyzer).
ENGLISH_STOPWORDS = frozenset(
    """a an and are as at be but by for if in into is it no not of on or such
    that the their then there these they this to was will with""".split()
)


def lowercase_filter(tokens: List[Token]) -> List[Token]:
    for t in tokens:
        t.term = t.term.lower()
    return tokens


def uppercase_filter(tokens: List[Token]) -> List[Token]:
    for t in tokens:
        t.term = t.term.upper()
    return tokens


def make_stop_filter(stopwords: Iterable[str] = ENGLISH_STOPWORDS) -> Callable:
    stops = frozenset(stopwords)

    def stop(tokens: List[Token]) -> List[Token]:
        # positions are preserved (holes left by removed stopwords), so phrase
        # queries across stopwords behave like the reference's StopFilter.
        return [t for t in tokens if t.term not in stops]

    return stop


def porter_stem_filter(tokens: List[Token]) -> List[Token]:
    for t in tokens:
        t.term = porter_stem(t.term)
    return tokens


def asciifolding_filter(tokens: List[Token]) -> List[Token]:
    for t in tokens:
        t.term = (
            unicodedata.normalize("NFKD", t.term).encode("ascii", "ignore").decode("ascii")
        ) or t.term
    return tokens


def trim_filter(tokens: List[Token]) -> List[Token]:
    for t in tokens:
        t.term = t.term.strip()
    return tokens


def unique_filter(tokens: List[Token]) -> List[Token]:
    seen, out = set(), []
    for t in tokens:
        if t.term not in seen:
            seen.add(t.term)
            out.append(t)
    return out


def make_length_filter(min_len: int = 0, max_len: int = 1 << 30) -> Callable:
    def length(tokens: List[Token]) -> List[Token]:
        return [t for t in tokens if min_len <= len(t.term) <= max_len]

    return length


def make_shingle_filter(min_size: int = 2, max_size: int = 2,
                        separator: str = " ", output_unigrams: bool = True) -> Callable:
    def shingle(tokens: List[Token]) -> List[Token]:
        out = list(tokens) if output_unigrams else []
        for n in range(min_size, max_size + 1):
            for i in range(0, len(tokens) - n + 1):
                window = tokens[i : i + n]
                out.append(Token(
                    separator.join(t.term for t in window),
                    window[0].position,
                    window[0].start_offset,
                    window[-1].end_offset,
                ))
        out.sort(key=lambda t: (t.position, t.end_offset - t.start_offset))
        return out

    return shingle


def make_ngram_filter(min_gram: int = 1, max_gram: int = 2) -> Callable:
    def ngram(tokens: List[Token]) -> List[Token]:
        out = []
        for t in tokens:
            for n in range(min_gram, max_gram + 1):
                for i in range(0, max(0, len(t.term) - n + 1)):
                    out.append(Token(t.term[i : i + n], t.position, t.start_offset, t.end_offset))
        return out

    return ngram


def make_edge_ngram_filter(min_gram: int = 1, max_gram: int = 2) -> Callable:
    def edge(tokens: List[Token]) -> List[Token]:
        out = []
        for t in tokens:
            for n in range(min_gram, min(max_gram, len(t.term)) + 1):
                out.append(Token(t.term[:n], t.position, t.start_offset, t.end_offset))
        return out

    return edge


def make_synonym_filter(synonyms: Dict[str, List[str]]) -> Callable:
    """Simple single-token synonym expansion at the same position."""

    def synonym(tokens: List[Token]) -> List[Token]:
        out = []
        for t in tokens:
            out.append(t)
            for syn in synonyms.get(t.term, ()):
                out.append(Token(syn, t.position, t.start_offset, t.end_offset))
        return out

    return synonym


def make_stemmer_filter(language: str = "english") -> Callable:
    if language in ("english", "porter", "porter2", "light_english"):
        return porter_stem_filter
    raise IllegalArgumentError(f"unsupported stemmer language [{language}]")


# ---------------------------------------------------------------------------
# Char filters
# ---------------------------------------------------------------------------

_HTML_RE = re.compile(r"<[^>]*>")


def html_strip_char_filter(text: str) -> str:
    return _HTML_RE.sub(" ", text)


def make_mapping_char_filter(mappings: Dict[str, str]) -> Callable[[str], str]:
    """Single left-to-right pass, longest key first; replacements are never
    re-matched (reference MappingCharFilter semantics — {'a':'b','b':'c'}
    maps 'a' to 'b', not 'c')."""
    keys = sorted(mappings, key=len, reverse=True)

    def apply(text: str) -> str:
        out: List[str] = []
        i = 0
        n = len(text)
        while i < n:
            for k in keys:
                if k and text.startswith(k, i):
                    out.append(mappings[k])
                    i += len(k)
                    break
            else:
                out.append(text[i])
                i += 1
        return "".join(out)

    return apply


def make_pattern_replace_char_filter(pattern: str, replacement: str) -> Callable[[str], str]:
    rx = re.compile(pattern)
    return lambda text: rx.sub(replacement, text)


# ---------------------------------------------------------------------------
# Analyzer = char filters + tokenizer + token filters
# ---------------------------------------------------------------------------

@dataclass
class Analyzer:
    name: str
    tokenizer: Callable[[str], List[Token]]
    token_filters: Sequence[Callable[[List[Token]], List[Token]]] = field(default_factory=list)
    char_filters: Sequence[Callable[[str], str]] = field(default_factory=list)

    def analyze(self, text: str) -> List[Token]:
        for cf in self.char_filters:
            text = cf(text)
        tokens = self.tokenizer(text)
        for tf in self.token_filters:
            tokens = tf(tokens)
        return tokens

    def terms(self, text: str) -> List[str]:
        return [t.term for t in self.analyze(text)]


def cjk_bigram_tokenizer(text: str) -> List[Token]:
    """CJK-aware tokenization (analysis-common CJKBigramFilter analog):
    runs of Han/Hiragana/Katakana/Hangul become overlapping bigrams
    (unigram when the run is a single char); everything else tokenizes
    like the standard tokenizer."""
    def is_cjk(ch: str) -> bool:
        cp = ord(ch)
        return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or
                0x3040 <= cp <= 0x30FF or 0xAC00 <= cp <= 0xD7AF or
                0xF900 <= cp <= 0xFAFF)

    tokens: List[Token] = []
    position = 0
    i = 0
    n = len(text)
    while i < n:
        ch = text[i]
        if is_cjk(ch):
            j = i
            while j < n and is_cjk(text[j]):
                j += 1
            run = text[i:j]
            if len(run) == 1:
                tokens.append(Token(run, position, i, i + 1))
                position += 1
            else:
                for k in range(len(run) - 1):
                    tokens.append(Token(run[k: k + 2], position,
                                        i + k, i + k + 2))
                    position += 1
            i = j
        elif ch.isalnum():
            j = i
            while j < n and (text[j].isalnum() and not is_cjk(text[j])):
                j += 1
            tokens.append(Token(text[i:j], position, i, j))
            position += 1
            i = j
        else:
            i += 1
    return tokens


STANDARD = Analyzer("standard", standard_tokenizer, [lowercase_filter])
SIMPLE = Analyzer("simple", letter_tokenizer, [lowercase_filter])
WHITESPACE = Analyzer("whitespace", whitespace_tokenizer)
KEYWORD = Analyzer("keyword", keyword_tokenizer)
STOP = Analyzer("stop", letter_tokenizer, [lowercase_filter, make_stop_filter()])
ENGLISH = Analyzer(
    "english", standard_tokenizer,
    [lowercase_filter, make_stop_filter(), porter_stem_filter],
)
CJK = Analyzer("cjk", cjk_bigram_tokenizer, [lowercase_filter])

BUILTIN_ANALYZERS: Dict[str, Analyzer] = {
    a.name: a for a in (STANDARD, SIMPLE, WHITESPACE, KEYWORD, STOP,
                        ENGLISH, CJK)
}

_TOKENIZERS: Dict[str, Callable[..., Any]] = {
    "standard": lambda **kw: standard_tokenizer,
    "whitespace": lambda **kw: whitespace_tokenizer,
    "letter": lambda **kw: letter_tokenizer,
    "keyword": lambda **kw: keyword_tokenizer,
    "pattern": lambda pattern=r"\W+", **kw: make_pattern_tokenizer(pattern),
    "ngram": lambda min_gram=1, max_gram=2, **kw: make_ngram_tokenizer(min_gram, max_gram),
    "edge_ngram": lambda min_gram=1, max_gram=2, **kw: make_edge_ngram_tokenizer(min_gram, max_gram),
}

_TOKEN_FILTERS: Dict[str, Callable[..., Any]] = {
    "lowercase": lambda **kw: lowercase_filter,
    "uppercase": lambda **kw: uppercase_filter,
    "stop": lambda stopwords=None, **kw: make_stop_filter(
        ENGLISH_STOPWORDS if stopwords in (None, "_english_") else stopwords),
    "stemmer": lambda language="english", **kw: make_stemmer_filter(language),
    "porter_stem": lambda **kw: porter_stem_filter,
    "asciifolding": lambda **kw: asciifolding_filter,
    "trim": lambda **kw: trim_filter,
    "unique": lambda **kw: unique_filter,
    "length": lambda min=0, max=1 << 30, **kw: make_length_filter(min, max),
    "shingle": lambda min_shingle_size=2, max_shingle_size=2, output_unigrams=True, **kw:
        make_shingle_filter(min_shingle_size, max_shingle_size, output_unigrams=output_unigrams),
    "ngram": lambda min_gram=1, max_gram=2, **kw: make_ngram_filter(min_gram, max_gram),
    "edge_ngram": lambda min_gram=1, max_gram=2, **kw: make_edge_ngram_filter(min_gram, max_gram),
    "synonym": lambda synonyms=None, **kw: make_synonym_filter(_parse_synonyms(synonyms or [])),
}

_CHAR_FILTERS: Dict[str, Callable[..., Any]] = {
    "html_strip": lambda **kw: html_strip_char_filter,
    "mapping": lambda mappings=None, **kw: make_mapping_char_filter(
        dict(m.split("=>", 1) for m in (mappings or []))),
    "pattern_replace": lambda pattern=".", replacement="", **kw:
        make_pattern_replace_char_filter(pattern, replacement),
}


def _parse_synonyms(rules: Iterable[str]) -> Dict[str, List[str]]:
    """Parse Solr-style synonym rules: "a, b => c" or "a, b, c" (symmetric)."""
    table: Dict[str, List[str]] = {}
    for rule in rules:
        if "=>" in rule:
            lhs, rhs = rule.split("=>", 1)
            targets = [w.strip() for w in rhs.split(",") if w.strip()]
            for src in (w.strip() for w in lhs.split(",")):
                if src:
                    table.setdefault(src, []).extend(t for t in targets if t != src)
        else:
            words = [w.strip() for w in rule.split(",") if w.strip()]
            for w in words:
                table.setdefault(w, []).extend(x for x in words if x != w)
    return table


class AnalysisRegistry:
    """Resolves analyzers for an index from its settings.

    Custom analyzers are declared like the reference
    (index settings ``analysis.analyzer.<name>`` with tokenizer/filter/char_filter,
    plus custom tokenizer/filter definitions under ``analysis.tokenizer.<name>`` etc.).
    """

    def __init__(self, analysis_config: Optional[Dict[str, Any]] = None):
        self._analyzers: Dict[str, Analyzer] = dict(BUILTIN_ANALYZERS)
        cfg = analysis_config or {}
        custom_tokenizers = cfg.get("tokenizer", {})
        custom_filters = cfg.get("filter", {})
        custom_char_filters = cfg.get("char_filter", {})

        def _spec_type(spec: Dict[str, Any], name: str, kind: str) -> str:
            if "type" not in spec:
                raise IllegalArgumentError(f"{kind} [{name}] must declare a [type]")
            return spec.pop("type")

        def resolve_tokenizer(name: str):
            if name in custom_tokenizers:
                spec = dict(custom_tokenizers[name])
                typ = _spec_type(spec, name, "tokenizer")
                return self._build(_TOKENIZERS, typ, spec, "tokenizer")
            return self._build(_TOKENIZERS, name, {}, "tokenizer")

        def resolve_filter(name: str):
            if name in custom_filters:
                spec = dict(custom_filters[name])
                typ = _spec_type(spec, name, "token filter")
                return self._build(_TOKEN_FILTERS, typ, spec, "token filter")
            return self._build(_TOKEN_FILTERS, name, {}, "token filter")

        def resolve_char_filter(name: str):
            if name in custom_char_filters:
                spec = dict(custom_char_filters[name])
                typ = _spec_type(spec, name, "char filter")
                return self._build(_CHAR_FILTERS, typ, spec, "char filter")
            return self._build(_CHAR_FILTERS, name, {}, "char filter")

        for name, spec in cfg.get("analyzer", {}).items():
            spec = dict(spec)
            typ = spec.pop("type", "custom")
            if typ != "custom":
                if typ not in BUILTIN_ANALYZERS:
                    raise IllegalArgumentError(f"unknown analyzer type [{typ}]")
                self._analyzers[name] = self._configure_builtin(name, typ, spec)
                continue
            tokenizer = resolve_tokenizer(spec.get("tokenizer", "standard"))
            filters = [resolve_filter(f) for f in spec.get("filter", [])]
            char_filters = [resolve_char_filter(f) for f in spec.get("char_filter", [])]
            self._analyzers[name] = Analyzer(name, tokenizer, filters, char_filters)

    @staticmethod
    def _configure_builtin(name: str, typ: str, spec: Dict[str, Any]) -> Analyzer:
        """Parameterize a builtin analyzer type (e.g. standard/stop with stopwords)."""
        if not spec:
            return BUILTIN_ANALYZERS[typ]
        if typ in ("standard", "stop", "english") and set(spec) <= {"stopwords"}:
            stops = spec["stopwords"]
            stops = ENGLISH_STOPWORDS if stops == "_english_" else stops
            base = BUILTIN_ANALYZERS[typ]
            filters = [lowercase_filter, make_stop_filter(stops)]
            if typ == "english":
                filters.append(porter_stem_filter)
            return Analyzer(name, base.tokenizer, filters, base.char_filters)
        raise IllegalArgumentError(
            f"analyzer [{name}] of type [{typ}] does not support parameters "
            f"{sorted(spec)}; use a [custom] analyzer")

    @staticmethod
    def _build(table: Dict[str, Callable[..., Any]], name: str, params: Dict[str, Any], kind: str):
        factory = table.get(name)
        if factory is None:
            raise IllegalArgumentError(f"unknown {kind} [{name}]")
        return factory(**params)

    def get(self, name: str) -> Analyzer:
        a = self._analyzers.get(name)
        if a is None:
            raise IllegalArgumentError(f"unknown analyzer [{name}]")
        return a

    def __contains__(self, name: str) -> bool:
        return name in self._analyzers
