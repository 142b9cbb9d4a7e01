"""x-content: format-agnostic document (de)serialization.

The analog of the reference's libs/x-content abstraction
(libs/x-content/.../XContent.java, XContentType.java): one logical
document model readable/writable as JSON, YAML, CBOR, or SMILE, with
format detection from content-type headers and leading bytes. The
reference wraps Jackson; here JSON is the stdlib, YAML rides the baked-in
PyYAML (safe loader only), and CBOR (RFC 8949) and SMILE are small
self-contained codecs covering the document subset the APIs exchange
(maps, arrays, strings, ints, floats, bools, null, binary).
"""

from __future__ import annotations

import json
import struct
from typing import Any, Optional, Tuple

from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError

JSON = "json"
YAML = "yaml"
CBOR = "cbor"
SMILE = "smile"

CONTENT_TYPES = {
    JSON: "application/json",
    YAML: "application/yaml",
    CBOR: "application/cbor",
    SMILE: "application/smile",
}

# SMILE header: ':', ')', '\n' then a version/flags byte
# (the Jackson Smile format magic)
_SMILE_MAGIC = b":)\n"


def format_from_content_type(content_type: Optional[str]) -> Optional[str]:
    if not content_type:
        return None
    ct = content_type.lower()
    for fmt, mime in CONTENT_TYPES.items():
        if mime in ct or f"/{fmt}" in ct or f"+{fmt}" in ct:
            return fmt
    if "x-ndjson" in ct:
        return JSON
    return None


def sniff_format(raw: bytes) -> str:
    """Leading-bytes detection (XContentFactory.xContentType analog)."""
    if raw.startswith(_SMILE_MAGIC):
        return SMILE
    if raw[:1] in (b"{", b"["):
        return JSON
    # CBOR maps/arrays: major type 4/5 in the first byte, or self-describe
    # tag d9 d9 f7
    if raw[:3] == b"\xd9\xd9\xf7":
        return CBOR
    if raw and (raw[0] >> 5) in (4, 5) and raw[0] >= 0x80:
        return CBOR
    if raw.startswith(b"---") or raw[:1].isalpha():
        return YAML
    return JSON


def loads(raw: bytes, content_type: Optional[str] = None) -> Any:
    fmt = format_from_content_type(content_type) or sniff_format(raw)
    if fmt == JSON:
        return json.loads(raw)
    if fmt == YAML:
        import yaml
        return yaml.safe_load(raw)
    if fmt == CBOR:
        value, offset = _cbor_decode(raw, 0)
        return value
    if fmt == SMILE:
        return _smile_decode(raw)
    raise IllegalArgumentError(f"unsupported content format [{fmt}]")


def _b64_bytes(o: Any) -> Any:
    """Text formats carry binary as base64 (the reference's JSON/YAML
    rendering of binary fields)."""
    import base64
    if isinstance(o, bytes):
        return base64.b64encode(o).decode("ascii")
    raise TypeError(f"not JSON serializable: {type(o).__name__}")


def dumps(value: Any, fmt: str = JSON) -> bytes:
    if fmt == JSON:
        return json.dumps(value, default=_b64_bytes).encode("utf-8")
    if fmt == YAML:
        import base64
        import yaml

        class _Dumper(yaml.SafeDumper):
            pass
        _Dumper.add_representer(
            bytes, lambda dumper, data: dumper.represent_str(
                base64.b64encode(data).decode("ascii")))
        return yaml.dump(value, Dumper=_Dumper,
                         sort_keys=False).encode("utf-8")
    if fmt == CBOR:
        out = bytearray()
        _cbor_encode(value, out)
        return bytes(out)
    if fmt == SMILE:
        return _smile_encode(value)
    raise IllegalArgumentError(f"unsupported content format [{fmt}]")


def response_format(accept: Optional[str],
                    request_format: Optional[str]) -> str:
    """Responses mirror the request format unless Accept overrides
    (RestRequest.getResponseContentType analog)."""
    fmt = format_from_content_type(accept)
    if fmt is not None:
        return fmt
    return request_format or JSON


# ---------------------------------------------------------------------------
# CBOR (RFC 8949) — the document subset
# ---------------------------------------------------------------------------

def _cbor_encode(v: Any, out: bytearray) -> None:
    if v is None:
        out.append(0xF6)
    elif v is True:
        out.append(0xF5)
    elif v is False:
        out.append(0xF4)
    elif isinstance(v, int):
        if v >= 0:
            _cbor_head(0, v, out)
        else:
            _cbor_head(1, -1 - v, out)
    elif isinstance(v, float):
        out.append(0xFB)
        out += struct.pack(">d", v)
    elif isinstance(v, bytes):
        _cbor_head(2, len(v), out)
        out += v
    elif isinstance(v, str):
        b = v.encode("utf-8")
        _cbor_head(3, len(b), out)
        out += b
    elif isinstance(v, (list, tuple)):
        _cbor_head(4, len(v), out)
        for item in v:
            _cbor_encode(item, out)
    elif isinstance(v, dict):
        _cbor_head(5, len(v), out)
        for k, item in v.items():
            _cbor_encode(str(k), out)
            _cbor_encode(item, out)
    else:
        raise IllegalArgumentError(
            f"cannot CBOR-encode [{type(v).__name__}]")


def _cbor_head(major: int, arg: int, out: bytearray) -> None:
    if arg < 24:
        out.append((major << 5) | arg)
    elif arg < 0x100:
        out.append((major << 5) | 24)
        out.append(arg)
    elif arg < 0x10000:
        out.append((major << 5) | 25)
        out += struct.pack(">H", arg)
    elif arg < 0x100000000:
        out.append((major << 5) | 26)
        out += struct.pack(">I", arg)
    else:
        out.append((major << 5) | 27)
        out += struct.pack(">Q", arg)


def _cbor_decode(raw: bytes, i: int) -> Tuple[Any, int]:
    if i >= len(raw):
        raise IllegalArgumentError("truncated CBOR input")
    first = raw[i]
    if raw[i : i + 3] == b"\xd9\xd9\xf7":       # self-describe tag
        return _cbor_decode(raw, i + 3)
    major, info = first >> 5, first & 0x1F
    i += 1

    def read_arg() -> Tuple[int, int]:
        nonlocal i
        if info < 24:
            return info, i
        if info == 24:
            v = raw[i]
            return v, i + 1
        if info == 25:
            return struct.unpack_from(">H", raw, i)[0], i + 2
        if info == 26:
            return struct.unpack_from(">I", raw, i)[0], i + 4
        if info == 27:
            return struct.unpack_from(">Q", raw, i)[0], i + 8
        raise IllegalArgumentError(
            f"unsupported CBOR additional info [{info}]")

    if major == 0:
        arg, i = read_arg()
        return arg, i
    if major == 1:
        arg, i = read_arg()
        return -1 - arg, i
    if major == 2:
        n, i = read_arg()
        return raw[i : i + n], i + n
    if major == 3:
        n, i = read_arg()
        return raw[i : i + n].decode("utf-8"), i + n
    if major == 4:
        n, i = read_arg()
        items = []
        for _ in range(n):
            item, i = _cbor_decode(raw, i)
            items.append(item)
        return items, i
    if major == 5:
        n, i = read_arg()
        obj = {}
        for _ in range(n):
            k, i = _cbor_decode(raw, i)
            v, i = _cbor_decode(raw, i)
            obj[k] = v
        return obj, i
    if major == 6:                               # tag: skip, decode item
        _arg, i = read_arg()
        return _cbor_decode(raw, i)
    # major 7: simple values / floats
    if info == 20:
        return False, i
    if info == 21:
        return True, i
    if info in (22, 23):
        return None, i
    if info == 25:                               # half float
        h = struct.unpack_from(">H", raw, i)[0]
        return _half_to_float(h), i + 2
    if info == 26:
        return struct.unpack_from(">f", raw, i)[0], i + 4
    if info == 27:
        return struct.unpack_from(">d", raw, i)[0], i + 8
    raise IllegalArgumentError(f"unsupported CBOR simple value [{info}]")


def _half_to_float(h: int) -> float:
    sign = -1.0 if h & 0x8000 else 1.0
    exp = (h >> 10) & 0x1F
    frac = h & 0x3FF
    if exp == 0:
        return sign * frac * 2.0 ** -24
    if exp == 31:
        return sign * (float("inf") if frac == 0 else float("nan"))
    return sign * (1 + frac / 1024.0) * 2.0 ** (exp - 15)


# ---------------------------------------------------------------------------
# SMILE — the Jackson binary JSON format, document subset.
# Encoder writes without shared-string back-references (legal per spec);
# decoder understands the common token space including shared-name refs.
# ---------------------------------------------------------------------------

def _smile_encode(value: Any) -> bytes:
    out = bytearray(_SMILE_MAGIC)
    out.append(0x00)          # version 0, no shared names/values, no raw
    _smile_write(value, out)
    return bytes(out)


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63) if n < 0 else n << 1


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _smile_vint(n: int, out: bytearray) -> None:
    """Smile VInt: 7 bits per byte big-endian-ish, LAST byte holds 6 bits
    with the sign bit 0x80 set."""
    chunks = [n & 0x3F]
    n >>= 6
    while n:
        chunks.append(n & 0x7F)
        n >>= 7
    for c in reversed(chunks[1:]):
        out.append(c)
    out.append(0x80 | chunks[0])


def _smile_write(v: Any, out: bytearray) -> None:
    if v is None:
        out.append(0x21)
    elif v is True:
        out.append(0x23)
    elif v is False:
        out.append(0x22)
    elif isinstance(v, int):
        z = _zigzag(v)
        out.append(0x24 if z < (1 << 32) else 0x25)   # int32 / int64 vint
        _smile_vint(z, out)
    elif isinstance(v, float):
        out.append(0x29)      # 64-bit double
        bits = struct.unpack(">Q", struct.pack(">d", v))[0]
        # doubles are written as 10 x 7-bit groups, high bits first
        for shift in range(63, -1, -7):
            out.append((bits >> shift) & 0x7F)
    elif isinstance(v, str):
        # long variable-length unicode for every size: always correct
        # (the tiny/short tokens are an encoding-size optimization only)
        b = v.encode("utf-8")
        if not b:
            out.append(0x20)  # empty string
        else:
            out.append(0xE4)
            out += b
            out.append(0xFC)  # end-of-string marker
    elif isinstance(v, bytes):
        out.append(0xE8)      # "safe" binary (7-bit) — encode base64-free
        _smile_vint(len(v), out)
        # 7-bit packing: 7 bytes -> 8 septets
        bits = 0
        nbits = 0
        for byte in v:
            bits = (bits << 8) | byte
            nbits += 8
            while nbits >= 7:
                out.append((bits >> (nbits - 7)) & 0x7F)
                nbits -= 7
        if nbits:
            out.append((bits << (7 - nbits)) & 0x7F)
    elif isinstance(v, (list, tuple)):
        out.append(0xF8)      # START_ARRAY
        for item in v:
            _smile_write(item, out)
        out.append(0xF9)      # END_ARRAY
    elif isinstance(v, dict):
        out.append(0xFA)      # START_OBJECT
        for k, item in v.items():
            _smile_write_key(str(k), out)
            _smile_write(item, out)
        out.append(0xFB)      # END_OBJECT
    else:
        raise IllegalArgumentError(
            f"cannot SMILE-encode [{type(v).__name__}]")


def _smile_write_key(key: str, out: bytearray) -> None:
    b = key.encode("utf-8")
    out.append(0x34)          # long (variable-length) unicode name
    out += b
    out.append(0xFC)


class _SmileReader:
    def __init__(self, raw: bytes):
        if not raw.startswith(_SMILE_MAGIC):
            raise IllegalArgumentError("not a SMILE document")
        self.raw = raw
        self.i = 4            # skip magic + flags byte
        self.flags = raw[3]
        self.shared_names: list = []

    def byte(self) -> int:
        b = self.raw[self.i]
        self.i += 1
        return b

    def read_vint(self) -> int:
        n = 0
        while True:
            b = self.byte()
            if b & 0x80:
                return (n << 6) | (b & 0x3F)
            n = (n << 7) | b

    def until_fc(self) -> bytes:
        start = self.i
        end = self.raw.index(b"\xfc", start)
        self.i = end + 1
        return self.raw[start:end]

    def read_value(self) -> Any:
        t = self.byte()
        if t == 0x21:
            return None
        if t == 0x22:
            return False
        if t == 0x23:
            return True
        if t in (0x24, 0x25):                   # int32 / int64 vint
            return _unzigzag(self.read_vint())
        if t == 0x28:                           # 32-bit float
            bits = 0
            for _ in range(5):
                bits = (bits << 7) | (self.byte() & 0x7F)
            return struct.unpack(">f", struct.pack(">I",
                                                   bits & 0xFFFFFFFF))[0]
        if t == 0x29:                           # 64-bit double
            bits = 0
            for _ in range(10):
                bits = (bits << 7) | (self.byte() & 0x7F)
            return struct.unpack(
                ">d", struct.pack(">Q", bits & (2 ** 64 - 1)))[0]
        if t == 0x20:
            return ""
        if 0x01 <= t <= 0x1F:                   # shared value refs: no
            raise IllegalArgumentError(
                "SMILE shared-value references are not supported")
        if 0x40 <= t <= 0x5F:                   # tiny ASCII (1..32 chars)
            n = (t & 0x1F) + 1
            s = self.raw[self.i : self.i + n].decode("utf-8")
            self.i += n
            return s
        if 0x60 <= t <= 0x7F:                   # small ASCII (33..64)
            n = (t & 0x1F) + 33
            s = self.raw[self.i : self.i + n].decode("utf-8")
            self.i += n
            return s
        if 0x80 <= t <= 0x9F:                   # tiny unicode (2..33)
            n = (t & 0x1F) + 2
            s = self.raw[self.i : self.i + n].decode("utf-8")
            self.i += n
            return s
        if 0xA0 <= t <= 0xBF:                   # short unicode (34..65)
            n = (t & 0x1F) + 34
            s = self.raw[self.i : self.i + n].decode("utf-8")
            self.i += n
            return s
        if t in (0xE0, 0xE4):                   # long ASCII/unicode
            return self.until_fc().decode("utf-8")
        if t == 0xE8:                           # safe binary (7-bit)
            n = self.read_vint()
            total_septets = (n * 8 + 6) // 7
            bits = 0
            nbits = 0
            out = bytearray()
            for _ in range(total_septets):
                bits = (bits << 7) | (self.byte() & 0x7F)
                nbits += 7
                if nbits >= 8:
                    out.append((bits >> (nbits - 8)) & 0xFF)
                    nbits -= 8
            return bytes(out[:n])
        if t == 0xF8:                           # START_ARRAY
            items = []
            while self.raw[self.i] != 0xF9:
                items.append(self.read_value())
            self.i += 1
            return items
        if t == 0xFA:                           # START_OBJECT
            obj = {}
            while self.raw[self.i] != 0xFB:
                key = self.read_key()
                obj[key] = self.read_value()
            self.i += 1
            return obj
        raise IllegalArgumentError(
            f"unsupported SMILE value token [0x{t:02x}]")

    def read_key(self) -> str:
        t = self.byte()
        if t == 0x20:
            return ""
        if 0x30 <= t <= 0x33:
            # LONG shared name ref: 2 bytes, 10-bit index
            # ((t & 0x3) << 8 | next) — indexes 64..1023
            idx = ((t & 0x03) << 8) | self.byte()
            return self.shared_names[idx]
        if 0x40 <= t <= 0x7F:                   # short shared ref (0..63)
            return self.shared_names[t - 0x40]
        if t == 0x34:                           # long unicode name
            name = self.until_fc().decode("utf-8")
            self._share(name)
            return name
        if 0x80 <= t <= 0xBF:                   # short ASCII name
            n = (t & 0x3F) + 1
            name = self.raw[self.i : self.i + n].decode("utf-8")
            self.i += n
            self._share(name)
            return name
        if 0xC0 <= t <= 0xF7:                   # short unicode name
            n = (t & 0x3F) + 2
            name = self.raw[self.i : self.i + n].decode("utf-8")
            self.i += n
            self._share(name)
            return name
        raise IllegalArgumentError(
            f"unsupported SMILE key token [0x{t:02x}]")

    def _share(self, name: str) -> None:
        if len(name.encode("utf-8")) <= 64:
            self.shared_names.append(name)


def _smile_decode(raw: bytes) -> Any:
    return _SmileReader(raw).read_value()
