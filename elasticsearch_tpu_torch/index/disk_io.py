"""Checksummed disk IO: CRC32 footers + the fault-injection seam.

Reference analog: Lucene's CodecUtil.writeFooter/checkFooter (every
segment file ends in a magic + CRC32 trailer that readers verify) and the
reference Store's verifying IndexInput. Every on-disk artifact of a shard
(segment arrays, segment meta, live masks, commit points, corruption
markers) is written as ``payload + footer`` through one ``DiskIO`` object,
and read back through the same object with the footer verified — a
mismatch raises :class:`ShardCorruptedError` instead of surfacing as an
arbitrary parse error (or worse, silent wrong results).

``DiskIO`` is also the chaos seam: the test harness subclasses it to
inject seeded bit-flips, tail truncation, and ``EIO``/``ENOSPC`` write
failures underneath ``Store``/``Translog`` without touching engine code
(the MockDirectoryWrapper role of the reference test framework).
"""

from __future__ import annotations

import contextlib
import os
import struct
import zlib
from pathlib import Path

from elasticsearch_tpu_torch.utils.errors import ShardCorruptedError

# footer: 4-byte magic + little-endian CRC32 of everything before it
FOOTER_MAGIC = b"ESCK"
_FOOTER = struct.Struct("<4sI")
FOOTER_SIZE = _FOOTER.size

# streaming read/verify chunk: bounds the extra memory of checksummed IO
# at O(chunk) instead of O(artifact) — the whole point of the streaming
# writer/reader pair below
STREAM_CHUNK = 1 << 20


def pack_footer(payload: bytes) -> bytes:
    """payload -> payload + (magic, crc32) trailer."""
    return payload + _FOOTER.pack(FOOTER_MAGIC, zlib.crc32(payload))


def _check_footer(path: str | Path, magic: bytes, expected_crc: int,
                  actual_crc: int) -> None:
    """Shared footer verdict so the buffered and streaming readers raise
    byte-identical diagnostics (naming the file, like the reference's
    CorruptIndexException resource string)."""
    if magic != FOOTER_MAGIC:
        raise ShardCorruptedError(
            f"[{Path(path).name}] has no checksum footer "
            f"(bad magic {magic!r})")
    if actual_crc != expected_crc:
        raise ShardCorruptedError(
            f"[{Path(path).name}] failed checksum verification "
            f"(expected={expected_crc:#010x} actual={actual_crc:#010x})")


def unpack_footer(path: str | Path, data: bytes) -> bytes:
    """Verify and strip the footer; raises ShardCorruptedError on a
    missing magic or a CRC mismatch."""
    if len(data) < FOOTER_SIZE:
        raise ShardCorruptedError(
            f"[{Path(path).name}] is truncated below the checksum footer "
            f"({len(data)} bytes)")
    magic, crc = _FOOTER.unpack_from(data, len(data) - FOOTER_SIZE)
    payload = data[: len(data) - FOOTER_SIZE]
    _check_footer(path, magic, crc, zlib.crc32(payload))
    return payload


class ChecksummedWriter:
    """Non-seekable file-like sink feeding a running CRC32.

    Every ``write`` updates the checksum over the CLEAN bytes, then pushes
    the (possibly fault-mutated) bytes to the underlying temp file — the
    same order the buffered path uses, so an injected write fault is a
    crc mismatch at read time, never a silently re-checksummed one.
    Declaring itself unseekable makes zipfile (np.savez) stream with data
    descriptors instead of seeking back to patch headers, which would
    invalidate a linear checksum."""

    def __init__(self, disk_io: "DiskIO", f, path: Path):
        self._io = disk_io
        self._f = f
        self._path = path
        self._dead = False
        self.crc = 0

    def write(self, data) -> int:
        data = bytes(data)
        if self._dead:
            # the enclosing write context already failed and removed the
            # temp file; late flushes (a GC'd ZipFile's end record) are
            # swallowed rather than raised into the finalizer
            return len(data)
        self.crc = zlib.crc32(data, self.crc)
        self._f.write(self._io._fault("write", self._path, data))
        return len(data)

    def flush(self) -> None:
        if not self._dead:
            self._f.flush()

    def seekable(self) -> bool:
        return False

    def writable(self) -> bool:
        return True

    def readable(self) -> bool:
        return False

    def read(self, n: int = -1) -> bytes:
        # present only so duck-type checks (np.savez's zipfile factory)
        # recognize a file object; the sink is write-only
        import io as _io
        raise _io.UnsupportedOperation("not readable")


class PayloadReader:
    """Seekable read-only window over the payload region of a verified
    artifact (the bytes before the footer) — what np.load consumes
    without the whole-file copy ``read_bytes`` + ``unpack_footer`` paid."""

    def __init__(self, f, size: int):
        self._f = f
        self._size = size

    def read(self, n: int = -1) -> bytes:
        pos = self._f.tell()
        remaining = max(self._size - pos, 0)
        if n is None or n < 0 or n > remaining:
            n = remaining
        return self._f.read(n)

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == 2:                      # EOF = payload end
            offset = self._size + offset
            whence = 0
        elif whence == 1:
            offset = self._f.tell() + offset
            whence = 0
        return self._f.seek(min(max(offset, 0), self._size), whence)

    def tell(self) -> int:
        return self._f.tell()

    def seekable(self) -> bool:
        return True

    def readable(self) -> bool:
        return True

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "PayloadReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class DiskIO:
    """All Store/Translog bytes pass through here.

    The base implementation is a plain atomic-write / read / append; the
    chaos layer overrides :meth:`_fault` to perturb operations. ``op`` is
    one of ``write`` / ``append`` / ``read``.
    """

    def _fault(self, op: str, path: Path, data: bytes) -> bytes:
        """Hook: may raise OSError (EIO/ENOSPC) or return mutated bytes."""
        return data

    def write_bytes(self, path: str | Path, data: bytes) -> None:
        """Write-once artifact: temp file + fsync + atomic rename."""
        path = Path(path)
        data = self._fault("write", path, data)
        tmp = path.with_name("." + path.name + ".tmp")
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def append(self, f, path: str | Path, data: bytes) -> None:
        """Append to an open log file (translog records)."""
        data = self._fault("append", Path(path), data)
        f.write(data)

    def read_bytes(self, path: str | Path) -> bytes:
        path = Path(path)
        with open(path, "rb") as f:
            data = f.read()
        return self._fault("read", path, data)

    # -- streaming checksummed IO ---------------------------------------
    #
    # The buffered pair (write_bytes(pack_footer(..)) / unpack_footer(
    # read_bytes(..))) materializes every artifact twice on the host —
    # a ~2x segment-size peak per flush. The streaming pair below feeds a
    # running crc32 into the fsynced temp file as bytes are produced and
    # verifies with one chunked pass, holding O(STREAM_CHUNK) extra
    # memory regardless of artifact size.

    @contextlib.contextmanager
    def open_checksummed_write(self, path: str | Path):
        """Streaming artifact writer: yields a file-like sink; on clean
        exit appends the CRC32 footer over everything written, fsyncs,
        and atomically renames into place (write-once discipline, same
        as write_bytes). On error the temp file is removed and nothing
        replaces the target."""
        path = Path(path)
        tmp = path.with_name("." + path.name + ".tmp")
        sink = None
        try:
            with open(tmp, "wb") as f:
                sink = ChecksummedWriter(self, f, path)
                yield sink
                footer = _FOOTER.pack(FOOTER_MAGIC, sink.crc)
                f.write(self._fault("write", path, footer))
                f.flush()
                os.fsync(f.fileno())
        except BaseException:
            if sink is not None:
                sink._dead = True
            tmp.unlink(missing_ok=True)
            raise
        os.replace(tmp, path)

    def verify_checksum(self, path: str | Path) -> int:
        """Stream the file once through a running crc32 (O(chunk) extra
        memory) and verify the footer; returns the payload length.
        Raises ShardCorruptedError with the same diagnostics as
        unpack_footer on truncation / bad magic / crc mismatch."""
        path = Path(path)
        size = os.path.getsize(path)
        if size < FOOTER_SIZE:
            raise ShardCorruptedError(
                f"[{path.name}] is truncated below the checksum footer "
                f"({size} bytes)")
        payload_len = size - FOOTER_SIZE
        crc = 0
        with open(path, "rb") as f:
            remaining = payload_len
            while remaining > 0:
                chunk = f.read(min(STREAM_CHUNK, remaining))
                if not chunk:
                    raise ShardCorruptedError(
                        f"[{path.name}] shrank while being verified")
                remaining -= len(chunk)
                # read faults mutate the observed bytes; a length-changing
                # fault (injected truncation) simply fails the crc below
                chunk = self._fault("read", path, chunk)
                crc = zlib.crc32(chunk, crc)
            footer = self._fault("read", path, f.read(FOOTER_SIZE))
            if len(footer) < FOOTER_SIZE:
                raise ShardCorruptedError(
                    f"[{path.name}] is truncated below the checksum "
                    f"footer ({size} bytes)")
        magic, expected = _FOOTER.unpack(footer)
        _check_footer(path, magic, expected, crc)
        return payload_len

    def open_verified_read(self, path: str | Path) -> PayloadReader:
        """Verify the artifact with one streaming pass, then hand back a
        seekable reader over just the payload region — the verifying
        streaming reader counterpart of open_checksummed_write."""
        payload_len = self.verify_checksum(path)
        return PayloadReader(open(path, "rb"), payload_len)


# shared default instance: stateless, safe to reuse process-wide
DEFAULT_IO = DiskIO()
