"""Write-ahead log (translog).

Reference analog: index/translog/Translog.java:154 — every accepted operation
is appended (add(), Translog.java:525) before being acknowledged; fsync policy
is per-request by default; generations roll over and are trimmed after a
commit makes their operations durable in segments.

Format: one file per generation (``translog-<gen>.log``), length-prefixed
JSON records with a per-record checksum. Binary framing keeps parsing simple
and corruption detectable (CRC32 like the reference's translog checksums).

Integrity discipline (TranslogReader analog): a *torn tail* — the last
record of the newest generation cut short by a crash mid-append — is
truncated at open and replay continues from the fully-synced prefix; an
incomplete record anywhere else, or a CRC mismatch anywhere at all, is
real corruption and raises ``TranslogCorruptedError`` (the shard fails
instead of replaying garbage).
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

from elasticsearch_tpu_torch.index.disk_io import (
    DEFAULT_IO, DiskIO, pack_footer, unpack_footer,
)
from elasticsearch_tpu_torch.utils.errors import ShardCorruptedError


class TranslogCorruptedError(ShardCorruptedError):
    status = 500


@dataclass
class TranslogOp:
    """One logged operation: index / delete / noop, with its seqno."""
    op_type: str                      # 'index' | 'delete' | 'noop'
    seqno: int
    primary_term: int = 1
    doc_id: Optional[str] = None
    source: Optional[Dict[str, Any]] = None
    routing: Optional[str] = None
    version: int = 1
    reason: Optional[str] = None      # for noop

    def to_json(self) -> Dict[str, Any]:
        d = {"op": self.op_type, "seqno": self.seqno, "term": self.primary_term,
             "version": self.version}
        if self.doc_id is not None:
            d["id"] = self.doc_id
        if self.source is not None:
            d["source"] = self.source
        if self.routing is not None:
            d["routing"] = self.routing
        if self.reason is not None:
            d["reason"] = self.reason
        return d

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "TranslogOp":
        return TranslogOp(
            op_type=d["op"], seqno=d["seqno"], primary_term=d.get("term", 1),
            doc_id=d.get("id"), source=d.get("source"), routing=d.get("routing"),
            version=d.get("version", 1), reason=d.get("reason"),
        )


_HEADER = struct.Struct("<II")  # length, crc32


class Translog:
    """Generational WAL with configurable durability.

    durability='request' fsyncs on every add (the reference default,
    IndexSettings INDEX_TRANSLOG_DURABILITY); 'async' leaves fsync to the
    periodic flusher.
    """

    def __init__(self, directory: str | Path, durability: str = "request",
                 disk_io: Optional[DiskIO] = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.durability = durability
        self.io = disk_io or DEFAULT_IO
        gens = self._list_generations()
        # torn-tail recovery happens at open, before the new generation
        # starts: the newest existing generation may end mid-record after
        # a crash mid-append — drop the partial record so replay sees only
        # fully-written ops (TranslogReader's tail handling). The
        # checkpoint bounds it: bytes below the last SYNCED offset are
        # acked history, never a truncatable tail.
        self.truncated_tail_bytes = 0
        # op-granular trim counters: ops dropped below the retention
        # floor (history-unified trim) and above a rollback target
        self.ops_trimmed_below_total = 0
        self.ops_trimmed_above_total = 0
        if gens:
            self.truncated_tail_bytes = self._recover_tail(
                gens[-1], self._synced_offset(gens[-1]))
        self.generation = (gens[-1] + 1) if gens else 1
        self._file = open(self._gen_path(self.generation), "ab")
        self.total_ops = 0
        # per-generation max seqno, maintained live for generations this
        # process writes and lazily scanned for pre-existing ones — the
        # retention-aware trim's "does this gen still back retained
        # history?" probe without rereading files on every flush
        self._gen_max_seqno: Dict[int, int] = {}
        self._write_checkpoint()

    def _gen_path(self, gen: int) -> Path:
        return self.dir / f"translog-{gen}.log"

    def _list_generations(self) -> List[int]:
        gens = []
        for p in self.dir.glob("translog-*.log"):
            try:
                gens.append(int(p.stem.split("-")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(gens)

    def _recover_tail(self, gen: int, synced_offset: int = 0) -> int:
        """Truncate a genuinely torn final record in ``gen``.

        A torn tail is ONE partial append at EOF (crash mid-write). The
        record header (length prefix) is not covered by the payload CRC,
        so a bit-flip in a length prefix also looks like "record runs
        past EOF" — but truncating there would silently destroy every
        acknowledged, fsynced op after the flipped byte. Two guards:

        - the CHECKPOINT: an anomaly strictly below ``synced_offset``
          sits inside fsynced (acked) history — corruption, never a tail;
        - forward scan: a complete CRC-valid record anywhere after the
          anomaly proves real history follows the bad bytes.

        In either case the file is left intact and the read path raises
        TranslogCorruptedError (the shard fails instead of silently
        losing ops). Only an anomaly at/above the synced boundary with
        nothing valid after it is a tail, and only a structurally-
        incomplete one is truncated (a complete record with a bad CRC is
        payload corruption, kept for the read path to report). Returns
        the number of bytes dropped."""
        path = self._gen_path(gen)
        data = path.read_bytes()
        offset = 0
        while offset < len(data):
            if offset + _HEADER.size > len(data):
                break
            length, crc = _HEADER.unpack_from(data, offset)
            end = offset + _HEADER.size + length
            if end > len(data):
                break
            if zlib.crc32(data[offset + _HEADER.size:end]) != crc:
                break   # complete-but-corrupt: corruption, never a tail
            offset = end
        if offset == len(data):
            return 0                          # clean file
        if offset < synced_offset:
            return 0                          # inside acked history
        if self._has_valid_record_after(data, offset + 1):
            return 0                          # history follows: corruption
        if offset + _HEADER.size <= len(data):
            length, _crc = _HEADER.unpack_from(data, offset)
            if offset + _HEADER.size + length <= len(data):
                return 0                      # complete record, bad CRC
        torn = len(data) - offset
        with open(path, "r+b") as f:
            f.truncate(offset)
            f.flush()
            os.fsync(f.fileno())
        return torn

    @staticmethod
    def _has_valid_record_after(data: bytes, start: int) -> bool:
        """True if any complete record with a matching CRC begins at or
        after ``start`` (a 32-bit CRC match at a random offset is a
        ~2**-32 coincidence — strong evidence of real history)."""
        for off in range(start, len(data) - _HEADER.size + 1):
            length, crc = _HEADER.unpack_from(data, off)
            if length == 0:
                continue   # crc32(b"")==0: zero bytes would false-match
            end = off + _HEADER.size + length
            if end > len(data):
                continue
            if zlib.crc32(data[off + _HEADER.size:end]) == crc:
                return True
        return False

    def add(self, op: TranslogOp) -> None:
        payload = json.dumps(op.to_json(), separators=(",", ":")).encode("utf-8")
        rec = _HEADER.pack(len(payload), zlib.crc32(payload)) + payload
        self.io.append(self._file, self._gen_path(self.generation), rec)
        self.total_ops += 1
        if op.seqno > self._gen_max_seqno.get(self.generation, -1):
            self._gen_max_seqno[self.generation] = op.seqno
        if self.durability == "request":
            self.sync()

    def sync(self) -> None:
        self._file.flush()
        os.fsync(self._file.fileno())
        self._write_checkpoint()

    # -- checkpoint (translog.ckp analog) -------------------------------
    #
    # Records {generation, offset} of the last fsync — the durable
    # boundary of acknowledged history. Tail recovery may only truncate
    # ABOVE it: an anomaly below the checkpointed offset is corruption of
    # acked ops (the case a framing-only scan cannot distinguish from a
    # torn write, e.g. a bit-flip in the FINAL record's length prefix).

    def _ckp_path(self) -> Path:
        return self.dir / "translog.ckp"

    def _write_checkpoint(self) -> None:
        payload = json.dumps({
            "generation": self.generation,
            "offset": self._file.tell(),
        }).encode("utf-8")
        self.io.write_bytes(self._ckp_path(), pack_footer(payload))

    def _synced_offset(self, gen: int) -> int:
        """The checkpointed synced byte count for ``gen`` (0 when the
        checkpoint is absent, unreadable, or for another generation —
        recovery then falls back to framing+CRC disambiguation only)."""
        try:
            payload = unpack_footer(self._ckp_path(),
                                    self.io.read_bytes(self._ckp_path()))
            ckp = json.loads(payload.decode("utf-8"))
        except (OSError, ValueError, ShardCorruptedError):
            return 0
        return int(ckp["offset"]) if ckp.get("generation") == gen else 0

    def rollover(self) -> int:
        """Start a new generation (called at flush); returns the new generation."""
        self.sync()
        self._file.close()
        self.generation += 1
        self._file = open(self._gen_path(self.generation), "ab")
        self._write_checkpoint()
        return self.generation

    def trim_below(self, generation: int,
                   keep_from_seqno: Optional[int] = None) -> None:
        """Delete generations older than ``generation`` (their ops are
        committed) — EXCEPT, when ``keep_from_seqno`` is given, ops with
        seqno >= it. Those back the soft-delete operation history across
        restarts (the reference keeps translog/soft-deleted docs up to
        the retention floor even after the commit makes them redundant
        for crash recovery). A generation straddling the floor is
        rewritten op-granular — only ops at/above the floor survive —
        so translog retention tracks history retention exactly instead
        of rounding up to whole generations."""
        for gen in self._list_generations():
            if gen >= generation:
                continue
            if keep_from_seqno is not None and \
                    self._max_seqno_in(gen) >= keep_from_seqno:
                self.ops_trimmed_below_total += self._rewrite_gen(
                    gen, lambda op: op.seqno >= keep_from_seqno)
                continue
            self._gen_path(gen).unlink(missing_ok=True)
            self._gen_max_seqno.pop(gen, None)

    def trim_ops_above(self, seqno: int) -> int:
        """Drop every retained op with seqno > ``seqno`` across all
        generations (Translog.trimOperations analog, used by the
        post-term-bump engine rollback): ops discarded by a rollback
        must not replay on the next crash recovery. Returns the number
        of ops dropped."""
        self._file.flush()
        dropped = 0
        for gen in self._list_generations():
            if self._max_seqno_in(gen) <= seqno:
                continue
            dropped += self._rewrite_gen(gen, lambda op: op.seqno <= seqno)
        self.ops_trimmed_above_total += dropped
        return dropped

    def _rewrite_gen(self, gen: int, keep) -> int:
        """Rewrite generation ``gen`` keeping only ops for which
        ``keep(op)`` is true; returns the number of ops dropped. When
        ``gen`` is the live generation its append handle (and the
        checkpoint) are reopened over the rewritten file."""
        try:
            ops = list(self._read_gen(gen, min_seqno=0))
        except ShardCorruptedError:
            return 0   # unreadable: leave it for the read path to report
        kept = [op for op in ops if keep(op)]
        if len(kept) == len(ops):
            return 0
        is_current = (gen == self.generation)
        if is_current:
            self._file.close()
        buf = bytearray()
        for op in kept:
            payload = json.dumps(op.to_json(),
                                 separators=(",", ":")).encode("utf-8")
            buf += _HEADER.pack(len(payload), zlib.crc32(payload)) + payload
        self.io.write_bytes(self._gen_path(gen), bytes(buf))
        self._gen_max_seqno[gen] = max((op.seqno for op in kept), default=-1)
        if is_current:
            self._file = open(self._gen_path(gen), "ab")
            self._write_checkpoint()
        return len(ops) - len(kept)

    def _max_seqno_in(self, gen: int) -> int:
        if gen not in self._gen_max_seqno:
            mx = -1
            try:
                for op in self._read_gen(gen, min_seqno=0):
                    if op.seqno > mx:
                        mx = op.seqno
            except ShardCorruptedError:
                mx = -1   # unreadable: committed anyway, eligible to trim
            self._gen_max_seqno[gen] = mx
        return self._gen_max_seqno[gen]

    def read_all(self, min_seqno: int = 0) -> Iterator[TranslogOp]:
        """Replay ops with seqno >= min_seqno across all retained generations."""
        self._file.flush()
        for gen in self._list_generations():
            yield from self._read_gen(gen, min_seqno)

    def verify(self) -> int:
        """Walk every retained record, verifying framing + CRC; returns
        the record count (check_on_startup's translog pass)."""
        self._file.flush()
        n = 0
        for gen in self._list_generations():
            for _ in self._read_gen(gen, min_seqno=0):
                n += 1
        return n

    def _read_gen(self, gen: int, min_seqno: int) -> Iterator[TranslogOp]:
        path = self._gen_path(gen)
        data = self.io.read_bytes(path)
        offset = 0
        while offset < len(data):
            if offset + _HEADER.size > len(data):
                # tails were truncated at open — an incomplete record here
                # is a torn write INSIDE retained history: corruption, not
                # a tolerable tail (mid-generation torn writes can hide
                # acknowledged ops)
                raise TranslogCorruptedError(
                    f"translog {path.name} has a truncated record header "
                    f"at offset {offset}")
            length, crc = _HEADER.unpack_from(data, offset)
            start = offset + _HEADER.size
            end = start + length
            if end > len(data):
                raise TranslogCorruptedError(
                    f"translog {path.name} has a truncated record body "
                    f"at offset {offset}")
            payload = data[start:end]
            if zlib.crc32(payload) != crc:
                raise TranslogCorruptedError(
                    f"translog {path.name} corrupted at offset {offset}")
            try:
                op = TranslogOp.from_json(json.loads(payload.decode("utf-8")))
            except (ValueError, KeyError) as e:
                raise TranslogCorruptedError(
                    f"translog {path.name} has an unparseable record at "
                    f"offset {offset}: {e}")
            if op.seqno >= min_seqno:
                yield op
            offset = end

    def close(self) -> None:
        try:
            self.sync()
        finally:
            self._file.close()
