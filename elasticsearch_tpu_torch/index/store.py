"""On-disk segment format and commit points.

Reference analog: index/store/Store.java:130 + Lucene's segment files and
commit points (segments_N). Layout per shard directory:

    segments/<name>.npz        all numpy arrays, path-keyed
    segments/<name>.meta.json  dicts (term tables), ids, sources, field meta
    commit-<gen>.json          commit point: segment list, seqno watermarks
    corrupted_<uuid>           corruption marker (store refuses to reopen)
    translog/                  WAL (translog.py)

Arrays and metadata are written to temp files and atomically renamed; a
commit point only references fully-written segments (write-once, like
Lucene's flush-then-commit discipline).

Integrity: every artifact carries a CRC32 footer (disk_io.py) written at
write time and verified at read time; a mismatch raises
``ShardCorruptedError``. Once a store is marked corrupted
(``mark_corrupted``), it refuses to reopen until the marker is cleared —
the reference's corruption-marker discipline that keeps a bad copy from
ever being promoted (Store.markStoreCorrupted / failIfCorrupted).
"""

from __future__ import annotations

import io
import json
import uuid as uuid_mod
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from elasticsearch_tpu_torch.index.disk_io import (
    DEFAULT_IO, DiskIO, pack_footer, unpack_footer,
)
from elasticsearch_tpu_torch.index.segment import (
    DocValuesField, FeaturesField, KeywordField, PostingsField, Segment, VectorField,
)
from elasticsearch_tpu_torch.utils.errors import ShardCorruptedError

CORRUPTED_MARKER_PREFIX = "corrupted_"


class Store:
    def __init__(self, path: str | Path, disk_io: Optional[DiskIO] = None):
        self.path = Path(path)
        self.io = disk_io or DEFAULT_IO
        (self.path / "segments").mkdir(parents=True, exist_ok=True)

    # -- segments --------------------------------------------------------

    def write_segment(self, seg: Segment) -> None:
        arrays, meta = segment_payload(seg)
        seg_dir = self.path / "segments"
        # the npz bytes stream straight into the fsynced temp file
        # through a running CRC32 (disk_io.open_checksummed_write): no
        # whole-segment host buffer — the ~2x segment-size peak per
        # flush the buffered writer paid is gone (ROADMAP PR 2 follow-up)
        with self.io.open_checksummed_write(
                seg_dir / f"{seg.name}.npz") as f:
            np.savez(f, **arrays)
        meta_bytes = json.dumps(meta).encode("utf-8")
        self.io.write_bytes(seg_dir / f"{seg.name}.meta.json",
                            pack_footer(meta_bytes))

    def read_segment(self, name: str) -> Segment:
        seg_dir = self.path / "segments"
        meta = json.loads(self._read_verified(
            seg_dir / f"{name}.meta.json").decode("utf-8"))
        # verifying streaming reader: one chunked crc pass, then np.load
        # consumes the payload window directly from disk
        with self.io.open_verified_read(seg_dir / f"{name}.npz") as f, \
                np.load(f) as data:
            return self._segment_from(meta, data)

    def _read_verified(self, path: Path) -> bytes:
        """Read + strip/verify the CRC32 footer (ShardCorruptedError on
        mismatch). A missing file stays FileNotFoundError — absence is a
        different failure than corruption."""
        return unpack_footer(path, self.io.read_bytes(path))

    @staticmethod
    def _segment_from(meta: Dict[str, Any], data) -> Segment:
        seg = Segment(meta["name"], meta["n_docs"])
        seg.ids = meta["ids"]
        seg.routings = meta.get("routings") or [None] * seg.n_docs
        seg.sources = meta["sources"]
        seg.id_to_doc = {doc_id: i for i, doc_id in enumerate(seg.ids)}
        seg.live = data["live"]
        seg.invalidate_live_count()
        seg.seqnos = data["seqnos"]
        seg.versions = data["versions"] if "versions" in data else np.ones(seg.n_docs, np.int64)
        seg.primary_terms = (data["primary_terms"] if "primary_terms" in data
                             else np.ones(seg.n_docs, np.int64))

        for fname, fmeta in meta["fields"]["postings"].items():
            k = f"p.{fname}"
            seg.postings[fname] = PostingsField(
                terms={t: i for i, t in enumerate(fmeta["terms"])},
                block_docs=data[f"{k}.block_docs"],
                block_tfs=data[f"{k}.block_tfs"],
                block_term=data[f"{k}.block_term"],
                block_max_tf=data[f"{k}.block_max_tf"],
                term_block_start=data[f"{k}.term_block_start"],
                term_block_count=data[f"{k}.term_block_count"],
                doc_freq=data[f"{k}.doc_freq"],
                doc_lens=data[f"{k}.doc_lens"],
                sum_doc_len=fmeta["sum_doc_len"],
                pos_offsets=data[f"{k}.pos_offsets"],
                pos_flat=data[f"{k}.pos_flat"],
            )
        for fname, fmeta in meta["fields"]["keywords"].items():
            k = f"k.{fname}"
            seg.keywords[fname] = KeywordField(
                terms={t: i for i, t in enumerate(fmeta["terms"])},
                ord_values=data[f"{k}.ord_values"],
                ord_offsets=data[f"{k}.ord_offsets"],
                doc_freq=data[f"{k}.doc_freq"],
                term_list=fmeta["terms"],
            )
        for fname, fmeta in meta["fields"]["doc_values"].items():
            k = f"d.{fname}"
            seg.doc_values[fname] = DocValuesField(
                values=data[f"{k}.values"],
                exists=data[f"{k}.exists"],
                multi={int(i): v for i, v in fmeta["multi"].items()},
            )
        for fname, fmeta in meta["fields"]["vectors"].items():
            k = f"v.{fname}"
            seg.vectors[fname] = VectorField(
                matrix=data[f"{k}.matrix"],
                exists=data[f"{k}.exists"],
                norms=data[f"{k}.norms"],
                similarity=fmeta["similarity"],
                dims=fmeta["dims"],
            )
        for fname, fmeta in meta["fields"]["features"].items():
            k = f"f.{fname}"
            seg.features[fname] = FeaturesField(
                features={t: i for i, t in enumerate(fmeta["features"])},
                block_docs=data[f"{k}.block_docs"],
                block_weights=data[f"{k}.block_weights"],
                block_max_weight=data[f"{k}.block_max_weight"],
                feat_block_start=data[f"{k}.feat_block_start"],
                feat_block_count=data[f"{k}.feat_block_count"],
                doc_freq=data[f"{k}.doc_freq"],
            )
        for fname in meta["fields"]["geo"]:
            seg.geo[fname] = data[f"g.{fname}"]
        return seg

    def delete_segment(self, name: str) -> None:
        (self.path / "segments" / f"{name}.npz").unlink(missing_ok=True)
        (self.path / "segments" / f"{name}.meta.json").unlink(missing_ok=True)
        (self.path / "segments" / f"{name}.liv.npy").unlink(missing_ok=True)

    def write_live_mask(self, seg: Segment) -> None:
        """Persist only the live-docs mask (deletes), like Lucene .liv files."""
        buf = io.BytesIO()
        np.save(buf, seg.live)
        self.io.write_bytes(self.path / "segments" / f"{seg.name}.liv.npy",
                            pack_footer(buf.getvalue()))

    def read_live_mask(self, name: str) -> Optional[np.ndarray]:
        p = self.path / "segments" / f"{name}.liv.npy"
        if p.exists():
            return np.load(io.BytesIO(self._read_verified(p)))
        return None

    # -- commit points ---------------------------------------------------

    def write_commit(self, generation: int, segment_names: List[str],
                     max_seqno: int, local_checkpoint: int,
                     translog_generation: int,
                     extra: Optional[Dict[str, Any]] = None) -> None:
        commit = {
            "generation": generation,
            "segments": segment_names,
            "max_seqno": max_seqno,
            "local_checkpoint": local_checkpoint,
            "translog_generation": translog_generation,
            "extra": extra or {},
        }
        self.io.write_bytes(self.path / f"commit-{generation}.json",
                            pack_footer(json.dumps(commit).encode("utf-8")))
        # prune older commit points
        for p in self.path.glob("commit-*.json"):
            try:
                gen = int(p.stem.split("-")[1])
            except (IndexError, ValueError):
                continue
            if gen < generation:
                p.unlink(missing_ok=True)

    def read_latest_commit(self) -> Optional[Dict[str, Any]]:
        commits = []
        for p in self.path.glob("commit-*.json"):
            try:
                commits.append((int(p.stem.split("-")[1]), p))
            except (IndexError, ValueError):
                continue
        if not commits:
            return None
        _, path = max(commits)
        return json.loads(self._read_verified(path).decode("utf-8"))

    def list_segment_files(self) -> List[str]:
        return sorted(p.stem for p in (self.path / "segments").glob("*.npz"))

    def local_shard_state(self) -> Dict[str, Any]:
        """What this on-disk copy IS, without opening it: the last commit's
        allocation id + seqno watermarks, whether the commit's checksum
        verified, and any corruption marker. This is the per-shard answer
        to the gateway's ``_list_gateway_started_shards`` fetch
        (TransportNodesListGatewayStartedShards / ShardStateMetadata
        analog), so the master can allocate restarted primaries to the
        node holding the freshest non-corrupted copy."""
        out: Dict[str, Any] = {
            "has_data": False, "allocation_id": None, "generation": -1,
            "max_seqno": -1, "local_checkpoint": -1,
            "corrupted": self.corruption_reason(), "verified": False,
        }
        try:
            commit = self.read_latest_commit()
        except ShardCorruptedError as e:
            # an unreadable commit point is data we must not trust — but
            # it IS data: report the copy as present-and-corrupted so the
            # allocator refuses it instead of calling the store empty
            out["has_data"] = True
            out["corrupted"] = out["corrupted"] or str(e)
            return out
        if commit is None:
            return out
        out.update(
            has_data=True,
            generation=commit["generation"],
            max_seqno=commit["max_seqno"],
            local_checkpoint=commit["local_checkpoint"],
            allocation_id=(commit.get("extra") or {}).get("allocation_id"),
            primary_term=(commit.get("extra") or {}).get(
                "primary_term", -1),
            # lease watermarks ride the fetch so the allocator can
            # prefer copies a live primary still retains history for
            retention_leases=(commit.get("extra") or {}).get(
                "retention_leases", []),
            # the commit footer just verified on read; segment payloads
            # are NOT walked here (fetch must stay cheap) — full
            # verification still happens at recovery open
            verified=True)
        return out

    # -- corruption markers ---------------------------------------------

    def mark_corrupted(self, reason: str) -> None:
        """Write a ``corrupted_<uuid>`` marker recording the first failure;
        the store refuses to reopen while a marker exists. Idempotent: the
        original cause is kept (Store.markStoreCorrupted)."""
        if self.corruption_reason() is not None:
            return
        marker = self.path / f"{CORRUPTED_MARKER_PREFIX}{uuid_mod.uuid4().hex}"
        try:
            self.io.write_bytes(
                marker, pack_footer(json.dumps({"reason": reason}).encode()))
        except OSError:
            # a dying disk may refuse the marker too; the shard still
            # fails through the engine-failure path
            pass

    def corruption_reason(self) -> Optional[str]:
        for p in sorted(self.path.glob(f"{CORRUPTED_MARKER_PREFIX}*")):
            try:
                payload = unpack_footer(p, self.io.read_bytes(p))
                return json.loads(payload.decode("utf-8")).get(
                    "reason", "unknown")
            except (OSError, ValueError, ShardCorruptedError):
                return f"unreadable corruption marker [{p.name}]"
        return None

    @property
    def is_corrupted(self) -> bool:
        return self.corruption_reason() is not None

    def ensure_not_corrupted(self) -> None:
        """Raise if a corruption marker exists (Store.failIfCorrupted) —
        a marked copy must never be reopened, served, or used as a
        recovery source."""
        reason = self.corruption_reason()
        if reason is not None:
            raise ShardCorruptedError(
                f"store at [{self.path}] is marked corrupted: {reason}")

    def clear_corruption_markers(self) -> int:
        """Operator/fresh-copy escape hatch; returns markers removed."""
        removed = 0
        for p in self.path.glob(f"{CORRUPTED_MARKER_PREFIX}*"):
            p.unlink(missing_ok=True)
            removed += 1
        return removed

    # -- verification ----------------------------------------------------

    def verify_integrity(self) -> Dict[str, int]:
        """Verify the CRC32 footer of every artifact the latest commit
        references (``index.shard.check_on_startup: checksum``). Footer
        checks only — no deserialization — so the cost is one sequential
        read per file. Raises ShardCorruptedError on the first mismatch;
        returns {files_verified: n} on success."""
        verified = 0
        commit = self.read_latest_commit()   # itself footer-verified
        if commit is None:
            return {"files_verified": 0}
        verified += 1
        seg_dir = self.path / "segments"
        for name in commit["segments"]:
            for suffix in (".npz", ".meta.json"):
                # streaming crc pass: O(chunk) memory even for the
                # multi-GB npz artifacts
                self.io.verify_checksum(seg_dir / f"{name}{suffix}")
                verified += 1
            liv = seg_dir / f"{name}.liv.npy"
            if liv.exists():
                self.io.verify_checksum(liv)
                verified += 1
        return {"files_verified": verified}


def segment_payload(seg: Segment):
    """(arrays, json-able meta) — the full serialized form of a segment.
    Shared by the on-disk store and the snapshot repository format."""
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {
        "name": seg.name, "n_docs": seg.n_docs,
        "ids": seg.ids, "sources": seg.sources,
        "routings": seg.routings,
        "fields": {"postings": {}, "keywords": {}, "doc_values": {},
                   "vectors": {}, "features": {}, "geo": []},
    }
    arrays["live"] = seg.live
    arrays["seqnos"] = seg.seqnos
    arrays["versions"] = seg.versions
    arrays["primary_terms"] = seg.primary_terms

    for fname, pf in seg.postings.items():
        k = f"p.{fname}"
        term_list = [""] * len(pf.terms)
        for t, tid in pf.terms.items():
            term_list[tid] = t
        meta["fields"]["postings"][fname] = {
            "terms": term_list, "sum_doc_len": pf.sum_doc_len}
        arrays[f"{k}.block_docs"] = pf.block_docs
        arrays[f"{k}.block_tfs"] = pf.block_tfs
        arrays[f"{k}.block_term"] = pf.block_term
        arrays[f"{k}.block_max_tf"] = pf.block_max_tf
        arrays[f"{k}.term_block_start"] = pf.term_block_start
        arrays[f"{k}.term_block_count"] = pf.term_block_count
        arrays[f"{k}.doc_freq"] = pf.doc_freq
        arrays[f"{k}.doc_lens"] = pf.doc_lens
        arrays[f"{k}.pos_offsets"] = pf.pos_offsets
        arrays[f"{k}.pos_flat"] = pf.pos_flat

    for fname, kf in seg.keywords.items():
        k = f"k.{fname}"
        meta["fields"]["keywords"][fname] = {"terms": kf.term_list}
        arrays[f"{k}.ord_values"] = kf.ord_values
        arrays[f"{k}.ord_offsets"] = kf.ord_offsets
        arrays[f"{k}.doc_freq"] = kf.doc_freq

    for fname, dv in seg.doc_values.items():
        k = f"d.{fname}"
        meta["fields"]["doc_values"][fname] = {
            "multi": {str(i): v for i, v in dv.multi.items()}}
        arrays[f"{k}.values"] = dv.values
        arrays[f"{k}.exists"] = dv.exists

    for fname, vf in seg.vectors.items():
        k = f"v.{fname}"
        meta["fields"]["vectors"][fname] = {"similarity": vf.similarity, "dims": vf.dims}
        arrays[f"{k}.matrix"] = vf.matrix
        arrays[f"{k}.exists"] = vf.exists
        arrays[f"{k}.norms"] = vf.norms

    for fname, ff in seg.features.items():
        k = f"f.{fname}"
        feat_list = [""] * len(ff.features)
        for t, fid in ff.features.items():
            feat_list[fid] = t
        meta["fields"]["features"][fname] = {"features": feat_list}
        arrays[f"{k}.block_docs"] = ff.block_docs
        arrays[f"{k}.block_weights"] = ff.block_weights
        arrays[f"{k}.block_max_weight"] = ff.block_max_weight
        arrays[f"{k}.feat_block_start"] = ff.feat_block_start
        arrays[f"{k}.feat_block_count"] = ff.feat_block_count
        arrays[f"{k}.doc_freq"] = ff.doc_freq

    for fname, arr in seg.geo.items():
        meta["fields"]["geo"].append(fname)
        arrays[f"g.{fname}"] = arr

    return arrays, meta


def segment_from_payload(meta, data) -> Segment:
    """Inverse of segment_payload (shared with the snapshot repository)."""
    return Store._segment_from(meta, data)
