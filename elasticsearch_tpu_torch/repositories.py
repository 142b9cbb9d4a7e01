"""Snapshot repositories: content-addressed incremental blob storage.

Reference analog: repositories/blobstore/BlobStoreRepository.java:156 —
snapshotShard (:1695) copies only segment files the repository doesn't
already hold (content addressing makes snapshots incremental for free) and
restoreShard (:1924) downloads a shard generation back. The unit here is a
whole serialized segment (segments are immutable, so a segment blob is the
exact analog of Lucene's immutable segment files).

Layout under the repository root:
    blobs/<sha256>.npz            segment arrays (shared across snapshots)
    blobs/<sha256>.json           segment meta
    snapshots/<name>.json         snapshot manifest: indices, shard -> blobs
    index.json                    list of snapshot names
"""

from __future__ import annotations

import hashlib
import io
import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from elasticsearch_tpu_torch.index.segment import Segment
from elasticsearch_tpu_torch.index.store import (
    segment_from_payload, segment_payload,
)
from elasticsearch_tpu_torch.utils.errors import (
    IllegalArgumentError, SearchEngineError, ShardCorruptedError,
)


class RepositoryError(SearchEngineError):
    status = 500


class SnapshotMissingError(SearchEngineError):
    status = 404


class FsRepository:
    """Shared-filesystem repository (repositories/fs/FsRepository analog).
    Cloud backends implement the same three blob verbs over object stores."""

    def __init__(self, location: str):
        if not location:
            raise IllegalArgumentError("repository requires a [location]")
        self.root = Path(location)
        (self.root / "blobs").mkdir(parents=True, exist_ok=True)
        (self.root / "snapshots").mkdir(parents=True, exist_ok=True)

    # -- segment blobs (content-addressed) -------------------------------

    def put_segment(self, seg: Segment) -> str:
        """Upload a segment if absent; returns its content hash."""
        arrays, meta = segment_payload(seg)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        data = buf.getvalue()
        meta_bytes = json.dumps(meta, sort_keys=True).encode("utf-8")
        sha = hashlib.sha256(data + meta_bytes).hexdigest()
        npz_path = self.root / "blobs" / f"{sha}.npz"
        if npz_path.exists():
            return sha                     # incremental: already held
        self._atomic_write(npz_path, data)
        self._atomic_write(self.root / "blobs" / f"{sha}.json", meta_bytes)
        return sha

    def get_segment(self, sha: str) -> Segment:
        try:
            data = (self.root / "blobs" / f"{sha}.npz").read_bytes()
            meta_bytes = (self.root / "blobs" / f"{sha}.json").read_bytes()
        except FileNotFoundError:
            raise RepositoryError(f"missing segment blob [{sha}]")
        # content addressing doubles as end-to-end verification: the name
        # IS the expected hash, so a restore can never deserialize a
        # blob that rotted in the repository (BlobStoreIndexShardSnapshot
        # file checksums analog)
        actual = hashlib.sha256(data + meta_bytes).hexdigest()
        if actual != sha:
            raise ShardCorruptedError(
                f"snapshot blob [{sha}] failed verification "
                f"(content hash [{actual}])")
        meta = json.loads(meta_bytes.decode("utf-8"))
        with np.load(io.BytesIO(data)) as arrays:
            return segment_from_payload(meta, arrays)

    # -- snapshot manifests ---------------------------------------------

    def write_snapshot(self, name: str, manifest: Dict[str, Any]) -> None:
        path = self.root / "snapshots" / f"{name}.json"
        self._atomic_write(path,
                           json.dumps(manifest, sort_keys=True).encode())
        names = set(self.list_snapshots())
        names.add(name)
        self._atomic_write(self.root / "index.json",
                           json.dumps(sorted(names)).encode())

    def read_snapshot(self, name: str) -> Dict[str, Any]:
        try:
            with open(self.root / "snapshots" / f"{name}.json") as f:
                return json.load(f)
        except FileNotFoundError:
            raise SnapshotMissingError(f"snapshot [{name}] is missing")

    def list_snapshots(self) -> List[str]:
        try:
            with open(self.root / "index.json") as f:
                return list(json.load(f))
        except FileNotFoundError:
            return []

    def delete_snapshot(self, name: str) -> None:
        manifest = self.read_snapshot(name)
        names = [n for n in self.list_snapshots() if n != name]
        self._atomic_write(self.root / "index.json",
                           json.dumps(sorted(names)).encode())
        (self.root / "snapshots" / f"{name}.json").unlink(missing_ok=True)
        # gc blobs referenced by no remaining snapshot
        still_referenced = set()
        for other in names:
            still_referenced.update(_manifest_blobs(
                self.read_snapshot(other)))
        for sha in _manifest_blobs(manifest) - still_referenced:
            (self.root / "blobs" / f"{sha}.npz").unlink(missing_ok=True)
            (self.root / "blobs" / f"{sha}.json").unlink(missing_ok=True)

    # -- util -----------------------------------------------------------

    @staticmethod
    def _atomic_write(path: Path, data: bytes) -> None:
        tmp = path.with_name("." + path.name + ".tmp")
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)


def _manifest_blobs(manifest: Dict[str, Any]) -> set:
    out = set()
    for index in manifest.get("indices", {}).values():
        for blobs in index.get("shards", {}).values():
            out.update(blobs)
    return out


# ---------------------------------------------------------------------------
# repository registry (cluster-settings backed, RepositoriesService analog)
# ---------------------------------------------------------------------------

def repository_from_settings(name: str,
                             persistent_settings: Dict[str, Any]
                             ) -> FsRepository:
    rtype = persistent_settings.get(f"repositories.{name}.type")
    if rtype is None:
        raise SnapshotMissingError(f"repository [{name}] is missing")
    if rtype != "fs":
        raise IllegalArgumentError(
            f"unknown repository type [{rtype}] for [{name}]")
    return FsRepository(
        persistent_settings.get(f"repositories.{name}.location", ""))


def repository_settings(name: str, body: Dict[str, Any]) -> Dict[str, Any]:
    """PUT _snapshot/{name} body -> persistent-settings entries."""
    rtype = body.get("type")
    if rtype != "fs":
        raise IllegalArgumentError(
            f"repository type must be [fs], got [{rtype}]")
    location = (body.get("settings") or {}).get("location")
    if not location:
        raise IllegalArgumentError("repository requires settings.location")
    return {f"repositories.{name}.type": rtype,
            f"repositories.{name}.location": location}
