"""Carry an index built by the JAX package into this one.

The system's state is the index, plus the expansion model's weights.
Segments written by either package are the same numpy arrays and Python
lists (the on-disk formats under ``index/`` are shared copies), so
conversion is a field-by-field copy into this package's classes
(rank_features fields included); an IVF index is its five arrays, moved
onto a device; an expansion model is its three weight matrices and its
widths. The reference objects are read
duck-typed — their arrays, dicts and lists only — and nothing of the JAX
package is imported.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Iterable, List

import numpy as np

from elasticsearch_tpu_torch.index import segment as seg_mod
from elasticsearch_tpu_torch.index.segment import Segment

# per-field dataclasses of a segment, by the attribute that holds them
_FIELD_CLASSES = {
    "postings": seg_mod.PostingsField,
    "keywords": seg_mod.KeywordField,
    "doc_values": seg_mod.DocValuesField,
    "vectors": seg_mod.VectorField,
    "features": seg_mod.FeaturesField,
}
# plain per-doc state copied as it is
_PLAIN = ("geo", "sources", "ids", "routings", "id_to_doc", "seqnos",
          "versions", "primary_terms", "live")


def _copy_value(v: Any) -> Any:
    if isinstance(v, np.ndarray):
        return v.copy()
    return copy.deepcopy(v)


def _convert_field(src: Any, cls) -> Any:
    """One reference field object -> ``cls``, copying every init field;
    private caches (names starting with "_") start empty."""
    kwargs = {f.name: _copy_value(getattr(src, f.name))
              for f in dataclasses.fields(cls)
              if f.init and not f.name.startswith("_")}
    return cls(**kwargs)


def segments_from_reference(segments: Iterable[Any]) -> List[Segment]:
    """This package's Segments, equal array for array to the given
    reference segments (same docs, postings, doc values, live masks)."""
    out = []
    for src in segments:
        seg = Segment(src.name, int(src.n_docs))
        for attr, cls in _FIELD_CLASSES.items():
            setattr(seg, attr, {name: _convert_field(f, cls)
                                for name, f in getattr(src, attr).items()})
        for attr in _PLAIN:
            setattr(seg, attr, _copy_value(getattr(src, attr)))
        seg.invalidate_live_count()
        out.append(seg)
    return out


def ivf_from_reference(centroids, lists, valid, ids, norms, similarity: str,
                       device=None):
    """This package's ``IVFIndex`` holding the given arrays of a reference
    IVF index (numpy, or anything ``np.asarray`` reads): centroids
    [nlist, D] f32, lists [nlist, L, D] f32, valid [nlist, L] bool, ids
    [nlist, L] int32 and norms [nlist, L] f32, on ``device``. The search
    can then be held against the reference's on the very same index,
    apart from the build."""
    import torch

    from elasticsearch_tpu_torch.device import resolve_device
    from elasticsearch_tpu_torch.ops.ivf import IVFIndex
    dev = resolve_device(device)

    def put(a, dtype):
        return torch.as_tensor(np.array(a, dtype=dtype), device=dev)
    return IVFIndex(put(centroids, np.float32), put(lists, np.float32),
                    put(valid, bool), put(ids, np.int32), similarity,
                    put(norms, np.float32))


def expansion_model_from_reference(model, device=None):
    """This package's ``TextExpansionModel`` holding a reference expansion
    model's weights (``_emb`` [n_hash, H], ``_w1`` [H, H], ``_w2`` [H, V],
    read with ``np.asarray``) and widths, on ``device``, under the same
    model id; its expansion cache starts empty. The weights are copied,
    not re-made from a seed, so a model whose weights were replaced (a
    state-dict load) carries over as it is."""
    from elasticsearch_tpu_torch.ml.text_expansion import TextExpansionModel
    weights = tuple(np.array(a, dtype=np.float32)
                    for a in (model._emb, model._w1, model._w2))
    return TextExpansionModel(
        model_id=model.model_id, vocab_size=int(model.vocab_size),
        hidden=int(model.hidden), n_hash=int(model.n_hash),
        max_tokens=int(model.max_tokens), top_m=int(model.top_m),
        device=device, weights=weights)
