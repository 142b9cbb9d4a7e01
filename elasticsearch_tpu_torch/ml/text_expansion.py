"""Learned sparse text expansion (ELSER-class) on the card.

The JAX package's ``ml/text_expansion.py``: a hashed n-gram MLP whose
forward pass -- embedding-sum over hashed token/bigram ids -> GELU MLP ->
non-negative activations over a fixed feature vocabulary, normalized by
their row max, plus a +2.0 lexical anchor for each of the text's own
tokens -> top-m (feature, weight) pairs -- is one kernel family,
``text_expansion_forward`` (K18, ``csrc/text_expansion_forward.cu``).
The wrapper launches it for CUDA tensors and runs the plain PyTorch
version for CPU tensors; there is no fallback between the two.

The weights are made from ``np.random.default_rng(seed)`` exactly as the
JAX package makes them, so the two packages hold the same model bit for
bit with nothing to download. Both products sum in k order with each
product and sum rounded once, in the kernel and in its plain version; the
JAX program leaves its products to XLA, so the two packages' weights
differ within the rounding of a 256-term f32 sum, and ``lax.top_k``'s
order may differ at near-ties.

Host glue copied from the JAX package: ``_stable_hash``, ``_featurize``,
``expand_batch`` (its cache, the 1e-4 cut-off and the 4-decimal
rounding), the registry (an unknown model id is a 404) and
``rewrite_body_expansions``. A model lives on one device, so the
registry keys deployed models by (model id, device).
"""

from __future__ import annotations

import hashlib
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.device import DeviceLike, resolve_device
from elasticsearch_tpu_torch.ops.bm25 import (
    KMAX, _check, _on_cuda, _ptr, _stream, launch_kernel, stable_topk,
)
from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE

DEFAULT_MODEL_ID = ".elser-tpu-1"

_TOKEN_RX = re.compile(r"[a-z0-9]+")

# jax.nn.gelu's constants in f32: 0.044715, sqrt(2 / pi) (rounded from
# f64, as the JAX function rounds it), 0.5, 1.0; then the 1e-6 of the
# row normalization
GELU_CONSTS = tuple(float(np.float32(c)) for c in (
    0.044715, np.sqrt(2 / np.pi), 0.5, 1.0))
NORM_EPS = float(np.float32(1e-6))
# vocabulary columns per CTA of the kernel's second product
# (csrc/text_expansion_forward.cu TILE)
TILE = 1024


def _stable_hash(s: str, mod: int) -> int:
    """Process-independent hash (Python's str hash is salted per process;
    a model's feature space must be stable across nodes and restarts)."""
    return int.from_bytes(hashlib.blake2b(
        s.encode("utf-8"), digest_size=8).digest(), "little") % mod


# ---------------------------------------------------------------------------
# the forward pass: plain version and kernel wrapper
# ---------------------------------------------------------------------------

def _seq_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, K] @ w [K, N], each output summed in k order with every
    product and every sum rounded once (the kernel's order)."""
    acc = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float32,
                      device=x.device)
    for k in range(x.shape[1]):
        acc.add_(x[:, k:k + 1] * w[k])
    return acc


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu (tanh approximation), one rounded op at a time:
    x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * ((x * x) * x)))))."""
    cube, sqrt2pi, half, one = GELU_CONSTS
    inner = x + cube * ((x * x) * x)
    return x * (half * (one + torch.tanh(sqrt2pi * inner)))


def text_expansion_forward_plain(ids, direct, emb, w1, w2, top_m: int):
    b, n_tok = ids.shape
    x = torch.zeros(b, emb.shape[1], dtype=torch.float32, device=emb.device)
    for t in range(n_tok):
        x = x + emb[ids[:, t].long()]
    h = _gelu(_seq_matmul(x, w1))
    out = torch.clamp_min(_seq_matmul(h, w2), 0.0)
    out = out / (NORM_EPS + out.amax(dim=1, keepdim=True))
    vocab = w2.shape[1]
    valid = (direct >= 0) & (direct < vocab)
    cnt = torch.zeros(b, vocab, dtype=torch.int32, device=emb.device)
    cnt.scatter_add_(1, torch.where(valid, direct, 0).long(),
                     valid.to(torch.int32))
    return stable_topk(cnt.float() * 2.0 + out, top_m)


_SIG = ["p"] * 5 + ["i"] * 5 + ["f"] * 5 + ["p"] * 6


def text_expansion_forward(ids, direct, emb, w1, w2, top_m: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K18. The expansion model's forward over B texts: ``ids`` [B, L]
    int32 hashed input ids (0 = padding, the zero embedding row),
    ``direct`` [B, L] int32 vocabulary ids of the text's own tokens (-1 =
    padding); ``emb`` [n_hash, H], ``w1`` [H, H], ``w2`` [H, V] f32.
    Returns the top-m (weights [B, top_m] f32, feature ids [B, top_m]
    int32) of anchor + out / (1e-6 + max(out)), out = relu(gelu(sum emb
    @ W1) @ W2), in lax.top_k's order."""
    cuda = _on_cuda(ids, direct, emb, w1, w2)
    if ids.dim() != 2 or emb.dim() != 2 or w2.dim() != 2:
        raise ValueError("[ids] must be [B, L], [emb] [n_hash, H], "
                         "[w2] [H, V]")
    b, n_tok = ids.shape
    hidden, vocab = emb.shape[1], w2.shape[1]
    _check("ids", ids, torch.int32, (b, n_tok))
    _check("direct", direct, torch.int32, (b, n_tok))
    _check("emb", emb, torch.float32, (emb.shape[0], hidden))
    _check("w1", w1, torch.float32, (hidden, hidden))
    _check("w2", w2, torch.float32, (hidden, vocab))
    if not 1 <= top_m <= min(KMAX, vocab):
        raise ValueError(f"top_m={top_m} outside [1, {min(KMAX, vocab)}]")
    label = f"b={b}/hidden={hidden}/vocab={vocab}"
    with DEVICE_PROFILE.call("text_expansion_forward", label, cuda):
        if not cuda:
            return text_expansion_forward_plain(ids, direct, emb, w1, w2,
                                                top_m)
        if b < 1:
            raise ValueError("text_expansion_forward needs B >= 1")
        dev = emb.device
        hid = torch.empty(b, hidden, dtype=torch.float32, device=dev)
        out = torch.empty(b, vocab, dtype=torch.float32, device=dev)
        tile_max = torch.empty(b, -(-vocab // TILE), dtype=torch.float32,
                               device=dev)
        weights = torch.empty(b, top_m, dtype=torch.float32, device=dev)
        fids = torch.empty(b, top_m, dtype=torch.int32, device=dev)
        launch_kernel("text_expansion_forward", _SIG, _ptr(ids),
                      _ptr(direct), _ptr(emb), _ptr(w1), _ptr(w2), b, n_tok,
                      hidden, vocab, top_m, *GELU_CONSTS, NORM_EPS,
                      _ptr(hid), _ptr(out), _ptr(tile_max), _ptr(weights),
                      _ptr(fids), _stream())
        return weights, fids


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class TextExpansionModel:
    """text -> [(feature_name, weight)] via one kernel launch per batch."""

    def __init__(self, model_id: str = DEFAULT_MODEL_ID,
                 vocab_size: int = 8192, hidden: int = 256,
                 n_hash: int = 1 << 15, max_tokens: int = 64,
                 top_m: int = 32, seed: int = 7, device: DeviceLike = None,
                 weights: Optional[Tuple[np.ndarray, ...]] = None):
        """``weights``: (emb, w1, w2) to hold instead of the ones made from
        ``seed`` (a state-dict load; see ``convert``)."""
        self.model_id = model_id
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.n_hash = n_hash
        self.max_tokens = max_tokens
        self.top_m = top_m
        self.device = resolve_device(device)
        self._cache: Dict[str, Dict[str, float]] = {}

        if weights is not None:
            emb, w1, w2 = weights
        else:
            rng = np.random.default_rng(seed)
            scale = 1.0 / np.sqrt(hidden)
            # embedding row 0 is the padding slot and stays zero
            emb = rng.standard_normal((n_hash, hidden)).astype(np.float32) \
                * scale
            emb[0] = 0.0
            w1 = rng.standard_normal((hidden, hidden)).astype(np.float32) \
                * scale
            w2 = rng.standard_normal((hidden, vocab_size)).astype(
                np.float32) * scale
        # charge the device breaker BEFORE upload so an over-budget deploy
        # 429s instead of running the card out of memory; release follows
        # model GC
        from elasticsearch_tpu_torch.indices.breaker import charge_device
        charge_device(self, emb.nbytes + w1.nbytes + w2.nbytes,
                      f"model[{model_id}]")
        # to f32 as the JAX package's upload converts them
        self._emb, self._w1, self._w2 = (
            torch.as_tensor(np.asarray(a, np.float32), device=self.device)
            for a in (emb, w1, w2))

    def _forward(self, ids: np.ndarray, direct: np.ndarray
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        return text_expansion_forward(
            torch.as_tensor(ids, device=self.device),
            torch.as_tensor(direct, device=self.device),
            self._emb, self._w1, self._w2, self.top_m)

    # -- host-side featurization --------------------------------------------

    def _featurize(self, text: str) -> Tuple[np.ndarray, np.ndarray]:
        toks = _TOKEN_RX.findall(text.lower())[: self.max_tokens]
        ids = np.zeros(self.max_tokens, np.int32)
        direct = np.full(self.max_tokens, -1, np.int32)
        for i, t in enumerate(toks):
            # unigram + leading-bigram context into the hashed input space
            # (slot 0 is reserved for padding)
            ids[i] = 1 + _stable_hash(
                t if i == 0 else toks[i - 1] + "_" + t, self.n_hash - 1)
            direct[i] = _stable_hash(t, self.vocab_size)
        return ids, direct

    # -- inference ------------------------------------------------------------

    CACHE_CAP = 8192

    def expand_batch(self, texts: Sequence[str]) -> List[Dict[str, float]]:
        """One kernel launch for the batch's cache misses; hits are free.
        The bulk-ingest prewarm and repeated queries ride this cache."""
        misses = [t for t in dict.fromkeys(texts) if t not in self._cache]
        if misses:
            b = len(misses)
            ids = np.zeros((b, self.max_tokens), np.int32)
            direct = np.full((b, self.max_tokens), -1, np.int32)
            for i, t in enumerate(misses):
                ids[i], direct[i] = self._featurize(t)
            w, f = self._forward(ids, direct)
            w = w.cpu().numpy()
            f = f.cpu().numpy()
            for i, t in enumerate(misses):
                tokens = {}
                for weight, fid in zip(w[i], f[i]):
                    if weight <= 1e-4:
                        break                # top_k is sorted descending
                    tokens[f"f{int(fid)}"] = round(float(weight), 4)
                while len(self._cache) >= self.CACHE_CAP:
                    self._cache.pop(next(iter(self._cache)))
                self._cache[t] = tokens
        return [dict(self._cache[t]) for t in texts]

    def expand(self, text: str) -> Dict[str, float]:
        return self.expand_batch([text])[0]


# ---------------------------------------------------------------------------
# registry (TrainedModelProvider analog; deterministic built-in default)
# ---------------------------------------------------------------------------

def rewrite_body_expansions(body: Dict, device: DeviceLike = None) -> Dict:
    """Replace every text_expansion clause carrying ``model_text`` with its
    precomputed ``tokens``, running ONE batched inference launch for all
    clauses in the request, with the model deployed on ``device``.

    The coordinator calls this once per search — the reference rewrites
    TextExpansionQueryBuilder to a token query on the coordinating node
    before the shard fan-out, so inference never runs per shard or per
    segment. Unknown model ids surface as 404 here, before any shard work.
    """
    def walk(node, out):
        if isinstance(node, dict):
            for key, value in node.items():
                if key == "text_expansion" and isinstance(value, dict):
                    for _field, opts in value.items():
                        if isinstance(opts, dict) and \
                                opts.get("tokens") is None and \
                                opts.get("model_text") is not None:
                            out.append(opts)
                else:
                    walk(value, out)
        elif isinstance(node, list):
            for item in node:
                walk(item, out)

    query = body.get("query")
    if query is None:
        return body
    probe: list = []
    walk(query, probe)          # cheap detection pass on the original
    if not probe:
        return body
    import copy
    body = copy.deepcopy(body)  # don't mutate the caller's request
    sites: list = []
    walk(body["query"], sites)
    by_model: Dict[Optional[str], list] = {}
    for opts in sites:
        by_model.setdefault(opts.get("model_id"), []).append(opts)
    for model_id, group in by_model.items():
        expansions = get_model(model_id, device).expand_batch(
            [str(o["model_text"]) for o in group])
        for opts, tokens in zip(group, expansions):
            opts["tokens"] = tokens
            opts.pop("model_text", None)
            opts.pop("model_id", None)
    return body


_models: Dict[Tuple[str, str], TextExpansionModel] = {}
_lock = threading.Lock()


def register_model(model: TextExpansionModel) -> None:
    """Deploy a model (PUT _ml/trained_models + deploy analog) on its
    device."""
    with _lock:
        _models[(model.model_id, str(model.device))] = model


def get_model(model_id: Optional[str] = None,
              device: DeviceLike = None) -> TextExpansionModel:
    """Resolve a model deployed on ``device``. Only the built-in default
    auto-deploys; an unknown id is a 404, NOT a fresh random model —
    silently serving untrained weights for a typo'd id would return
    garbage scores and leak unaccounted device memory per distinct id."""
    mid = model_id or DEFAULT_MODEL_ID
    dev = resolve_device(device)
    with _lock:
        model = _models.get((mid, str(dev)))
        if model is None:
            if mid != DEFAULT_MODEL_ID:
                from elasticsearch_tpu_torch.utils.errors import (
                    ResourceNotFoundError,
                )
                raise ResourceNotFoundError(
                    f"trained model [{mid}] is not deployed")
            model = _models[(mid, str(dev))] = TextExpansionModel(
                model_id=mid, device=dev)
        return model
