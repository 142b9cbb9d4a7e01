"""How far the two packages' IVF builds diverge at k-means near-ties.

Not a test (pytest does not collect it): a measurement that builds the
JAX package's ``IVFIndex`` and the PyTorch build's (its plain versions,
on the CPU) over the same Gaussian GIST-shaped corpus -- bench.py
cfg_ivf's envelope: 1,024 means, rows = a mean + 0.35 noise, queries = a
row + 0.05 noise -- and prints the share of rows whose list differs, the
largest centroid difference, and recall@10 against a float64 oracle for
both, with the share of queries whose top-10 differs, at several nprobe.

    JAX_PLATFORMS=cpu python tests/measure_ivf_divergence.py [n [dims]]

(65,536 x 960 by default: about three minutes and 4 GB on a CPU.)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from elasticsearch_tpu.ops import ivf as ref_ivf  # noqa: E402
from elasticsearch_tpu_torch.ops import ivf as port_ivf  # noqa: E402


def row_lists(ids, n):
    """Row index -> the list it was packed into."""
    ids = np.asarray(ids)
    out = np.full(n, -1, np.int64)
    lists, slots = np.nonzero(ids >= 0)
    out[ids[lists, slots]] = lists
    return out


def main(n=65_536, dims=960, n_q=128):
    rng = np.random.default_rng(20261017)
    means = rng.standard_normal((1024, dims), dtype=np.float32)
    x = means[rng.integers(0, 1024, n)] + \
        0.35 * rng.standard_normal((n, dims), dtype=np.float32)
    q = x[rng.integers(0, n, n_q)] + \
        0.05 * rng.standard_normal((n_q, dims), dtype=np.float32)
    ref = ref_ivf.IVFIndex.build(x, similarity="cosine")
    port = port_ivf.IVFIndex.build(x, similarity="cosine", device="cpu")
    rc = np.asarray(ref.centroids)
    pc = port.centroids.cpu().numpy()
    moved = row_lists(ref.ids, n) != row_lists(port.ids.cpu().numpy(), n)
    print(f"n {n} dims {dims} nlist {ref.nlist}: centroids bitwise equal "
          f"{np.array_equal(rc.view(np.uint32), pc.view(np.uint32))}, "
          f"max |diff| {float(np.abs(rc - pc).max())}; rows in another "
          f"list {int(moved.sum())} of {n} ({moved.mean():.6f})")
    xn = x.astype(np.float64)
    xn /= np.linalg.norm(xn, axis=1, keepdims=True)
    qn = q.astype(np.float64)
    qn /= np.linalg.norm(qn, axis=1, keepdims=True)
    oracle = np.argsort(-(qn @ xn.T), axis=1, kind="stable")[:, :10]
    for nprobe in (16, 32, 64, 128):
        ref_ids = np.asarray(ref.search(q, 10, nprobe)[1])
        port_ids = np.asarray(port.search(q, 10, nprobe)[1])
        recall = [np.mean([len(set(ids[i]) & set(oracle[i])) / 10
                           for i in range(n_q)])
                  for ids in (ref_ids, port_ids)]
        differ = np.mean([set(ref_ids[i]) != set(port_ids[i])
                          for i in range(n_q)])
        print(f"nprobe {nprobe}: recall@10 JAX {recall[0]:.4f} port "
              f"{recall[1]:.4f}; queries whose top-10 differs {differ:.4f}")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
