"""How much a background shard build slows the card phases beside it.

Not a test (pytest does not collect it): a measurement on a CUDA card.
It times three of ``chip_smoke.py``'s small phases (knn-small,
dense-small, ivf-small) with nothing beside them, then again and again
while a spawn pool builds MS MARCO segments' host postings the way the
start-up pool once did (``segment_tokens`` then the host
``postings_from_token_matrix``), with 4 workers and with 2, both at the
lowest CPU priority. Each line says when, after the pool started, the
phase ran: the first tens of seconds are the token drawing, the rest
the postings sorts. Prints the host's CPU and memory pressure between
rounds where the kernel exposes them.

    python3 tests/measure_build_pool.py

(About five minutes on an H100 machine with 8 host cores.)
"""

import multiprocessing as mp
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

PHASES = (("knn-small", cs.phase_knn_small),
          ("dense-small", cs.phase_dense_small),
          ("ivf-small", cs.phase_ivf_small))


def host_build(args):
    """One segment's host postings, as the start-up pool built them."""
    import numpy as np
    from elasticsearch_tpu_torch.index.segment import (
        postings_from_token_matrix,
    )
    lens, toks = cs.segment_tokens(args)
    mat = np.full((len(lens), 96), -1, np.int32)
    mat[np.arange(96)[None, :] < lens[:, None]] = toks
    return postings_from_token_matrix(mat).block_docs.shape


def pressure() -> None:
    out = subprocess.run(
        "cat /proc/pressure/cpu /proc/pressure/memory /proc/loadavg",
        shell=True, capture_output=True, text=True).stdout.strip()
    print(out, flush=True)


def rounds(torch, np, dev, label: str, t0: float) -> None:
    for name, fn in PHASES:
        t = time.monotonic()
        fn(torch, np, dev)
        print(f"RESULT {label} {name} {time.monotonic() - t:.1f}s at "
              f"{t - t0:.0f}s", flush=True)
    pressure()


def main() -> int:
    import numpy as np
    import torch
    from elasticsearch_tpu_torch import _build
    if not torch.cuda.is_available():
        print("measure_build_pool: no CUDA device is visible",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    _build.build_all()
    rounds(torch, np, dev, "nopool", time.monotonic())
    jobs = cs.full_jobs(cs.MS_MARCO_DOCS)
    for workers in (4, 2):
        pool = mp.get_context("spawn").Pool(
            workers, initializer=cs._background_worker)
        t0 = time.monotonic()
        res = pool.map_async(host_build, jobs[:workers])
        time.sleep(20)
        while time.monotonic() - t0 < 170 and not res.ready():
            rounds(torch, np, dev, f"W{workers}", t0)
        print(f"W{workers} build ready {res.ready()} at "
              f"{time.monotonic() - t0:.0f}s", flush=True)
        pool.terminate()
        pool.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
