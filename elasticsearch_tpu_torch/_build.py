"""Build and load the CUDA kernels under ``csrc/``.

Each ``csrc/*.cu`` file is one kernel family with a plain C interface. On
first use every source is compiled by its own ``nvcc`` process, all
started together, into a shared library for ``sm_90a`` (Hopper); the
libraries are loaded with ``ctypes``. Nothing links against PyTorch, so a
build takes seconds.

The output goes to ``_kernels/<hash>/`` beside this file (``.gitignore``
lists it), or to ``$ES_TORCH_KERNEL_DIR`` when set; the hash covers the
sources and the flags, so an edit rebuilds and an unchanged tree reuses
the libraries. A failed build or load raises :class:`KernelBuildError`:
there is no fallback to the plain versions for tensors on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).with_name("csrc")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# what the last build did: {"seconds": float, "built": bool, "dir": str,
# "ptxas": {family: ptxas -v report}} — chip_smoke.py prints it
BUILD_INFO: Dict[str, object] = {}


class KernelError(RuntimeError):
    """A kernel failed to build, load or launch: a fault of the card or its
    toolchain, which no caller turns into a fallback."""


class KernelBuildError(KernelError):
    """nvcc is missing, a source failed to compile, or a library failed to
    load."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built")


def sources() -> Dict[str, Path]:
    """family name -> its .cu source."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    base = os.environ.get("ES_TORCH_KERNEL_DIR")
    root = Path(base) if base else Path(__file__).with_name("_kernels")
    return root / _digest()


def build_all() -> Dict[str, Path]:
    """Compile every family that is not built yet (in parallel) and return
    family -> library path. Raises KernelBuildError on any failure."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = sources()
    libs = {name: out_dir / f"lib{name}.so" for name in srcs}
    todo = [name for name, lib in libs.items() if not lib.exists()]
    t0 = time.monotonic()
    ptxas: Dict[str, str] = {}
    if todo:
        nvcc = _nvcc()
        procs = {}
        for name in todo:
            tmp = out_dir / f".lib{name}.{os.getpid()}.so"
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(srcs[name])]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            report, _ = proc.communicate()
            ptxas[name] = report
            if proc.returncode != 0:
                failed.append(f"{name}:\n{report}")
                tmp.unlink(missing_ok=True)
                continue
            os.replace(tmp, libs[name])
        if failed:
            raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    BUILD_INFO.update({"seconds": time.monotonic() - t0, "built": bool(todo),
                       "dir": str(out_dir), "ptxas": ptxas})
    return libs


def library(family: str) -> ctypes.CDLL:
    """The loaded library of one kernel family (built on first use)."""
    lib: Optional[ctypes.CDLL] = _libs.get(family)
    if lib is not None:
        return lib
    with _lock:
        if family not in _libs:
            paths = build_all()
            if family not in paths:
                raise KernelBuildError(f"no source for kernel [{family}]")
            for name, path in paths.items():
                if name not in _libs:
                    try:
                        _libs[name] = ctypes.CDLL(str(path))
                    except OSError as e:
                        raise KernelBuildError(
                            f"cannot load {path}: {e}") from e
        return _libs[family]
