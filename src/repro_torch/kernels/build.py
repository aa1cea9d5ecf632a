"""Build the port's CUDA sources with ``nvcc`` at first use, and load them.

Every ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/kernels/lib<name>-<hash>.so`` under the repository root (a
git-ignored directory); the hash covers the source and the flags, so an
edited source is never served a stale library. :func:`build` starts one
``nvcc`` per source (four today: ``poibin_dft``, ``fedavg_agg``,
``flash_attention``, ``fused_ce``), all together, and waits for all of
them. :func:`load`
returns the ``ctypes`` handle, building first if needed.
Nothing here runs at import time: this module imports on a machine with no
``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "sources", "library_path",
           "build", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                           "the CUDA kernels cannot be built here")
    return nvcc


def build(names: list[str] | None = None) -> dict[str, float]:
    """Compile the named sources (default: all) that are not built yet.

    One ``nvcc`` per source, all started together. Returns
    ``{name: seconds}`` for the sources compiled by this call, each from
    the common start to the end of its own compiler; the compiler's
    register/shared-memory report (``-Xptxas -v``) is kept beside each
    library as ``<lib>.log``. Raises with the compiler's output if any
    build fails (after every compiler has ended).
    """
    names = sources() if names is None else names
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")   # no half-written .so
        log = out.with_suffix(".so.log")
        with open(log, "w") as sink:
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=sink, stderr=subprocess.STDOUT)
        jobs[name] = (proc, tmp, out, log)
    seconds: dict[str, float] = {}
    while len(seconds) < len(jobs):
        for name, (proc, *_rest) in jobs.items():
            if name not in seconds and proc.poll() is not None:
                seconds[name] = time.perf_counter() - t0
        time.sleep(0.02)
    failed = []
    for name, (proc, tmp, out, log) in jobs.items():
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"kernel build failed: {name} (nvcc exit "
                          f"{proc.returncode})\n{log.read_text()}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
