"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

The sources have a plain C interface. Each ``.cu`` is compiled by its own
``nvcc`` process, all started together, and the objects are linked into one
shared library, loaded with :mod:`ctypes`. The build happens at first use,
in ``src/repro_torch/_build/`` (listed in ``.gitignore``), keyed on the
content hash of the sources, the headers they share and the flags, so a
fresh checkout builds them by itself and an unchanged tree reuses the
library. Nothing here runs at import time: the CPU tests import every module
and have no ``nvcc``.
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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: sm_90a keeps wgmma/setmaxnreg available to later kernels; -Xptxas=-v
#: reports registers, shared memory and spills into the build log.
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int

#: C signatures of the entry points (every pointer and the stream are
#: c_void_p so ctypes never truncates them to 32 bits).
_SIGNATURES = {
    "sk_dp_gemm": [_I, _I, _I, _I, _P, _P, _P, *[_I] * 11, _P, _P, _P, _P, _I, _I, _P],
    "sk_streamk_phase1": [_I, _I, _I, _I, *[_P] * 5, *[_I] * 13, _P, _P, _P, _P, _I, _I, _P],
    "sk_grouped_gemm": [*[_I] * 5, *[_P] * 6, *[_I] * 12, _P, _P, _P, _P, _I, _I, _P],
    "sk_splitk_partials": [_I, _I, _I, _P, _P, _P, *[_I] * 12, _P],
}

_lib: Optional[ctypes.CDLL] = None
#: what the last build or load did: library path, seconds (and each
#: source's nvcc seconds when it built), the ptxas report
build_info: Dict[str, object] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the Hopper "
            "kernels are built from csrc/ at first use"
        )
    return found


def _digest(sources) -> str:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(sources, so: Path, log: Path) -> Dict[str, float]:
    """One nvcc per source, all at once, then one link into ``so``. Returns
    each source's compile seconds."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    done: Dict[int, tuple] = {}

    def run(i, cmd):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        done[i] = (cmd, proc, time.perf_counter() - t0)

    threads = [
        threading.Thread(target=run, args=(i, [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(src)]))
        for i, (src, o) in enumerate(zip(sources, objs))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    reports = []
    failed = None
    for i in range(len(sources)):
        cmd, proc, _ = done[i]
        reports.append(proc.stderr)
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
    tmp = so.with_name(f"{tag}.tmp")
    try:
        if failed is not None:
            raise RuntimeError(failed)
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
               *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stderr}")
        log.write_text("".join(reports))
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return {src.name: done[i][2] for i, src in enumerate(sources)}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this tree has not built it."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    so = BUILD_DIR / f"libstream_k_{_digest(sources + sorted(CSRC.glob('*.cuh')))}.so"
    log = so.with_suffix(".ptxas.txt")
    t0 = time.perf_counter()
    built = not so.exists()
    source_seconds = _compile(sources, so, log) if built else {}
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_info.update(
        path=str(so),
        built=built,
        seconds=time.perf_counter() - t0,
        source_seconds=source_seconds,
        ptxas=log.read_text() if log.exists() else "",
    )
    _lib = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error (its cudaGetLastError())."""
    if status != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {status}")
