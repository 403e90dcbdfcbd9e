"""Build and load the hand-written CUDA kernels of ``repro_torch/csrc``.

The sources are compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, at first use, into
``build/torch_kernels/`` at the root of the checkout (``.gitignore``
lists ``build/``).  Each ``.cu`` becomes an object in its own ``nvcc``
process, all started together, then one link.  The library is loaded
with ``ctypes``; nothing here includes PyTorch's headers, which keeps the
build at seconds.  It is rebuilt when a source is newer than it.

``launches`` counts, per kernel, the launches its wrapper made; the
wrappers add one where they launch and nowhere else.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
LIB_PATH = BUILD_DIR / "librepro_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launches = {"dominance": 0, "dcim_mvm": 0, "fp_prealign": 0,
            "paged_decode_gqa": 0, "prefix_prefill": 0, "paged_decode_mla": 0,
            "selective_scan": 0}

_p = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
_SIGNATURES = {
    # name: argtypes (every pointer and the stream as c_void_p)
    "dominance_launch": (_p, _p, _p, _i, _i, _i, _i, _p),
    "dcim_mvm_launch": (_p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _p),
    "fp_prealign_launch": (_p, _p, _p, ctypes.c_longlong, _i, _i, _i, _p),
    "paged_decode_gqa_launch": (_p,) * 6 + (_i,) * 8 + (_f, _i, _i, _i, _p),
    "prefix_prefill_launch": (_p,) * 7 + (_i,) * 8 + (_f, _i, _i, _i, _p),
    "paged_decode_mla_launch": (_p,) * 7 + (_i,) * 7 + (_f, _i, _i, _i, _p),
    "selective_scan_launch": (_p,) * 9 + (_i,) * 5 + (_p,),
}

_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(src.stat().st_mtime > built for src in CSRC.iterdir())


def build(force: bool = False) -> float:
    """Compile the kernels if the library is missing or stale.  Returns
    the seconds spent (0.0 when nothing was built).  ``nvcc``'s output,
    ``-Xptxas -v`` register and shared-memory counts included, goes to
    ``build/torch_kernels/nvcc.log``."""
    if not (force or _stale()):
        return 0.0
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / (src.stem + ".o") for src in sources]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(sources, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    tmp = LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS[:2], "-shared", *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    (BUILD_DIR / "nvcc.log").write_text("\n".join(logs + [link.stdout]))
    failed = [s.name for s, p in zip(sources, procs) if p.returncode] + (
        ["link"] if link.returncode else []
    )
    if failed:
        raise RuntimeError(
            f"nvcc failed for {failed}:\n" + "\n".join(logs + [link.stdout])[-4000:]
        )
    os.replace(tmp, LIB_PATH)
    return time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        build()
        handle = ctypes.CDLL(str(LIB_PATH))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(status: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")
