"""Build and load the port's CUDA sources (``csrc/``) with ``nvcc``.

Each library is compiled at first use from the package's own sources
into ``build/ddlo_torch_kernels/`` at the repository root, named by a
hash of its sources and flags, and loaded with ``ctypes`` through a
plain C interface. A missing ``nvcc`` or a failed build raises: there
is no fallback.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Mapping, NamedTuple, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ddlo_torch_kernels"

# --fmad=false: no FMA contraction, so kernel arithmetic rounds exactly
# like the plain PyTorch versions it is checked against.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    seconds: float  # compile time, 0.0 when the library was already built
    log: str  # nvcc's output (ptxas register / shared-memory report)


_LOADED: Dict[str, Built] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def load(name: str, sources: Sequence[str]) -> Built:
    """Compile (if needed) and load ``csrc/<sources>`` as one library."""
    if name in _LOADED:
        return _LOADED[name]
    paths = [CSRC / s for s in sources]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        h.update(p.read_bytes())
    out = BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{' '.join(cmd)}\n{log}")
        os.replace(tmp, out)
    built = Built(ctypes.CDLL(str(out)), out, seconds, log)
    _LOADED[name] = built
    return built


def load_all(libs: Mapping[str, Sequence[str]]) -> Dict[str, Built]:
    """:func:`load` every ``name -> sources`` entry, one ``nvcc`` per
    library, all started together."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(len(libs), 1)) as ex:
        futures = {name: ex.submit(load, name, srcs) for name, srcs in libs.items()}
        return {name: f.result() for name, f in futures.items()}
