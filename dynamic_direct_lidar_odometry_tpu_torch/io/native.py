"""ctypes bindings for the native scan-IO runtime (the port's copy of
the JAX package's ``io/native.py``; no JAX).

The repo's C++ library (``native/scanio``) decodes PCD sequences and
prefetches ahead of the consumer on a background thread, the runtime-side
counterpart of the reference's ROS deserialization + AsyncSpinner feed
(odom.cc:624, odom_node.cc:43), so the card never waits on host decode.

Builds on demand with the library's own ``make`` rule, into
``native/scanio/build_torch`` (the JAX package builds beside the source:
two packages building at once never share an output file). Without a
toolchain ``available()`` is False. :func:`io.pcd.save_pcd` does not go
through this module: its numpy writer gives the same bytes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "scanio",
)
_BUILD_DIR = os.path.join(_NATIVE_DIR, "build_torch")
# DDLO_SCANIO_LIB overrides for installed deployments (the repo-relative
# path only exists for source checkouts)
_SO_PATH = os.environ.get(
    "DDLO_SCANIO_LIB", os.path.join(_BUILD_DIR, "libscanio.so")
)

_lib: Optional[ctypes.CDLL] = None


def _build() -> bool:
    # the Makefile's own compiler and flags: a CXX from the environment
    # (a toolchain whose C++ runtime is not the one PyTorch loads) builds
    # a library that crashes in this process
    env = {k: v for k, v in os.environ.items()
           if k not in ("CXX", "CXXFLAGS", "CPPFLAGS", "LDFLAGS", "LDLIBS")}
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run(
            ["make", "-s", "-f", os.path.join(_NATIVE_DIR, "Makefile"),
             f"--eval=vpath %.cpp {_NATIVE_DIR}", "libscanio.so"],
            cwd=_BUILD_DIR,
            env=env,
            check=True,
            capture_output=True,
        )
        return True
    except (subprocess.CalledProcessError, FileNotFoundError, OSError):
        return False


def load_library(rebuild: bool = False) -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native library; None if impossible."""
    global _lib
    if _lib is not None and not rebuild:
        return _lib
    if rebuild or not os.path.exists(_SO_PATH):
        if not _build():
            return None
    lib = ctypes.CDLL(_SO_PATH)
    lib.ddlo_seq_open.restype = ctypes.c_void_p
    lib.ddlo_seq_open.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.ddlo_seq_len.restype = ctypes.c_int
    lib.ddlo_seq_len.argtypes = [ctypes.c_void_p]
    lib.ddlo_seq_next.restype = ctypes.c_int
    lib.ddlo_seq_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.ddlo_seq_close.argtypes = [ctypes.c_void_p]
    lib.ddlo_load_pcd.restype = ctypes.c_int
    lib.ddlo_load_pcd.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.ddlo_save_pcd.restype = ctypes.c_int
    lib.ddlo_save_pcd.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return load_library() is not None


def load_pcd_native(path: str, capacity: int) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot native PCD load into a fixed-capacity organized buffer."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native scanio unavailable (no toolchain?)")
    xyz = np.zeros((capacity, 3), np.float32)
    mask = np.zeros((capacity,), np.uint8)
    n = lib.ddlo_load_pcd(
        path.encode(),
        capacity,
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if n < 0:
        raise IOError(f"failed to parse {path}")
    return xyz, mask.astype(bool)


def save_pcd_native(
    path: str, points: np.ndarray, mask: Optional[np.ndarray] = None
) -> int:
    """Binary xyz PCD write through the C++ runtime (the reference's
    pcl::io::savePCDFileBinary, map.cc:177). Returns points written."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native scanio unavailable (no toolchain?)")
    pts = np.ascontiguousarray(np.asarray(points, np.float32).reshape(-1, 3))
    n = len(pts)
    if mask is None:
        m = np.ones((n,), np.uint8)
    else:
        m = np.ascontiguousarray(np.asarray(mask, bool).reshape(-1)).astype(
            np.uint8
        )
    wrote = lib.ddlo_save_pcd(
        path.encode(),
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n,
    )
    if wrote < 0:
        raise IOError(f"failed to write {path}")
    return wrote


class PrefetchingReader:
    """Iterate a list of PCD files with background native prefetch.

    Yields (points (cap, 3) float32, mask (cap,) bool, stamp) — ready to
    ship straight to the device while the next file decodes on a C++
    thread.
    """

    def __init__(
        self,
        paths: Sequence[str],
        capacity: int,
        stamps: Optional[Sequence[float]] = None,
        prefetch: int = 4,
    ):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native scanio unavailable (no toolchain?)")
        self._lib = lib
        self._cap = capacity
        joined = "\n".join(paths).encode()
        st = None
        if stamps is not None:
            arr = np.asarray(stamps, np.float64)
            st = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
            self._stamps_keepalive = arr
        self._h = lib.ddlo_seq_open(
            joined, st, len(paths), capacity, prefetch
        )
        if not self._h:
            raise IOError("ddlo_seq_open failed")

    def __len__(self) -> int:
        return self._lib.ddlo_seq_len(self._h)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
        while True:
            xyz = np.zeros((self._cap, 3), np.float32)
            mask = np.zeros((self._cap,), np.uint8)
            stamp = ctypes.c_double()
            ok = self._lib.ddlo_seq_next(
                self._h,
                xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.byref(stamp),
            )
            if not ok:
                return
            yield xyz, mask.astype(bool), float(stamp.value)

    def close(self) -> None:
        if self._h:
            self._lib.ddlo_seq_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
