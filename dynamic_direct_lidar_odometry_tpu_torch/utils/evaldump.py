"""(The port's copy of the JAX package's ``utils/evaldump.py``; numpy only.)

Reference-format evaluation dumps (detection.cpp:910-954).

The reference's evaluation mode (``odomNode/evaluation/evaluate``) writes
a timestamped output directory so offline tooling can diff runs:

  <evaluation_dir>/<YYYY_MM_DD-HH_MM_SS>/     (setupEvaluation, :911-934)
      cfg.yaml            copy of the loaded config      (:922-933)
      %04d.txt            per-frame DYNAMIC point indices, one per line,
                          4-digit zero-padded scan seq    (:938-949)
      poses.txt           appended per frame: stamp nsec, newline, the
                          4x4 pose streamed Eigen-style, then ";"  (:952)

This module reproduces those files byte-for-byte (including Eigen's
default ``operator<<`` matrix layout) so the reference's offline
evaluation scripts consume dumps from either implementation.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Optional, Sequence

import numpy as np


def eigen_matrix_str(M: np.ndarray) -> str:
    """A float matrix exactly as Eigen's default ``operator<<`` prints it.

    Eigen (IO.h, print_matrix with the default IOFormat) renders every
    entry with the stream's default float formatting (6 significant
    digits, ``%g``-style), computes the maximum entry width, and
    right-pads every entry to that width, separating columns by a single
    space and rows by a newline. No trailing newline.
    """
    M = np.asarray(M, dtype=np.float32)
    cells = [[_gfmt(v) for v in row] for row in M]
    width = max(len(c) for row in cells for c in row)
    return "\n".join(" ".join(c.rjust(width) for c in row) for row in cells)


def _gfmt(v: float) -> str:
    """C++ ostream default float formatting: %g with 6 significant
    digits (std::defaultfloat / precision 6)."""
    return "%g" % float(np.float32(v))


class EvalDump:
    """One evaluation session: timestamped dir + cfg copy + per-frame
    dumps, mirroring DetectionModule::setupEvaluation/evaluate."""

    def __init__(
        self,
        evaluation_dir: str,
        config_path: Optional[str] = None,
        timestamp: Optional[float] = None,
    ):
        t = time.localtime(timestamp if timestamp is not None else time.time())
        stamp = time.strftime("%Y_%m_%d-%H_%M_%S", t)
        self.output_dir = os.path.join(evaluation_dir, stamp)
        os.makedirs(self.output_dir, exist_ok=True)
        # cfg.yaml copy (detection.cpp:922-933); the reference copies the
        # file it loaded params from so the dump is self-describing
        if config_path and os.path.exists(config_path):
            shutil.copyfile(
                config_path, os.path.join(self.output_dir, "cfg.yaml")
            )

    def frame(
        self,
        seq: int,
        dynamic_indices: Sequence[int],
        stamp_sec: float,
        T: np.ndarray,
    ) -> None:
        """Per-frame dump: ``%04d.txt`` indices + poses.txt append
        (detection.cpp:936-952)."""
        idx_path = os.path.join(self.output_dir, "%04d.txt" % int(seq))
        # reference opens in append mode (:941) — replays that repeat a
        # seq accumulate, matching that behavior exactly
        with open(idx_path, "a") as f:
            for i in dynamic_indices:
                f.write("%d\n" % int(i))
        nsec = int(round(float(stamp_sec) * 1e9))
        with open(os.path.join(self.output_dir, "poses.txt"), "a") as f:
            f.write("%d\n%s;\n" % (nsec, eigen_matrix_str(T)))
