"""The port's one dispatch rule.

The JAX package branches on ``jax.default_backend() == "tpu"`` to pick
its accelerator paths (Pallas sweeps, Morton-window covariances, the 3x
residual clamp). The port makes the same choice from where the tensors
live: CUDA tensors take the accelerator paths, CPU tensors take exactly
the JAX CPU paths. Callers use ``device.on_accelerator(t)`` through the
module so a test can force the accelerator branch on CPU tensors (the
kernels' plain versions then run).
"""

from __future__ import annotations

import torch


def on_accelerator(t: torch.Tensor) -> bool:
    return t.is_cuda


def resolve(device="cuda") -> torch.device:
    """The device an entry point builds its state on: the card unless the
    caller asks for another. Asking for the card on a host without one
    raises; nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; "
            "pass device='cpu' to run on the host"
        )
    return dev
