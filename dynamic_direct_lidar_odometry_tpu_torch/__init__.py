"""PyTorch + CUDA port of the DDLO framework, for NVIDIA Hopper (H100).

The JAX package ``dynamic_direct_lidar_odometry_tpu`` is the reference;
this package mirrors its layout (``core/``, ``ops/``, ``odometry/``,
``detection/``, ``tracking/``, ``io/``, ``pipeline.py``) module by module
so each counterpart is easy to find, and is held against it by the
``tests/test_torch_*.py`` parity tests.

- Plain functions on tensors; state is ``NamedTuple``s of tensors whose
  field names match the JAX package's. The system has no learned
  parameters, so there is no ``nn.Module``.
- The device is explicit (``init_state(..., device=)``); there is no
  global default device.
- Every Pallas kernel of the JAX package is a hand-written CUDA kernel
  under ``csrc/`` (see ``ops/nn_cuda.py``). On CPU tensors the port takes
  the JAX CPU paths; on CUDA tensors it takes the JAX TPU paths.
- Nothing here imports jax or the JAX package: ``config``, ``io.dataset``
  and ``io.synthetic`` are the port's own copies.

Ported: the full pipeline (plain DLO and dynamic detection + tracking);
see ROADMAP.md for what remains.
"""

import torch

# No TF32 anywhere: pose composes, covariance products and the GICP
# normal equations need full f32, the counterpart of the JAX package's
# Precision.HIGHEST pins (ROADMAP.md "Numerics to carry over").
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
