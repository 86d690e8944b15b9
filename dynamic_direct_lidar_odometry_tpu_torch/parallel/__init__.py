"""Batched streams (counterpart of the JAX package's ``parallel/``): a
leading batch axis on the states in place of a ``dp`` mesh axis."""

from dynamic_direct_lidar_odometry_tpu_torch.parallel import sharding  # noqa: F401
