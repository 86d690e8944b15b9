"""The host hull oracle (``keyframes.exact_hull_masks``, scipy) of the
port against the JAX package's, and the port's blocked device hulls
against it at K = 128."""

import numpy as np
import pytest
import torch

from test_approximations import random_trajectory_positions
from test_torch_hulls_blocked import SCENES
from torch_parity import n, t

from dynamic_direct_lidar_odometry_tpu.odometry import keyframes as jkf
from dynamic_direct_lidar_odometry_tpu_torch.odometry import keyframes as kf


@pytest.mark.parametrize("scene", ["k48_valid17", "k65_valid40", "traj128_valid100", "square_plus_centre",
                                   "collinear", "k48_valid3", "k48_valid4"])
def test_exact_hull_masks_match_jax(scene):
    pos, valid, alpha = SCENES[scene]
    for got, want in zip(kf.exact_hull_masks(pos, valid, alpha), jkf.exact_hull_masks(pos, valid, alpha)):
        np.testing.assert_array_equal(got, want)


def test_blocked_hulls_against_the_oracle_at_128():
    """Device hulls vs the scipy oracle at K = 128 (trajectories, as the
    JAX package's own bounds at K = 40): every oracle point found
    (recall 1.0), few extra (precision >= 0.99 over the scenes)."""
    tp = marked = truth = 0
    for seed in range(2):
        pos = random_trajectory_positions(128, 20 + seed)
        valid = np.ones(128, bool)
        cv, cc = kf.exact_hull_masks(pos, valid, 5.0)
        got_cv = n(kf.convex_hull_mask(t(pos), t(valid)))
        got_cc = n(kf.concave_hull_mask(t(pos), t(valid), torch.tensor(5.0)))
        for got, want in ((got_cv, cv), (got_cc, cc)):
            assert not (want & ~got).any()  # recall 1.0
            tp += int((got & want).sum())
            marked += int(got.sum())
            truth += int(want.sum())
    assert tp == truth
    assert tp / marked >= 0.99, tp / marked
