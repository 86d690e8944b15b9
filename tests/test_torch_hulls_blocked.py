"""The blocked (K > 64) exact hulls (odometry/keyframes.py) against the
JAX package: every mask EQUAL (the host oracle: test_torch_hulls_oracle.py).

The blocked forms differ from the dense ones in arithmetic (unit facet
normals and an absolute plane tolerance; circumcenter emptiness), so
they are held against JAX's ``_convex_hull_mask_blocked`` /
``_concave_hull_mask_blocked``, which ``tests/test_approximations.py``
holds equal to the dense forms. The scenes are seeded point sets in
general position: no decision lies within rounding of a tolerance, so
XLA's and PyTorch's different f32 roundings cannot flip a bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_approximations import random_trajectory_positions
from torch_parity import n, t

from dynamic_direct_lidar_odometry_tpu.odometry import keyframes as jkf
from dynamic_direct_lidar_odometry_tpu_torch.odometry import keyframes as kf

_jax_convex = jax.jit(jkf._convex_hull_mask_blocked)
_jax_concave = jax.jit(jkf._concave_hull_mask_blocked)


def _uniform(K, nv, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-20, 20, (K, 3)).astype(np.float32)
    return pos, np.arange(K) < nv, float(rng.uniform(3, 12))


def _scenes():
    out = {}
    # K = 48: valid counts across every early return (0, 3, 4, 5) to full
    for nv in (0, 1, 3, 4, 5, 17, 48):
        out[f"k48_valid{nv}"] = _uniform(48, nv, 100 + nv)
    sq = np.array([[0, 0, 0], [4, 0, 0], [4, 4, 0], [0, 4, 0], [2, 2, 0]], np.float32)
    out["square_plus_centre"] = (sq, np.ones(5, bool), 3.0)
    line = np.stack([np.arange(6), np.zeros(6), np.zeros(6)], 1).astype(np.float32)
    out["collinear"] = (line, np.ones(6, bool), 3.0)
    # K = 65 and 128: the sizes that dispatch to the blocked form
    out["k65_valid40"] = _uniform(65, 40, 1)
    out["traj128_valid100"] = (random_trajectory_positions(128, 4), np.arange(128) < 100, 5.0)
    return out


SCENES = _scenes()


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_blocked_hull_masks_match_jax(scene):
    pos, valid, alpha = SCENES[scene]
    jcv = np.asarray(_jax_convex(jnp.asarray(pos), jnp.asarray(valid)))
    jcc = np.asarray(_jax_concave(jnp.asarray(pos), jnp.asarray(valid), jnp.float32(alpha)))
    al = torch.tensor(alpha, dtype=torch.float32)
    if len(pos) <= 64:  # direct calls: the entry points would take the dense form
        np.testing.assert_array_equal(n(kf._convex_hull_mask_blocked(t(pos), t(valid))), jcv)
        np.testing.assert_array_equal(n(kf._concave_hull_mask_blocked(t(pos), t(valid), al)), jcc)
        return
    before = dict(kf.BLOCKED_CALLS)
    np.testing.assert_array_equal(n(kf.convex_hull_mask(t(pos), t(valid))), jcv)
    np.testing.assert_array_equal(n(kf.concave_hull_mask(t(pos), t(valid), al)), jcc)
    assert kf.BLOCKED_CALLS == {k: v + 1 for k, v in before.items()}


def test_collinear_blocked_convex_is_all_valid():
    pos, valid, _ = SCENES["collinear"]
    assert n(kf._convex_hull_mask_blocked(t(pos), t(valid))).all()


@pytest.mark.parametrize("K", [16, 64])
def test_dense_path_below_65(K):
    pos, valid, alpha = _uniform(K, K, 7)
    before = dict(kf.BLOCKED_CALLS)
    kf.convex_hull_mask(t(pos), t(valid))
    kf.concave_hull_mask(t(pos), t(valid), torch.tensor(alpha))
    assert kf.BLOCKED_CALLS == before
