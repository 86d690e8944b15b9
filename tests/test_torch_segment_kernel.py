"""The segment gates' kernel (``ops/segmentation.py`` ``segment_objects``,
kernel ``csrc/segment_objects.cu`` ``ddlo_segment_objects``) and its plain
version ``segment_objects_plain``, without JAX.

On the CPU: a numpy f32 loop in the documented order of the residual sum
(pixel p in lane p mod ``SUM_LANES``, each lane ascending from +0, then
the halving tree over the lanes, then one f32 division) gives the plain
version's slot means bit for bit, so the plain version cannot drift from
the order the kernel follows. On the card (``gpu`` marker) the kernel is
held to the plain version bit for bit on every output, as ``chip_smoke.py``
phase 3 does, with one launch a call and the same ``seg_roots``.
"""

import numpy as np
import pytest
import torch

import torch_segment_cases
from dynamic_direct_lidar_odometry_tpu_torch.ops import nn_cuda, segmentation
from dynamic_direct_lidar_odometry_tpu_torch.utils import profiling


def _documented_mean(labels, res, root):
    """The mean positive residual of ``root``'s pixels in the written order."""
    L = segmentation.SUM_LANES
    lab, v = labels.reshape(-1), res.reshape(-1)
    lanes = np.zeros(L, np.float32)
    cnt = 0
    for p in np.flatnonzero((lab == root) & (v > 0)):  # ascending
        lanes[p % L] = np.float32(lanes[p % L] + v[p])
        cnt += 1
    while lanes.size > 1:
        h = lanes.size // 2
        lanes = (lanes[:h] + lanes[h:]).astype(np.float32)
    return np.float32(lanes[0] / np.float32(cnt)) if cnt else np.float32(0.0)


@pytest.mark.parametrize("case", torch_segment_cases.CASES)
def test_plain_residual_means_follow_the_written_order(case):
    labels, ranges, pts, res, h, kw = torch_segment_cases.case(case)
    roots, valid, _, avg = segmentation.segment_objects_plain(
        *(torch.from_numpy(np.asarray(x)) for x in (labels, ranges, pts, res, h)), **kw)
    want = [_documented_mean(labels, res, r) for r in roots[valid].tolist()]
    np.testing.assert_array_equal(avg[valid].numpy().view(np.int32), np.array(want, np.float32).view(np.int32))
    assert (avg[~valid] == 0).all() and (roots[~valid] == -1).all()


def test_plain_residual_mean_is_not_the_pixel_order_sum():
    """One component whose residuals round differently summed in pixel
    order and in the written order: the plain version gives the written
    order's mean (so the test above can tell the two orders apart)."""
    H, W = 4, 1024
    labels = np.zeros((H, W), np.int32)  # one component, root 0
    ranges = np.full((H, W), 5.0, np.float32)
    pts = np.stack([ranges, np.zeros_like(ranges),
                    np.linspace(2.0, 0.0, H)[:, None].repeat(W, 1).astype(np.float32)], axis=-1)
    res = np.zeros((H, W), np.float32)
    res[0, 0], res[2, 0] = 1.0, 2.0 ** -24  # p = 0 and 2048: one lane
    res[0, 1], res[1, 1] = 2.0 ** -24, 2.0 ** -24  # p = 1 and 1025: lanes 1 and 1025
    roots, valid, _, avg = segmentation.segment_objects_plain(
        *(torch.from_numpy(np.asarray(x)) for x in (labels, ranges, pts, res, np.float32(0.0))),
        **torch_segment_cases.KW)
    assert roots[0] == 0 and valid[0]
    seq = np.float32(0.0)
    for x in res.reshape(-1)[res.reshape(-1) > 0]:
        seq = np.float32(seq + x)
    assert avg[0].item() == _documented_mean(labels, res, 0) == np.float32(1.0 + 2.0 ** -23) / 4
    assert avg[0].item() != seq / 4


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    """The kernel against its plain version on the card, every output of
    every case bit-equal (the means as bits); one launch a call; the same
    ``seg_roots``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the H100")
    dev = torch.device("cuda")
    for case in torch_segment_cases.CASES:
        labels, ranges, pts, res, h, kw = torch_segment_cases.case(case)
        args = [torch.from_numpy(np.asarray(x)).to(dev) for x in (labels, ranges, pts, res, h)]
        nn_cuda.LAUNCHES.clear()
        with profiling.device_counts(dev) as got_counts:
            got = segmentation.segment_objects(*args, **kw)
        assert nn_cuda.LAUNCHES["segment_objects"] == 1, case
        with profiling.device_counts(dev) as plain_counts:
            plain = segmentation.segment_objects_plain(*args, **kw)
        for a, b in zip(got, plain):
            a, b = a.cpu().numpy(), b.cpu().numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, case
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), case
        roots = torch_segment_cases.qualifying_roots(labels, kw)
        assert got_counts.get("seg_roots", 0) == plain_counts.get("seg_roots", 0) == roots, case
