"""Full DDLO (dynamic detection on) on the accelerator paths, 3 scans:
the port forced onto them on CPU tensors (the kernels' plain versions
run), the JAX package with its backend patched to "tpu" (Pallas
interpreted); once with the default backends (sparse 1-NN, window
covariances) and once with DDLO_NN_IMPL=pallas + DDLO_KNN_IMPL=pallas
(dense 1-NN, lane-class k-NN). Bars as in tests/test_torch_pipeline_dynamic.py.
"""

import dataclasses

import pytest

from torch_parity import (
    assert_ddlo_parity, jax_tpu_paths, port_accelerator_paths, render_seq, run_jax_ddlo,
    run_port_ddlo, small_cfg,
)


def _accelerator_cfg(dense: bool):
    """small_cfg at half the scan width, with capacities no other test
    uses, one set per backend: the JAX traces read the backend
    environment when they are built and jit caches them by shape, inner
    functions included."""
    cfg = small_cfg()
    m = 1800 if dense else 2000
    cap = dataclasses.replace(
        cfg.capacity, max_points=m, max_keyframe_points=m, max_submap_points=4 * m
    )
    det = dataclasses.replace(cfg.detection, columns=256)
    return dataclasses.replace(cfg, capacity=cap, detection=det)


@pytest.mark.parametrize("dense", [False, True], ids=["default_backends", "dense_backends"])
def test_ddlo_accelerator_paths_match_jax(dense, monkeypatch):
    cfg = _accelerator_cfg(dense)
    if dense:
        monkeypatch.setenv("DDLO_NN_IMPL", "pallas")
        monkeypatch.setenv("DDLO_KNN_IMPL", "pallas")
    _, _, scans = render_seq(cfg, 4)
    with jax_tpu_paths():
        j_states, j_outs = run_jax_ddlo(cfg, scans)
    with port_accelerator_paths():
        p_states, p_outs = run_port_ddlo(cfg, scans)
    for js, jo, ps, po in zip(j_states, j_outs, p_states, p_outs):
        assert_ddlo_parity(jo, po, js, ps)
    assert sum(int(o.detections.objects.valid.sum()) for o in j_outs) > 5
