"""Write ``tests/golden/torch_align_batch_cpu.npz``: the port's
``gicp.align_batch`` on the CPU over the four cases of
tests/test_torch_parallel.py (``CASES``) and two more (:data:`EXTRA`:
the LM loops with ``record_trace``, and the card's path on the host: the
card's arithmetic ``gicp.TORCH`` and the batched sparse 1-NN's plain
version), inputs and every result field, ``pose_trace`` included.
tests/test_torch_batch_graph.py holds ``align_batch`` to it bit for bit.

    env JAX_PLATFORMS=cpu python tools/torch_align_batch_golden.py [--out FILE]

The inputs come from the cases' makers (the JAX package's covariances)
and are stored beside the results, so the test needs no JAX.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

OUT = os.path.join(ROOT, "tests", "golden", "torch_align_batch_cpu.npz")
# name -> (the CASES entry whose inputs it takes, settings, card path)
EXTRA = {
    "varied-lm-trace": ("varied", dict(max_iterations=16, record_trace=True), False),
    "varied-card-path": ("varied", dict(max_iterations=16, record_trace=True,
                                        nn_impl="sparse", max_correspondence_distance=2.0), True),
}


def card_path(on: bool):
    """The card's branches on CPU tensors: ``device.on_accelerator`` true
    (the kernels' plain versions run) and GICP's card arithmetic."""
    import contextlib

    from dynamic_direct_lidar_odometry_tpu_torch.core import device
    from dynamic_direct_lidar_odometry_tpu_torch.ops import gicp

    @contextlib.contextmanager
    def patched():
        saved = device.on_accelerator, gicp.arithmetic
        device.on_accelerator, gicp.arithmetic = (lambda t: True), (lambda dev: gicp.TORCH)
        try:
            yield
        finally:
            device.on_accelerator, gicp.arithmetic = saved

    return patched() if on else contextlib.nullcontext()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    from test_torch_parallel import CASES

    from dynamic_direct_lidar_odometry_tpu_torch.ops import gicp

    cases = {case: (case, kw, False) for case, (_, kw) in CASES.items()}
    cases.update(EXTRA)
    arrays, settings, inputs_of = {}, {}, {}
    for case, (src, kw, card) in cases.items():
        make = CASES[src][0]
        key = make.__name__ if make.__name__ != "<lambda>" else src
        if key not in inputs_of:
            ins = [np.array(a) for a in make()]
            for i, a in enumerate(ins):
                arrays[f"in/{key}/{i}"] = a
            inputs_of[key] = ins
        settings[case] = dict(inputs=key, settings=kw, card_path=card)
        with card_path(card):
            res = gicp.align_batch(*(torch.from_numpy(a) for a in inputs_of[key]),
                                   gicp.GICPSettings(**kw))
        for field in res._fields:
            arrays[f"out/{case}/{field}"] = getattr(res, field).numpy()
    arrays["cases"] = np.array(json.dumps(settings))
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {args.out}: {', '.join(cases)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
