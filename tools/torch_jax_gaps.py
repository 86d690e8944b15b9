"""The port's distance from the JAX package on the CPU, on the parity tests'
scenes: one JSON line with

- ``kantplatz_lockstep_m``: tests/test_torch_kantplatz.py's scene
  (``small_kantplatz()``, 3 steps), one port step from JAX's state per
  scan, max |translation difference| per scan;
- ``kantplatz_chained_m``: the port's own run of the same 3 scans;
- ``step_chunk_m``: tests/test_torch_step_chunk.py's K = 3 chunk against
  JAX's ``step_chunk``, max over the chunk;
- ``replay_batch_m``: tests/test_torch_parallel.py's 4 x 3
  ``replay_batch`` against JAX's, max over poses;
- ``*_bits_equal``: whether the poses are bit-equal.

    env JAX_PLATFORMS=cpu python tools/torch_jax_gaps.py

``--h N``: instead, GICP's H at N points (tests/test_torch_gicp_bits.py's
inputs, seeds 0 and 1): JAX's jitted ``_linearize`` on every core and
under ``taskset -c 0``, and the port's, as entries that differ and the
largest difference in ulp of the row's largest entry.

``--probe K``: how XLA's CPU dot groups the K rows of ``A^T B`` (H's
Eigen contraction): with ``A`` all ones and ``B`` ones but +2^40 at row 0
and -2^40 at row k, every one summed into a partial that holds a big
value is lost, so ``K - 2 - H`` counts them and marks where the partial
that starts at row 0 ends. Prints (first k, end) for each run of k that
ends at the same row.

Run it in a checkout to measure that tree (it takes its scenes from that
checkout's ``tests/``).
"""

import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
# the tests' 8 virtual CPU devices (tests/conftest.py), before JAX starts
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def _t(T):
    return np.asarray(T)[..., :3, 3]


def kantplatz():
    from test_kantplatz import small_kantplatz
    from torch_parity import n, port_cfg

    from dynamic_direct_lidar_odometry_tpu import pipeline as jpipe
    from dynamic_direct_lidar_odometry_tpu.io import synthetic
    from dynamic_direct_lidar_odometry_tpu_torch import interop, pipeline

    cfg = small_kantplatz()
    H, W = cfg.detection.rows, cfg.detection.columns
    world = synthetic.World.town(seed=11, n_static=8)
    rng = np.random.default_rng(0)
    T = np.eye(4)
    scans = [synthetic.render_scan(world, T, H=H, W=W, t=0.0, rng=rng)]
    for i in range(1, 4):
        T[:3, 3] = [0.08 * i, 0.0, 0.0]
        scans.append(synthetic.render_scan(world, T, H=H, W=W, t=0.1 * i, rng=rng))
    st = jpipe.init_state(cfg, jnp.asarray(scans[0][0]), jnp.asarray(scans[0][1]), 0.0)
    before, outs = [], []
    for i in range(1, 4):
        before.append(jax.tree_util.tree_map(np.asarray, st))
        st, out = jpipe.step(cfg, st, jnp.asarray(scans[i][0]), jnp.asarray(scans[i][1]), jnp.float32(0.1 * i))
        outs.append(np.asarray(out.odom.T))
    pcfg = port_cfg(cfg)
    lock, lock_eq = [], []
    for i in range(1, 4):
        _, po = pipeline.step(pcfg, interop.state_from_numpy(before[i - 1], "cpu"), *scans[i], 0.1 * i)
        lock.append(float(np.abs(_t(n(po.odom.T)) - _t(outs[i - 1])).max()))
        lock_eq.append(bool(np.array_equal(n(po.odom.T), outs[i - 1])))
    ps = pipeline.init_state(pcfg, *scans[0], 0.0, device="cpu")
    chain, chain_eq = [], []
    for i in range(1, 4):
        ps, po = pipeline.step(pcfg, ps, *scans[i], 0.1 * i)
        chain.append(float(np.abs(_t(n(po.odom.T)) - _t(outs[i - 1])).max()))
        chain_eq.append(bool(np.array_equal(n(po.odom.T), outs[i - 1])))
    return dict(kantplatz_lockstep_m=lock, kantplatz_lockstep_bits_equal=lock_eq,
                kantplatz_chained_m=chain, kantplatz_chained_bits_equal=chain_eq)


def step_chunk():
    from test_pipeline import ddlo_cfg
    from test_torch_step_chunk import _scans
    from torch_parity import n, port_cfg

    from dynamic_direct_lidar_odometry_tpu import pipeline as jpipe
    from dynamic_direct_lidar_odometry_tpu_torch import pipeline

    cfg = ddlo_cfg()
    cfg = dataclasses.replace(cfg, capacity=dataclasses.replace(cfg.capacity, max_submap_points=8192))
    scans = _scans(cfg)
    pts = np.stack([s[0] for s in scans[1:]])
    msk = np.stack([s[1] for s in scans[1:]])
    ts = np.arange(1, 4, dtype=np.float32) * 0.1
    st0 = pipeline.init_state(port_cfg(cfg), *scans[0], 0.0, device="cpu")
    _, outs = pipeline.step_chunk(port_cfg(cfg), st0, pts, msk, ts)
    j0 = jpipe.init_state(cfg, jnp.asarray(scans[0][0]), jnp.asarray(scans[0][1]), 0.0)
    _, j_outs = jpipe.step_chunk(cfg, j0, jnp.asarray(pts), jnp.asarray(msk), jnp.asarray(ts))
    pT, jT = n(outs.odom.T), np.asarray(j_outs.odom.T)
    return dict(step_chunk_m=float(np.abs(_t(pT) - _t(jT)).max()),
                step_chunk_bits_equal=bool(np.array_equal(pT, jT)))


def replay_batch():
    from test_torch_parallel import CPU, _tiny_cfg
    from torch_parity import port_cfg

    from dynamic_direct_lidar_odometry_tpu.io import dataset
    from dynamic_direct_lidar_odometry_tpu.parallel import replay as jreplay
    from dynamic_direct_lidar_odometry_tpu_torch.parallel import replay

    cfg = _tiny_cfg()
    seqs = [dataset.synthetic_sequence(n_scans=3, H=16, W=128, n_dynamic=0, seed=i) for i in range(4)]
    args = [np.stack([getattr(s, f) for s in seqs]) for f in ("points", "mask", "stamps")]
    want = jreplay.replay_batch(cfg, *args)
    got = replay.replay_batch(port_cfg(cfg), *args, mesh=CPU)
    return dict(replay_batch_m=float(np.abs(got.poses - want.poses).max()),
                replay_batch_bits_equal=bool(np.array_equal(got.poses, want.poses)))


def _h(N, seed):
    import torch
    from test_torch_gicp_bits import _inputs

    from dynamic_direct_lidar_odometry_tpu.ops import gicp as jgicp
    from dynamic_direct_lidar_odometry_tpu_torch.ops import gicp

    args = _inputs(N, seed)
    jH = np.asarray(jax.jit(jgicp._linearize, static_argnums=(7, 8))(*args, 1.0, "auto")[1])
    pH = gicp._linearize(*(torch.from_numpy(np.asarray(a)) for a in args), 1.0, "auto")[1].numpy()
    return jH, pH


def h_spread(N):
    import subprocess

    out = {}
    for seed in (0, 1):
        jH, pH = _h(N, seed)
        one = subprocess.run(["taskset", "-c", "0", sys.executable, __file__, "--h1", str(N), str(seed)],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()[-1]
        jH1 = np.array(json.loads(one), np.float32)
        ulp = np.spacing(np.abs(jH).max(axis=1, keepdims=True))

        def cmp(a, b):
            return dict(entries_differ=int((a != b).sum()),
                        max_ulp_of_row_max=float((np.abs(a.astype(np.float64) - b) / ulp).max()))

        out[f"seed{seed}"] = dict(N=N, jax_all_cores_vs_one=cmp(jH, jH1), port_vs_jax_all_cores=cmp(pH, jH),
                                  port_vs_jax_one_core=cmp(pH, jH1))
    print(json.dumps(out))


def probe(K, step=8):
    f = jax.jit(lambda a, b: jnp.matmul(a.T, b, precision=jax.lax.Precision.HIGHEST))
    big = np.float32(2.0**40)
    A = np.ones((K, 6), np.float32)
    ks = list(range(step, K, step))
    end = {}
    for s in range(0, len(ks), 6):
        B = np.ones((K, 6), np.float32)
        B[0] = big
        cols = ks[s:s + 6]
        for j, k in enumerate(cols):
            B[k, j] = -big
        H = np.asarray(f(A, B))
        for j, k in enumerate(cols):
            end[k] = int(K - 2 - H[0, j]) + 2
    runs, prev = [], None
    for k in ks:
        e = end[k] if end[k] > k + 1 else None  # None: k shares the chain that starts at row 0
        if e != prev:
            runs.append((k, e))
            prev = e
    print(json.dumps(dict(K=K, runs=runs)))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--probe"]:
        probe(int(sys.argv[2]))
        sys.exit(0)
    if sys.argv[1:2] == ["--h1"]:  # JAX's H alone, in a process pinned by the caller
        print(json.dumps(_h(int(sys.argv[2]), int(sys.argv[3]))[0].tolist()))
        sys.exit(0)
    if sys.argv[1:2] == ["--h"]:
        h_spread(int(sys.argv[2]))
        sys.exit(0)
    out = {}
    for fn in (kantplatz, step_chunk, replay_batch):
        out.update(fn())
        print(json.dumps(out), flush=True)
