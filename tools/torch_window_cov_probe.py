"""Where one ``ddlo_window_plane_cov`` launch spends its time, on one GPU.

Builds a copy of ``csrc/plane_reg.cu`` with ``%globaltimer`` stamps at
the window kernel's phases (thread 0 of every CTA) into
``build/window_cov_probe/``, launches it on ``bench_config()``'s scan 0
of ``steady_state_sequence`` (16,384 Morton-ordered rows, k = 10) after
five warm-up launches, and prints, over the CTAs that hold a live row,
the median and the largest time of each stamp since the CTA's entry
(microseconds), the spread of the CTAs' entries, and the launch's span
(first entry to last stamp). Exits 1 without a card.

    python tools/torch_window_cov_probe.py

The stamps are anchored on lines of the kernel; the tool fails on a
line it does not find.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (line of the kernel, what the stamp after it marks), in order
STAMPS = [
    ("  __shared__ float cov[kQueries][6];\n", "entry"),
    ("  if (!__syncthreads_or(live)) return;  // no live row here: nothing to stage\n", "mask read"),
    ("    cand[j] = make_float4(y0, y1, y2, cc);\n  }\n  __syncthreads();\n", "candidates staged"),
    ("  if (live) query_cov(cand, qi, lane, k, cov[w]);\n", "warp 0's covariance"),
    ("  if (live) query_cov(cand, qi, lane, k, cov[w]);\n  @@\n  __syncthreads();\n", "every warp's"),
    ("      regularize(A, out + (size_t)r * 9);\n    }\n  }\n", "regularized"),
]


def instrument(src: str) -> str:
    src = src.replace("namespace {\n", """namespace {
__device__ unsigned long long g_probe[65536 * 8];
__device__ __forceinline__ unsigned long long probe_now()
{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PROBE(i) do { if (threadIdx.x == 0) \\
  g_probe[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 8 + (i)] = probe_now(); } while (0)
""", 1)
    for i, (anchor, _) in enumerate(STAMPS):
        line = anchor.replace("@@\n", f"PROBE({i - 1});\n")
        if src.count(line) != 1:
            raise SystemExit(f"torch_window_cov_probe: the kernel has no line {anchor!r}")
        src = src.replace(line, line + f"  PROBE({i});\n")
    return src + """
extern "C" int probe_read(void* dst, int n)
{
  return (int)cudaMemcpyFromSymbol(dst, g_probe, n * sizeof(unsigned long long));
}
extern "C" int probe_clear(void* zeros, int n)
{
  return (int)cudaMemcpyToSymbol(g_probe, zeros, n * sizeof(unsigned long long));
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_window_cov_probe: no CUDA device", file=sys.stderr)
        return 1
    from dynamic_direct_lidar_odometry_tpu_torch import config
    from dynamic_direct_lidar_odometry_tpu_torch.io import dataset
    from dynamic_direct_lidar_odometry_tpu_torch.odometry import preprocess
    from dynamic_direct_lidar_odometry_tpu_torch.ops import _cuda_build

    out_dir = os.path.join(ROOT, "build", "window_cov_probe")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "probe.cu")
    with open(os.path.join(_cuda_build.CSRC, "plane_reg.cu")) as f:
        text = instrument(f.read())
    with open(src, "w") as f:
        f.write(text)
    lib_path = os.path.join(out_dir, "probe.so")
    subprocess.run([_cuda_build._nvcc(), *_cuda_build.NVCC_FLAGS, "-o", lib_path, src], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(lib_path)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ddlo_window_plane_cov.argtypes = [P, P, I, I, P, P]
    lib.probe_read.argtypes = lib.probe_clear.argtypes = [P, I]

    cfg = config.bench_config()
    k = cfg.gicp.s2s.k_correspondences
    seq = dataset.steady_state_sequence(1)
    dev = torch.device("cuda", 0)
    p = preprocess.preprocess(cfg, torch.as_tensor(seq.points[0], device=dev),
                              torch.as_tensor(seq.mask[0], device=dev))
    pts, mask = p.points.contiguous(), p.mask.contiguous()
    out = torch.empty((pts.shape[0], 3, 3), device=dev)
    ctas = (128 // 8) * (-(-pts.shape[0] // 128))
    zeros = np.zeros(ctas * 8, np.uint64)

    def launch():
        err = lib.ddlo_window_plane_cov(pts.data_ptr(), mask.data_ptr(), pts.shape[0], k, out.data_ptr(),
                                        torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    for _ in range(5):
        launch()
    torch.cuda.synchronize()
    lib.probe_clear(zeros.ctypes.data, zeros.size)
    launch()
    torch.cuda.synchronize()
    stamps = np.zeros(ctas * 8, np.uint64)
    lib.probe_read(stamps.ctypes.data, stamps.size)
    st = stamps.reshape(ctas, 8).astype(np.int64)[:, :len(STAMPS)]
    live = st[:, 2] > 0
    since = (st[live] - st[live, :1]) / 1e3
    rep = dict(
        card=subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True, timeout=60).stdout.strip(),
        rows=int(pts.shape[0]), live_rows=int(mask.sum()), k=k, ctas=ctas, ctas_with_live_rows=int(live.sum()),
        entries_us=[float(x) for x in np.percentile((st[:, 0] - st[:, 0].min()) / 1e3, [50, 100])],
        span_us=float((st[live].max() - st[:, 0].min()) / 1e3),
        since_entry_us={name: dict(median=float(np.median(since[:, i])), max=float(since[:, i].max()))
                        for i, (_, name) in enumerate(STAMPS) if i},
    )
    print(json.dumps(rep, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
