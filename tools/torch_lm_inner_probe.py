"""Where one ``ddlo_lm_inner`` launch spends its time, on one GPU.

Builds a copy of ``csrc/lm_trial.cu`` with ``clock64()`` stamps at the
kernel's phases (in the first block of the first stream: thread 0, a
point thread, and lane 0 of the control warp, "C:") into
``build/lm_inner_probe/``, launches it on ``tests/torch_lm_cases.py``'s
GICP-like streams (one free loop at 16,384 and 65,536 points, 8 streams
at 16,384, one loop rejected until lm_max_iterations), and prints per
case the median over 50 launches of each stamp, in SM cycles since the
kernel's entry, beside the launch's ``%globaltimer`` span (entry to exit
of that thread, microseconds) and the CUDA-event time around the launch
(host time included). Exits 1 without a card.

    python tools/torch_lm_inner_probe.py

The stamps are anchored on lines of the kernel; the tool fails on a
line it does not find.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

# (line of the kernel, what the stamp after it marks); "C:" the control lane
STAMPS = [
    ("  cluster_arrive();", "entry"),
    ("      point_warps_sync();  // the barrier is initialised before the copies complete on it", "init barrier"),
    ('''                "r"(shared_addr(&s_bar))
                : "memory");
        }
      }''', "copies issued"),
    ('''          if (tid < tail) d[head + body + tid] = g[head + body + tid];
        }
      }''', "B, head and tail loaded"),
    ("      point_warps_sync();  // the plain-loaded bytes of the other threads", "copies landed"),
    ("      warp_sum(acc0, 1);", "y0 pass"),
    ("      propose_into(lam, 0);", "C: first proposal"),
    ("  __syncthreads();  // the first proposal and the y0 warp sums are in place", "prologue barrier"),
    ("      if (!kShared && t == 0) warp_sum(acc0, 1);", "first pass"),
    ("      prep = prepare(s_d[cur], bsv, s_delta[cur], lam, a.rot_eps, a.trans_eps);", "C: decision prepared"),
    ("    if (t == 0) cluster_wait();", "points' barrier"),
    ("    cluster.sync();\n    if (ctrl && lane == 0) {", "partials gathered"),
    ("      s_go = !stop;", "C: decided"),
    ("    __syncthreads();\n    if (!s_go) break;", "first trial's end"),
]


def instrument(src: str) -> str:
    src = src.replace("namespace {\n\nconstexpr int kThreads", """__device__ long long g_probe[16];
__device__ long long g_span[2];
#define PROBE(i) do { if (blockIdx.x == 0 && threadIdx.x == (((i) == 6 || (i) == 9 || (i) == 12) ? \\
  kInnerThreads : 0)) g_probe[i] = clock64(); } while (0)
namespace {

constexpr int kThreads""", 1)
    for i, (line, _) in enumerate(STAMPS):
        if src.count(line) != 1:
            raise SystemExit(f"lm_inner probe: the kernel line {line!r} is not there once")
        stamp = f"PROBE({i});" if i not in (8, 9, 10, 11, 12, 13) else f"if (t == 0) PROBE({i});"
        if line.startswith("    cluster.sync();\n") or line.startswith("    __syncthreads();\n"):
            head, tail = line.split("\n", 1)
            src = src.replace(line, f"{head}\n    {stamp}\n{tail}")
        else:
            src = src.replace(line, f"{line}\n{stamp}")
    span = ('if (blockIdx.x == 0 && threadIdx.x == 0) { long long g; asm volatile("mov.u64 %0, %%globaltimer;" '
            ': "=l"(g)); g_span[IDX] = g; }')
    src = src.replace("  cluster_arrive();\nPROBE(0);", "  cluster_arrive();\nPROBE(0);\n" + span.replace("IDX", "0"))
    src = src.replace("    if (!s_go) break;\n  }\n}", "    if (!s_go) break;\n  }\n" + span.replace("IDX", "1") + "\n}")
    return src + """
extern "C" int probe_read(void* stamps, void* span) {
  cudaMemcpyFromSymbol(stamps, g_probe, sizeof(long long) * 16);
  cudaMemcpyFromSymbol(span, g_span, sizeof(long long) * 2);
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("lm_inner probe: no CUDA device", file=sys.stderr)
        return 1
    import torch_lm_cases as lc

    from dynamic_direct_lidar_odometry_tpu_torch.ops import _cuda_build

    out_dir = os.path.join(ROOT, "build", "lm_inner_probe")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "lm_inner_probe.cu")
    with open(os.path.join(ROOT, "dynamic_direct_lidar_odometry_tpu_torch", "csrc", "lm_trial.cu")) as f:
        src = instrument(f.read())
    with open(cu, "w") as f:
        f.write(src)
    so = cu[:-3] + ".so"
    r = subprocess.run([_cuda_build._nvcc(), *_cuda_build.NVCC_FLAGS, "-o", so, cu], capture_output=True, text=True)
    if r.returncode:
        print(r.stdout + r.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ddlo_lm_inner.argtypes = [P] * 8 + [ctypes.c_longlong, I] + [P] * 10 + [I] * 3 + [ctypes.c_float] * 2 + [P]
    lib.probe_read.argtypes = [P, P]
    dev = torch.device("cuda", 0)
    print("card " + subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                   capture_output=True, text=True).stdout.strip())
    for B, N, kind in ((1, 16384, "free"), (1, 65536, "free"), (8, 16384, "free"), (1, 16384, "reject_to_cap")):
        args = [x.to(dev) for x in lc.inner_case(B, N, seed=1, kinds=[kind] * B, lead=B > 1)]
        x0, lam, H, b, src_pts, valid, M, Bv, deg, _ = args
        lead = tuple(lam.shape)
        outs = ([torch.empty(lead, device=dev)] + [torch.empty(lead + (4, 4), device=dev) for _ in range(2)]
                + [torch.empty(lead, dtype=torch.bool, device=dev) for _ in range(4)]
                + [torch.empty(lead, dtype=torch.int32, device=dev)])
        stamps, spans, events = [], [], []
        for rep in range(60):
            lam_c = lam.clone()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            err = lib.ddlo_lm_inner(
                x0.data_ptr(), lam_c.data_ptr(), H.data_ptr(), b.data_ptr(), src_pts.data_ptr(), valid.data_ptr(),
                M.data_ptr(), Bv.data_ptr(), Bv.stride(0) if lead else 0, Bv.stride(-2), None, deg.data_ptr(),
                *[o.data_ptr() for o in outs], lam.numel(), N, lc.S.lm_max_iterations, lc.S.rotation_epsilon,
                lc.S.transformation_epsilon, torch.cuda.current_stream().cuda_stream)
            e1.record()
            torch.cuda.synchronize()
            if err:
                print(f"lm_inner probe: launch failed, CUDA error {err}", file=sys.stderr)
                return 1
            st, sp = (ctypes.c_longlong * 16)(), (ctypes.c_longlong * 2)()
            lib.probe_read(st, sp)
            if rep >= 10:
                stamps.append([st[i] - st[0] for i in range(len(STAMPS))])
                spans.append((sp[1] - sp[0]) / 1e3)
                events.append(e0.elapsed_time(e1) * 1e3)
        med = {name: statistics.median(s[i] for s in stamps) for i, (_, name) in enumerate(STAMPS)}
        print("lm_inner probe " + json.dumps(dict(
            streams=B, points=N, kind=kind, trials=int(outs[-1].max()), span_us=statistics.median(spans),
            event_us=statistics.median(events), cycles_since_entry=med)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
