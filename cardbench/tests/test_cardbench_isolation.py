"""A run imports no module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``dynamic_direct_lidar_odometry_tpu`` (compared whole: the
port's own name begins with the JAX package's), and reads none of the JAX
package's benchmark files."""

import ast
import subprocess
import sys
import textwrap

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "dynamic_direct_lidar_odometry_tpu"}


def test_a_run_loads_nothing_of_the_jax_side():
    """A tiny run on the CPU (set-up, steps, the reference's judging and a
    trace reduction) with the JAX side blocked from import, and nothing of
    it in ``sys.modules`` after."""
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(ROOT)!r}, {str(BENCH)!r}, {str(BENCH / 'tests')!r}]
        BLOCKED = {sorted(FORBIDDEN)!r}

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        from conftest import tiny_cell
        import harness, run, stats, timeline, controls, roofline
        from reference import judge
        cell = tiny_cell("doals.stream1", rows=16, columns=128, lap=336)
        feed = harness.make_feed(cell, 2**40 + 5, "cpu")
        drv = harness.Driver(cell, feed, "cpu")
        drv.step()
        drv.begin_window()
        for _ in range(2):
            drv.step(keep=True)
        harness.judge_run(cell, feed, drv.rec)
        assert run.loaded_forbidden() == [], run.loaded_forbidden()
        print(sorted({{m.split(".")[0] for m in sys.modules}} & set(BLOCKED)))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_check_compares_whole_top_level_names(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "dynamic_direct_lidar_odometry_tpu_torch_x", object())
    assert "dynamic_direct_lidar_odometry_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert "jaxlib" in run.loaded_forbidden()


def test_no_benchmark_source_imports_the_jax_side_or_its_bench_files():
    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"bench", "chip_smoke", "tools"}, (path, n)
        text = path.read_text()
        for f in ("bench.py", "BENCH_r", "BASELINE.json", "MULTICHIP_", "SCALING_", "ATTRIBUTION_"):
            assert f not in text or path.name.startswith("test_cardbench_isolation"), (path, f)
