"""What the benchmark loads: a cell's run loads no module whose top-level
name is ``jax``, ``jaxlib``, ``flax`` or ``low_cost_mocap_tpu`` (names
compared whole: the port's name begins with the JAX package's), and the
reference imports none of those nor the program."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from mocapbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "mocapbench"
JAX_NAMES = {"jax", "jaxlib", "flax", "low_cost_mocap_tpu"}


def _imported(path: Path) -> set:
    """Top-level names of every module a file imports (relative imports
    left out)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_neither_jax_nor_the_program():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert files
    for f in files:
        bad = _imported(f) & (JAX_NAMES | {"low_cost_mocap_tpu_torch",
                                            "mocapbench"})
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"


def test_harness_imports_no_jax():
    for f in sorted(BENCH.rglob("*.py")):
        assert not _imported(f) & JAX_NAMES, f.relative_to(ROOT)


def _run_cell_in(cwd: Path, workload: str, seconds: str):
    code = ("import json, sys\n"
            "from mocapbench import run\n"
            f"rc = run.main(['--workload', {workload!r}, '--seed', "
            f"'2147483711', '--seconds', {seconds!r}, '--trace', '0'], "
            "device='cpu')\n"
            "print(json.dumps({'rc': rc, 'loaded': sorted({m.split('.')[0] "
            "for m in sys.modules})}))\n")
    env = dict(os.environ, PYTHONPATH=str(cwd))
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_cell_loads_no_jax():
    p = _run_cell_in(ROOT, "drone4.live150", "0.05")
    lines = p.stdout.strip().splitlines()
    result, tail = json.loads(lines[-2]), json.loads(lines[-1])
    assert tail["rc"] == 0, p.stderr[-2000:]
    assert not set(tail["loaded"]) & JAX_NAMES
    assert "low_cost_mocap_tpu_torch" in tail["loaded"]
    assert result["correct"] is True
    assert list(result)[0] == "correct" and list(result)[-1] == "checks"
    assert {"attempted", "failed", "metrics", "device"} <= set(result)
    assert set(result["metrics"]) == {"pose_latency_p95_ms", "setup_s"}


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("low_cost_mocap_tpu_torch", sys)
    assert "low_cost_mocap_tpu" not in run.forbidden_modules()


def test_benchmark_files_alone_fail(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files has
    no program to measure: the run exits with another code than 0."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "mocapbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_cell_in(tmp_path, "drone4.live150", "0.05")
    assert p.returncode != 0 or json.loads(
        p.stdout.strip().splitlines()[-1])["rc"] != 0
