"""What the benchmark imports, and its refusal to run without a card."""

import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
JAX = {"jax", "jaxlib", "flax", "trajopt_tpu"}


def imported(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports, anywhere in it."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def sources(*parts):
    return [p for p in BENCH.joinpath(*parts).rglob("*.py") if "__pycache__" not in p.parts]


def test_nothing_imports_jax_or_the_jax_package():
    """Top-level names compared whole: `trajopt_tpu_torch` is not `trajopt_tpu`."""
    for path in sources():
        assert not imported(path) & JAX, path


def test_the_reference_and_the_check_import_nothing_of_the_program():
    for path in sources("reference") + [BENCH / "harness" / "check.py",
                                        BENCH / "harness" / "scenes.py",
                                        BENCH / "harness" / "traffic.py",
                                        BENCH / "harness" / "roofline.py"]:
        assert "trajopt_tpu_torch" not in imported(path), path
        assert "trajopt_tpu_torch" not in path.read_text().replace("`trajopt_tpu_torch", ""), path


def test_no_file_of_the_repo_outside_is_read():
    """The harness reads no runner, record or entry of the JAX side."""
    for path in sources():
        if "tests" in path.relative_to(BENCH).parts:
            continue
        text = path.read_text()
        for name in ("bench_scale", "__graft_entry__", "BENCH_r0", "BENCH_SCALE"):
            assert name not in imported(path) and f'"{name}' not in text, (path, name)


def test_run_refuses_without_a_card():
    """No CUDA device and no ``--rehearse``: exit 2, no result line."""
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "bridge_p4.replan",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "HOME": str(ROOT)})
    assert out.returncode == 2, out.stderr
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr


def test_run_fails_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark: no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "bridge_p4.replan",
                          "--seed", "1", "--seconds", "1", "--trace", "0", "--rehearse"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    json.dumps(out.returncode)
