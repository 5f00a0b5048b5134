"""What the benchmark imports: nothing it runs has JAX or the JAX package
as its top-level module (the port's name begins with the JAX package's, so
names are compared whole), and the reference and the work counts import
nothing of the port either. A run refuses to print a result when the
process holds such a module, and without a card."""

import ast
import os
import subprocess
import sys
import types

from benchmark import harness

HERE = harness.HERE
INDEPENDENT = ("reference", "work.py", "scene.py", "weights.py")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = set(_imports(path)) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_reference_and_counts_import_nothing_of_the_port():
    for path in _sources():
        rel = os.path.relpath(path, HERE)
        if rel.startswith(INDEPENDENT):
            assert "lidiff_tpu_torch" not in set(_imports(path)), rel


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "lidiff_tpu_torch_extra",
                        types.ModuleType("lidiff_tpu_torch_extra"))
    assert "lidiff_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "lidiff_tpu.ops",
                        types.ModuleType("lidiff_tpu.ops"))
    assert "lidiff_tpu" in harness.forbidden_modules()


def test_a_run_without_a_card_prints_no_result(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         "diff.complete", "--seed", str(2 ** 31 + 3), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_run_without_the_program_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files there is no program to run."""
    import shutil
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path.insert(0, '.');"
            "from benchmark import harness;"
            "r = harness.make_run('diff.complete', 3, 1, False, "
            "time.perf_counter(), device='cpu', root='.');"
            "harness.run_cell(r)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode != 0 and "lidiff_tpu_torch" in out.stderr
