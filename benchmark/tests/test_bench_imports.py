"""What the benchmark loads: never JAX, its libraries or the JAX package
(top-level names compared whole, so the port's own name, which begins with
the JAX package's, does not match), and the reference nothing of the
port."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from benchmark.harness.env import FORBIDDEN
from benchmark.tests.sizes import ROOT

PORT = "ai_based_frame_interpolation_torch"


def _py_files(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.partition(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.partition(".")[0]


def test_no_source_imports_jax():
    for path in _py_files(os.path.join(ROOT, "benchmark")):
        bad = set(_imports(path)) & set(FORBIDDEN)
        assert not bad, (path, bad)


def test_reference_sources_import_nothing_of_the_port():
    for path in _py_files(os.path.join(ROOT, "benchmark", "reference")):
        assert PORT not in set(_imports(path)), path


def test_names_compared_whole():
    from benchmark.harness import env

    before = dict(sys.modules)
    try:
        sys.modules["ai_based_frame_interpolation_tpu_extra"] = object()
        sys.modules["jaxlike"] = object()
        assert not set(env.forbidden_modules()) & {
            "ai_based_frame_interpolation_tpu_extra", "jaxlike"}
        assert "ai_based_frame_interpolation_tpu" not in \
            env.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(before)


SCAN = r"""
import json, sys, time
sys.path.insert(0, {ROOT!r})
from benchmark import run as bench_run
from benchmark.harness import cell as cells, env
from benchmark.tests.sizes import tiny
for name in {cells_!r}:
    bench_run.run_cell(name, 5, 0.2, False, "cpu", overrides=tiny(name),
                       t_start=time.perf_counter())
    cells.readers(cells.load(name))
print(json.dumps(sorted({{m.partition(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_forbidden_module():
    """Every module a run of each inference cell loads, and the readers,
    in a fresh process."""
    code = SCAN.format(ROOT=ROOT, cells_=["unet_pairs_1080p_b32",
                                          "flow_pairs_1080p_b32",
                                          "unet_stream_2x_1080p"])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)
    assert PORT in tops


def test_reference_loads_nothing_of_the_port():
    code = (f"import sys, json; sys.path.insert(0, {ROOT!r}); "
            "import benchmark.reference.unet, benchmark.reference.flow; "
            "print(json.dumps(sorted({m.partition('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert PORT not in tops and not tops & set(FORBIDDEN)


@pytest.mark.parametrize("where", ["repo", "bare"])
def test_no_card_no_result(where, tmp_path):
    """Without a card, ``run.py`` exits non-zero and prints no result; so
    it does in a directory that holds only ``BENCHMARK.json`` and
    ``benchmark/``, where the port cannot even be imported."""
    import shutil

    cwd = ROOT
    if where == "bare":
        cwd = str(tmp_path)
        shutil.copytree(os.path.join(ROOT, "benchmark"),
                        os.path.join(cwd, "benchmark"),
                        ignore=shutil.ignore_patterns("__pycache__",
                                                      "_cache"))
        shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), cwd)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "unet_pairs_1080p_b32", "--seed", "2147483999", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=cwd, env=env)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    if where == "bare":
        code = (f"import sys, time; sys.path.insert(0, {cwd!r}); "
                "from benchmark import run; "
                "run.run_cell('unet_pairs_1080p_b32', 1, 0.1, False, 'cpu')")
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=300,
                             cwd=cwd, env=env)
        assert out.returncode != 0 and PORT in out.stderr
