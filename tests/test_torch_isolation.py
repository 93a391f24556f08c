"""The port stands alone: it imports neither JAX nor the JAX package."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "ai_based_frame_interpolation_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "ai_based_frame_interpolation_tpu")


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import ai_based_frame_interpolation_torch.infer.engine\n"
        "import ai_based_frame_interpolation_torch.serve.batcher\n"
        "import ai_based_frame_interpolation_torch.ops.refine\n"
        "import ai_based_frame_interpolation_torch.models.bridge\n"
        "import ai_based_frame_interpolation_torch.models.flow\n"
        "import ai_based_frame_interpolation_torch.ops.warp_fused\n"
        "import ai_based_frame_interpolation_torch.ops.dconv_fused\n"
        "import ai_based_frame_interpolation_torch.ops.conv_direct\n"
        "import ai_based_frame_interpolation_torch.models.core_t\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_the_eval_path_loads_no_jax_opencv_pandas_or_plots():
    # the card's machine has none of these: an import would fail only there
    absent = FORBIDDEN + ("cv2", "pandas", "matplotlib", "PIL")
    code = (
        "import sys\n"
        "import ai_based_frame_interpolation_torch.eval.harness\n"
        "import ai_based_frame_interpolation_torch.eval.report\n"
        "import ai_based_frame_interpolation_torch.data.triplets\n"
        "import ai_based_frame_interpolation_torch.data.synthetic\n"
        "import ai_based_frame_interpolation_torch.ops.png\n"
        "import ai_based_frame_interpolation_torch.ops.ssim_fused\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {absent!r}]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_opencv_is_imported_only_by_the_farneback_baseline():
    users = set()
    for path in sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        tree = ast.parse(path.read_text(), str(path))
        spans = [(f.lineno, f.end_lineno, f.name) for f in ast.walk(tree)
                 if isinstance(f, ast.FunctionDef)]
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)) and "cv2" in {
                    (a.name if isinstance(node, ast.Import)
                     else node.module or "").split(".")[0]
                    for a in node.names}:
                where = [name for lo, hi, name in spans
                         if lo <= node.lineno <= hi] or ["<module>"]
                users.add((path.name, where[-1]))
    assert users == {("flow.py", "farneback_midpoint")}


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "__import__", "import_module") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_of_the_port_imports_jax(path):
    assert not set(_imported_roots(path)) & set(FORBIDDEN)
