"""The port stands alone: it imports neither JAX nor the JAX package."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "ai_based_frame_interpolation_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "ai_based_frame_interpolation_tpu")


# the imports and runs of the checks below, in the order one interpreter
# takes them (:func:`loaded`); a step's check sees what it and every step
# before it loaded, so a step that passes loads none of its names alone
STEPS = {
    # first: each of these imports the one before it, so each check is the
    # check of a fresh interpreter
    "parallel.mesh":
        "import ai_based_frame_interpolation_torch.parallel.mesh\n",
    "parallel.sharding":
        "import ai_based_frame_interpolation_torch.parallel.sharding\n",
    "parallel": "import ai_based_frame_interpolation_torch.parallel\n",
    "port": (
        "import ai_based_frame_interpolation_torch.infer.engine\n"
        "import ai_based_frame_interpolation_torch.serve.batcher\n"
        "import ai_based_frame_interpolation_torch.ops.refine\n"
        "import ai_based_frame_interpolation_torch.models.bridge\n"
        "import ai_based_frame_interpolation_torch.models.flow\n"
        "import ai_based_frame_interpolation_torch.ops.warp_fused\n"
        "import ai_based_frame_interpolation_torch.ops.dconv_fused\n"
        "import ai_based_frame_interpolation_torch.ops.conv_direct\n"
        "import ai_based_frame_interpolation_torch.models.core_t\n"
        "import ai_based_frame_interpolation_torch.models.tower\n"
        "import ai_based_frame_interpolation_torch.ops.native\n"
        "import ai_based_frame_interpolation_torch.data.video\n"
        "import ai_based_frame_interpolation_torch.train.loop\n"
        "import ai_based_frame_interpolation_torch.train.checkpoint\n"
        "import ai_based_frame_interpolation_torch.data.loader\n"
        "import ai_based_frame_interpolation_torch.ops.polyphase\n"),
    "eval_path": (
        "import ai_based_frame_interpolation_torch.eval.harness\n"
        "import ai_based_frame_interpolation_torch.eval.report\n"
        "import ai_based_frame_interpolation_torch.data.triplets\n"
        "import ai_based_frame_interpolation_torch.data.synthetic\n"
        "import ai_based_frame_interpolation_torch.ops.png\n"
        "import ai_based_frame_interpolation_torch.ops.ssim_fused\n"),
    "video_stream": (
        "import numpy as np\n"
        "from ai_based_frame_interpolation_torch.config import ModelConfig\n"
        "from ai_based_frame_interpolation_torch.infer.engine import (\n"
        "    InterpolationEngine)\n"
        "eng = InterpolationEngine.random_init(ModelConfig(base_width=4, "
        "depth=2), device='cpu')\n"
        "frames = [np.full((32, 32, 1), 9 * i, np.uint8) for i in range(4)]\n"
        "out = list(eng.interpolate_video_frames(iter(frames), 2, 2))\n"
        "assert len(out) == 7\n"),
    # __main__ runs main: --help, which exits 0
    **{m: ("sys.argv = ['fi-torch', '--help']\n"
           "try:\n"
           f"    import ai_based_frame_interpolation_torch.{m}\n"
           "except SystemExit as e:\n"
           "    assert e.code == 0, e.code\n")
       for m in ("serve.server", "serve.asgi", "cli", "__main__")},
}


@pytest.fixture(scope="module")
def loaded():
    """Per step of ``STEPS``, run in order in one fresh interpreter: the
    top-level names of the modules loaded once it has run."""
    roots = "sorted({m.split('.')[0] for m in sys.modules})"
    code = "import json, sys\nseen = {}\n" + "".join(
        f"{body}seen[{name!r}] = {roots}\n"
        for name, body in STEPS.items()) + "print(json.dumps(seen))\n"
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_importing_the_port_loads_no_jax(loaded):
    assert not set(loaded["port"]) & set(FORBIDDEN)


@pytest.mark.parametrize("module", ["parallel.mesh", "parallel.sharding",
                                    "parallel"])
def test_the_parallel_modules_load_no_jax(loaded, module):
    assert not set(loaded[module]) & set(FORBIDDEN)


def test_the_eval_path_loads_no_jax_opencv_pandas_or_plots(loaded):
    # the card's machine has none of these: an import would fail only there
    absent = FORBIDDEN + ("cv2", "pandas", "matplotlib", "PIL")
    assert not set(loaded["eval_path"]) & set(absent)


def test_the_video_stream_loads_no_opencv(loaded):
    # only the _file entry points open video files (OpenCV); a stream of
    # frames in host memory, the part that runs on the card, needs none
    assert not set(loaded["video_stream"]) & set(FORBIDDEN + ("cv2",))


def test_opencv_is_imported_only_by_the_farneback_baseline():
    # and by data/video.py's file reader and writer, and ops/image.py's
    # decode_image and save_image for what the PNG codec does not read or
    # write, each through its module's _opencv
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
    assert users == {("flow.py", "farneback_midpoint"),
                     ("video.py", "_opencv"), ("image.py", "_opencv")}


@pytest.mark.parametrize("module", ["serve.server", "serve.asgi", "cli",
                                    "__main__"])
def test_serving_and_the_cli_load_no_jax_opencv_plots_or_fastapi(loaded,
                                                                 module):
    # the card's machine need not have them: each is imported where a
    # path that needs it runs
    absent = FORBIDDEN + ("cv2", "matplotlib", "fastapi")
    assert not set(loaded[module]) & set(absent)


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
