"""The port's HTTP server (``serve/server.py``) against the JAX package's,
on the CPU, on bridged weights (f32 on both sides).

The port runs as a live server on a socket; the JAX package's
``InterpolationService`` is called in-process on the same multipart
bodies. Tolerances:

- frames: 1 LSB (the repo's cross-program tolerance);
- statuses, ``detail`` strings, the catalog, model info and the parsed
  multipart parts: equal;
- ``/evaluate-interpolation``: ``linear`` and ``optical_flow`` score the
  same predictions, so PSNR within 1e-4 dB and SSIM within 1e-5 (f32 sums
  in another order). ``unet`` scores a prediction within 1 LSB of JAX's:
  a change of at most 1 at every pixel moves the MSE by at most
  2 sqrt(MSE) + 1, which bounds the PSNR difference (computed from the
  measured MSE below), and the SSIM within 2e-4, the repo's bound for
  1-LSB predictions (``tests/test_torch_eval.py``).
"""

import base64
import dataclasses
import io
import json
import math
import socket
import sys
import threading
import time
import urllib.error
import urllib.request

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_based_frame_interpolation_torch.config import ModelConfig as TConfig
from ai_based_frame_interpolation_torch.config import ServeConfig as TServe
from ai_based_frame_interpolation_torch.data.synthetic import (
    write_fixture_video)
from ai_based_frame_interpolation_torch.infer.engine import (
    InterpolationEngine as TEngine)
from ai_based_frame_interpolation_torch.ops.png import decode_png, encode_png
from ai_based_frame_interpolation_torch.serve import server as t_srv
from ai_based_frame_interpolation_tpu.config import ModelConfig as JConfig
from ai_based_frame_interpolation_tpu.config import ServeConfig as JServe
from ai_based_frame_interpolation_tpu.infer.engine import (
    InterpolationEngine as JEngine)
from ai_based_frame_interpolation_tpu.models import build_model as j_build
from ai_based_frame_interpolation_tpu.serve import server as j_srv
from test_torch_unet import random_variables

HW = (32, 32)
UNET = dict(base_width=4, depth=2, space_to_depth=2, residual=True,
            refine_width=8, upsample="half_pixel")
FLOW = dict(arch="flow", base_width=4, depth=2, flow_scale=2, refine_width=8,
            max_flow=8)


def _image(seed, hw=HW):
    gen = np.random.default_rng(seed)
    y, x = np.mgrid[0:hw[0], 0:hw[1]]
    base = 127 + 90 * np.sin((x + 3 * seed) / 5.0) * np.cos(y / 4.0)
    return np.clip(base + gen.normal(0, 6, hw), 0, 255).astype(
        np.uint8)[..., None]


def _png(seed, hw=HW):
    return encode_png(_image(seed, hw))


def multipart_body(fields):
    boundary = "testboundary123"
    out = io.BytesIO()
    for name, value in fields.items():
        out.write(f"--{boundary}\r\n".encode())
        if isinstance(value, tuple):
            fname, ctype, data = value
            out.write(f'Content-Disposition: form-data; name="{name}"; '
                      f'filename="{fname}"\r\n'.encode())
            out.write(f"Content-Type: {ctype}\r\n\r\n".encode())
            out.write(data)
        else:
            out.write(f'Content-Disposition: form-data; name="{name}"'
                      '\r\n\r\n'.encode())
            out.write(str(value).encode())
        out.write(b"\r\n")
    out.write(f"--{boundary}--\r\n".encode())
    return out.getvalue(), f"multipart/form-data; boundary={boundary}"


def frames_fields(seed=1, **extra):
    return dict(frame1=("a.png", "image/png", _png(seed)),
                frame2=("b.png", "image/png", _png(seed + 1)), **extra)


def request(port, path, method="GET", body=None, ctype=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method=method)
    if ctype:
        req.add_header("Content-Type", ctype)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


class Pair:
    """A live port server and the JAX service on the same weights."""

    def __init__(self, kw, seed):
        variables = random_variables(kw, HW, seed=seed)
        self.jeng = JEngine(j_build(JConfig(**kw), jnp.float32), variables,
                            compute_dtype=jnp.float32)
        self.teng = TEngine.from_flax_variables(
            variables, TConfig(**kw), compute_dtype=torch.float32,
            device="cpu")
        self.jax = j_srv.InterpolationService(self.jeng, JServe(), HW)
        self.srv = t_srv.Server(self.teng, TServe(host="127.0.0.1", port=0),
                                resolution=HW).start_background()
        self.port = self.srv.port

    def post(self, path, fields):
        return request(self.port, path, "POST", *multipart_body(fields))

    def jax_call(self, path, fields):
        parts = j_srv.parse_multipart(*multipart_body(fields))
        method = {"/interpolate": self.jax.interpolate,
                  "/interpolate-frames": self.jax.interpolate_frames,
                  "/interpolate-video": self.jax.interpolate_video,
                  "/evaluate-interpolation":
                      self.jax.evaluate_interpolation}[path]
        return method(parts)


@pytest.fixture(scope="module")
def unet():
    pair = Pair(UNET, seed=0)
    yield pair
    pair.srv.shutdown()


@pytest.fixture(scope="module")
def flow():
    pair = Pair(FLOW, seed=1)
    yield pair
    pair.srv.shutdown()


# ---------------------------------------------------------------------------
# the multipart parsers
# ---------------------------------------------------------------------------

def _parts(mod, body, ctype, spool_dir=None, threshold=1 << 20):
    try:
        parts = mod.parse_multipart_stream(io.BytesIO(body).read, len(body),
                                           ctype, spool_dir=spool_dir,
                                           spool_threshold=threshold)
    except mod.HTTPError as e:
        return ("error", e.status, e.detail)
    return {k: (p.name, p.filename, p.content_type, p.data, p.size,
                p.path is None) for k, p in parts.items()}


def _bodies():
    big = bytes(range(256)) * 1024                   # 256 KB file part
    ok, ctype = multipart_body({"video": ("clip.mp4", "video/mp4", big),
                                "factor": 2})
    frames, fctype = multipart_body(frames_fields(num_intermediate=4))
    nameless = (b"--b\r\nContent-Disposition: form-data\r\n\r\nx\r\n"
                b"--b\r\nContent-Disposition: form-data; name=\"k\"\r\n\r\n"
                b"v\r\n--b--\r\n")
    return {"spooled": (ok, ctype), "frames": (frames, fctype),
            "nameless_part": (nameless, "multipart/form-data; boundary=b"),
            "truncated": (ok[:len(ok) // 2], ctype),
            "no_boundary": (ok, "multipart/form-data"),
            "no_delimiter": (b"garbage", ctype),
            "quoted_boundary": (nameless,
                                'multipart/form-data; boundary="b"')}


@pytest.mark.parametrize("case", sorted(_bodies()))
def test_multipart_parsers_equal_jax(case, tmp_path):
    body, ctype = _bodies()[case]
    want = _parts(j_srv, body, ctype)
    assert _parts(t_srv, body, ctype) == want
    j_dir, t_dir = tmp_path / "j", tmp_path / "t"
    j_dir.mkdir()
    t_dir.mkdir()
    spooled = _parts(t_srv, body, ctype, str(t_dir), 64 * 1024)
    assert spooled == _parts(j_srv, body, ctype, str(j_dir), 64 * 1024)
    if case == "spooled":
        assert not spooled["video"][5] and spooled["factor"][5]
    assert t_srv.parse_multipart(body, ctype).keys() == want.keys() \
        if isinstance(want, dict) else True


# ---------------------------------------------------------------------------
# statuses and details
# ---------------------------------------------------------------------------

VALIDATION = {
    "num_intermediate_0": ("/interpolate", frames_fields(num_intermediate=0)),
    "num_intermediate_11": ("/interpolate",
                            frames_fields(num_intermediate=11)),
    "num_intermediate_text": ("/interpolate",
                              frames_fields(num_intermediate="x")),
    "fps_5": ("/interpolate", frames_fields(fps=5)),
    "fps_61": ("/interpolate", frames_fields(fps=61)),
    "missing_frame2": ("/interpolate",
                       {"frame1": ("a.png", "image/png", _png(1))}),
    "not_an_image": ("/interpolate",
                     {"frame1": ("a.txt", "text/plain", b"not an image"),
                      "frame2": ("b.png", "image/png", _png(2))}),
    "corrupt_png": ("/interpolate",
                    {"frame1": ("a.png", "image/png", b"\x89PNG garbage"),
                     "frame2": ("b.png", "image/png", _png(2))}),
    "truncated_png": ("/interpolate-frames",
                      {"frame1": ("a.png", "image/png", _png(1)[:40]),
                       "frame2": ("b.png", "image/png", _png(2))}),
    "times_text": ("/interpolate-frames", frames_fields(times="a,b")),
    "times_out_of_range": ("/interpolate-frames",
                           frames_fields(times="0.5,1.0")),
    "times_on_unet": ("/interpolate-frames", frames_fields(times="0.5")),
    "factor_1": ("/interpolate-video",
                 {"video": ("c.mp4", "video/mp4", b"x"), "factor": 1}),
    "target_fps_on_unet": ("/interpolate-video",
                           {"video": ("c.mp4", "video/mp4", b"x"),
                            "target_fps": 25}),
    "missing_video": ("/interpolate-video", {"factor": 2}),
    "not_a_video": ("/interpolate-video",
                    {"video": ("c.txt", "text/plain", b"x")}),
    "missing_ground_truth": ("/evaluate-interpolation", frames_fields()),
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_validation_matches_jax(unet, case):
    path, fields = VALIDATION[case]
    with pytest.raises(j_srv.HTTPError) as e:
        unet.jax_call(path, fields)
    status, _, blob = unet.post(path, fields)
    assert (status, json.loads(blob)["detail"]) == (e.value.status,
                                                    e.value.detail)


def test_unknown_route_non_multipart_and_oversized(unet):
    assert request(unet.port, "/nope")[0] == 404
    status, _, blob = request(unet.port, "/nope", "POST", b"{}",
                              "application/json")
    assert (status, json.loads(blob)) == (404, {"detail": "not found"})
    status, _, blob = request(unet.port, "/interpolate", "POST", b"{}",
                              "application/json")
    assert (status, json.loads(blob)["detail"]) == (
        400, "expected multipart/form-data")
    huge = unet.srv.service.cfg.max_upload_bytes * 3 + 65537
    with socket.create_connection(("127.0.0.1", unet.port), timeout=30) as s:
        s.sendall(b"POST /interpolate HTTP/1.1\r\nHost: localhost\r\n"
                  b"Content-Type: multipart/form-data; boundary=x\r\n"
                  + f"Content-Length: {huge}\r\n\r\n".encode())
        resp = b""
        while chunk := s.recv(4096):   # the server closes after its answer
            resp += chunk
    assert b"413" in resp.split(b"\r\n", 1)[0]
    assert b'"detail": "request too large"' in resp


def test_catalog_model_info_and_health_match_jax(unet):
    status, headers, blob = request(unet.port, "/")
    assert status == 200 and json.loads(blob) == unet.jax.index()
    assert headers["Access-Control-Allow-Origin"] == "*"
    info = json.loads(request(unet.port, "/model-info")[2])
    assert info == json.loads(json.dumps(unet.jax.model_info()))
    assert info["compute_dtype"] == "float32" and info["parameters"] > 0
    health = json.loads(request(unet.port, "/health")[2])
    want = unet.jax.health()
    assert health.keys() == want.keys()
    assert health["backend"] == want["backend"] == "cpu"
    # the port's batcher adds its mean queue wait to JAX's stats
    assert health["batching"].keys() == want["batching"].keys() | {
        "avg_queue_wait_ms"}


# ---------------------------------------------------------------------------
# frames and metrics against the JAX service
# ---------------------------------------------------------------------------

def _decode_all(data):
    return [decode_png(base64.b64decode(f)) for f in data["frames"]]


@pytest.mark.parametrize("num", [1, 3])
def test_interpolate_frames_matches_jax(unet, num):
    fields = frames_fields(seed=3, num_intermediate=num)
    status, _, blob = unet.post("/interpolate-frames", fields)
    assert status == 200, blob
    got = json.loads(blob)
    want = unet.jax_call("/interpolate-frames", fields)
    assert {k: v for k, v in got.items() if k != "frames"} == \
        {k: v for k, v in want.items() if k != "frames"}
    for g, w in zip(_decode_all(got), want["frames"]):
        w = cv2.imdecode(np.frombuffer(base64.b64decode(w), np.uint8),
                         cv2.IMREAD_GRAYSCALE)[..., None]
        assert g.shape == w.shape == (*HW, 1)
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1


def test_interpolate_frames_at_times_matches_jax(flow):
    fields = frames_fields(seed=5, times="0.25,0.6,0.9")
    status, _, blob = flow.post("/interpolate-frames", fields)
    assert status == 200, blob
    got = json.loads(blob)
    want = flow.jax_call("/interpolate-frames", fields)
    assert got["times"] == want["times"] == [0.25, 0.6, 0.9]
    assert got["num_intermediate"] == want["num_intermediate"] == 3
    for g, w in zip(_decode_all(got), want["frames"]):
        w = cv2.imdecode(np.frombuffer(base64.b64decode(w), np.uint8),
                         cv2.IMREAD_GRAYSCALE)[..., None]
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1


def test_uploads_resized_and_in_other_formats(unet):
    """The upload decode against JAX's: exact at the upload's own size,
    1 LSB after a resize (f32 taps against cv2's fixed point); the endpoint
    serves the engine on what the port decoded."""
    big = _image(7, (45, 60))
    ok, jpg = cv2.imencode(".jpg", big[..., 0])
    for data in (encode_png(big), jpg.tobytes()):
        for size in (HW, (45, 60)):
            got = t_srv.decode_image_bytes(data, True, size)
            want = j_srv.decode_image_bytes(data, True, size)
            diff = np.abs(got.astype(int) - want.astype(int)).max()
            bound = 0 if size == big.shape[:2] else 1
            assert got.shape == want.shape and diff <= bound, (size, diff)
    fields = {"frame1": ("a.png", "image/png", encode_png(big)),
              "frame2": ("b.jpg", "image/jpeg", jpg.tobytes()),
              "num_intermediate": 1}
    status, _, blob = unet.post("/interpolate-frames", fields)
    assert status == 200, blob
    got = _decode_all(json.loads(blob))[0]
    want = unet.teng.interpolate_pair(
        t_srv.decode_image_bytes(encode_png(big), True, HW),
        t_srv.decode_image_bytes(jpg.tobytes(), True, HW))
    assert np.array_equal(got, want)


def test_evaluate_interpolation_matches_jax(unet):
    fields = {"frame1": ("a.png", "image/png", _png(8)),
              "ground_truth": ("g.png", "image/png", _png(9)),
              "frame2": ("b.png", "image/png", _png(10))}
    status, _, blob = unet.post("/evaluate-interpolation", fields)
    assert status == 200, blob
    got = json.loads(blob)["metrics_by_method"]
    want = unet.jax_call("/evaluate-interpolation", fields)[
        "metrics_by_method"]
    assert list(got) == list(want) == ["unet", "linear", "optical_flow"]
    for m in ("linear", "optical_flow"):
        assert abs(got[m]["psnr"] - want[m]["psnr"]) <= 1e-4, m
        assert abs(got[m]["ssim"] - want[m]["ssim"]) <= 1e-5, m
    mse = 255.0 ** 2 / 10 ** (want["unet"]["psnr"] / 10)
    bound = 10 * math.log10(1 + (2 * math.sqrt(mse) + 1) / mse)
    assert abs(got["unet"]["psnr"] - want["unet"]["psnr"]) <= bound
    assert abs(got["unet"]["ssim"] - want["unet"]["ssim"]) <= 2e-4


# ---------------------------------------------------------------------------
# the MP4 endpoints (OpenCV is installed here) and OpenCV hidden
# ---------------------------------------------------------------------------

def _frame_count(blob, tmp_path):
    path = str(tmp_path / "out.mp4")
    with open(path, "wb") as f:
        f.write(blob)
    cap = cv2.VideoCapture(path)
    n, fps = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return n, fps


@pytest.mark.parametrize("num", [1, 3])
def test_interpolate_returns_an_mp4(unet, num, tmp_path):
    status, headers, blob = unet.post(
        "/interpolate", frames_fields(num_intermediate=num, fps=20))
    assert status == 200, blob
    assert headers["Content-Type"] == "video/mp4"
    assert headers["Content-Disposition"] == (
        f'attachment; filename="interpolated_frames_{num}inter_20fps.mp4"')
    n, fps = _frame_count(blob, tmp_path)
    assert n == 2 + num and abs(fps - 20) < 0.5


def _clip(tmp_path, frames=3):
    path = write_fixture_video(str(tmp_path / "clip.mp4"), num_frames=frames,
                               height=HW[0], width=HW[1])
    with open(path, "rb") as f:
        return f.read()


def test_interpolate_video_and_its_backpressure(unet, tmp_path):
    fields = {"video": ("clip.mp4", "video/mp4", _clip(tmp_path)),
              "factor": 2}
    status, headers, blob = unet.post("/interpolate-video", fields)
    assert status == 200, blob
    assert 'filename="interpolated_2x.mp4"' in headers["Content-Disposition"]
    assert _frame_count(blob, tmp_path)[0] == 5
    service = unet.srv.service
    cfg = service.cfg
    service.cfg = dataclasses.replace(cfg, max_video_queue=1)
    results = {}
    try:
        service._video_lock.acquire()          # a job holds the device
        waiter = threading.Thread(target=lambda: results.setdefault(
            "first", unet.post("/interpolate-video", fields)))
        waiter.start()
        deadline = time.time() + 30
        while service._video_jobs < 1 and time.time() < deadline:
            time.sleep(0.02)
        assert service._video_jobs == 1
        status, headers, blob = unet.post("/interpolate-video", fields)
        assert status == 503 and headers["Retry-After"] == "10"
        assert json.loads(blob)["detail"] == \
            "server busy: video queue is full"
        service._video_lock.release()
        waiter.join(timeout=60)
        assert results["first"][0] == 200
    finally:
        if service._video_lock.locked():
            service._video_lock.release()
        service.cfg = cfg
    assert json.loads(request(unet.port, "/health")[2])[
        "requests_rejected"] >= 1


def test_opencv_missing_answers_500_naming_it_and_serving_goes_on(
        unet, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)       # import cv2 fails
    served = json.loads(request(unet.port, "/health")[2])["requests_served"]
    jpg = b"\xff\xd8\xff\xe0" + bytes(60)        # a JPEG's magic
    for path, fields in (
            ("/interpolate", frames_fields(num_intermediate=1)),
            ("/evaluate-interpolation",
             dict(frames_fields(), ground_truth=("g.png", "image/png",
                                                 _png(4)))),
            ("/interpolate-frames",
             {"frame1": ("a.jpg", "image/jpeg", jpg),
              "frame2": ("b.png", "image/png", _png(2))})):
        status, _, blob = unet.post(path, fields)
        detail = json.loads(blob)["detail"]
        assert status == 500 and detail.startswith("internal error: ") \
            and "OpenCV" in detail, (path, status, detail)
    status, _, blob = unet.post("/interpolate-frames",
                                frames_fields(num_intermediate=2))
    assert status == 200 and len(json.loads(blob)["frames"]) == 2
    health = json.loads(request(unet.port, "/health")[2])
    assert health["requests_served"] == served + 1


def test_make_fastapi_app_names_the_stdlib_server(unet):
    from ai_based_frame_interpolation_torch.serve.asgi import (
        make_fastapi_app)

    with pytest.raises(ImportError, match=(
            r"ai_based_frame_interpolation_torch\.serve\.server\.Server")):
        make_fastapi_app(unet.teng)


# ---------------------------------------------------------------------------
# the batcher's device thread
# ---------------------------------------------------------------------------

class _EchoEngine:
    """An engine stand-in whose pair function returns each pair's first
    frame ``n_out`` times, so every answer names its request."""

    device = torch.device("cpu")
    variables = None

    def _put(self, arr):
        return torch.from_numpy(arr)

    def _pair_fn(self, n_out, depth):
        return lambda _, f1, f2: torch.stack([f1] * n_out, 1)


def test_the_batcher_under_many_threads_answers_each_its_own():
    from ai_based_frame_interpolation_torch.serve.batcher import (
        DynamicBatcher)

    batcher = DynamicBatcher(_EchoEngine(), max_batch=8)
    # more requests of one num pending than max_batch: JAX's batcher spun
    # holding its lock when a later one led (serve/batcher.py)
    n_threads, per_thread = 48, 20
    errors, calls = [], []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def client(i):
        try:
            for k in range(per_thread):
                tag = np.full((2, 2, 1), (i * per_thread + k) % 251,
                              np.uint8)
                num = 1 + (i + k) % 3
                if k % 5 == 4:     # device work between batches, in order
                    calls.append(batcher.call(lambda t: int(t[0, 0, 0]),
                                              tag))
                    continue
                got = batcher.generate_intermediate_frames(tag, tag, num)
                assert len(got) == num and all(
                    np.array_equal(g, tag) for g in got), (i, k)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    batches = n_threads * per_thread * 4 // 5
    assert batcher.stats["batched_requests"] == batches
    assert batcher.stats["dispatches"] <= batches
    assert len(calls) == n_threads * per_thread // 5
    batcher.close()
    with pytest.raises(RuntimeError, match="shutdown"):
        batcher.interpolate_pair(np.zeros((2, 2, 1), np.uint8),
                                 np.zeros((2, 2, 1), np.uint8))

