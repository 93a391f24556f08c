"""HTTP serving on the port's engine (JAX ``serve/server.py``, the same
contract: routes, status codes, ``detail`` strings, headers, JSON keys and
the ``GET /`` catalog).

The reference's API (``api/app.py``): ``POST /interpolate`` (multipart
frame1/frame2 + num_intermediate 1-10 + fps 10-60 -> MP4), ``GET /``,
``GET /health``, plus ``GET /model-info``, ``POST /interpolate-frames``
(base64 PNG frames, optionally at exact ``times``), ``POST
/interpolate-video`` and ``POST /evaluate-interpolation``, all in-process
on one warm engine, stdlib only (``http.server`` and a streaming
multipart parser).

Threading: decode and validation run on the HTTP worker threads (a new
one per connection); the card is reached only from the continuous-batching
dispatcher's own thread (``serve/batcher.py``), which serializes it, fuses
concurrent requests into one batched dispatch, and also runs the exact-time
samples and the metrics (a thread's first PyTorch work on the card costs
tens of milliseconds).

Codecs: uploads decode through ``ops/image.py:decode_image`` (PNG by the
port's own codec on every machine; JPEG, BMP and TIFF through OpenCV where
it is installed), ``/interpolate-frames`` encodes with ``ops/png.py``. The
MP4 endpoints (``data/video.py``) and ``/evaluate-interpolation``'s
Farneback baseline need OpenCV: where it is missing they answer 500 with
a ``detail`` that names it, and the server keeps serving.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ServeConfig
from ..models.unet import count_parameters
from ..ops.image import decode_image, resize_uint8
from ..ops.png import encode_png

ALLOWED_EXTENSIONS = {"jpg", "jpeg", "png", "bmp", "tiff", "tif"}
ALLOWED_CONTENT_TYPES = {"image/jpeg", "image/jpg", "image/png", "image/bmp",
                         "image/tiff"}


class HTTPError(Exception):
    def __init__(self, status: int, detail: str,
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(detail)
        self.status = status
        self.detail = detail
        self.headers = headers or {}


# ---------------------------------------------------------------------------
# Multipart parsing (stdlib-only, streaming)
# ---------------------------------------------------------------------------

class Part:
    """One multipart field. Small parts live in RAM (``data`` bytes); large
    file parts are spooled to disk by the streaming parser (``path`` set,
    ``data`` reads the file back only if someone asks for bytes)."""

    def __init__(self, name: str, filename: Optional[str],
                 content_type: Optional[str], data: Optional[bytes] = None,
                 path: Optional[str] = None):
        self.name = name
        self.filename = filename
        self.content_type = content_type
        self._data = data
        self.path = path
        self.size = len(data) if data is not None else os.path.getsize(path)

    @property
    def data(self) -> bytes:
        if self._data is None:
            with open(self.path, "rb") as f:
                self._data = f.read()
        return self._data

    def save_to(self, dest: str) -> None:
        """Materialize this part as a file without an extra RAM copy."""
        if self.path is not None:
            import shutil

            shutil.copyfile(self.path, dest)
        else:
            with open(dest, "wb") as f:
                f.write(self._data)


class _PartSink:
    """Accumulates a part's body; file parts exceeding the spool threshold
    switch from RAM to a temp file in the per-request spool dir."""

    def __init__(self, spool_dir: Optional[str], threshold: Optional[int]):
        self._buf = bytearray()
        self._file = None
        self._path: Optional[str] = None
        self._spool_dir = spool_dir
        self._threshold = threshold     # None = never spool (form fields)

    def write(self, data: bytes) -> None:
        if self._file is not None:
            self._file.write(data)
            return
        self._buf += data
        if (self._threshold is not None and self._spool_dir is not None
                and len(self._buf) > self._threshold):
            fd, self._path = tempfile.mkstemp(dir=self._spool_dir,
                                              suffix=".part")
            self._file = os.fdopen(fd, "wb")
            self._file.write(bytes(self._buf))
            self._buf = bytearray()

    def to_part(self, name: str, filename: Optional[str],
                content_type: Optional[str]) -> Part:
        if self._file is not None:
            self._file.close()
            return Part(name, filename, content_type, path=self._path)
        return Part(name, filename, content_type, data=bytes(self._buf))

    def discard(self) -> None:
        if self._file is not None:
            self._file.close()
            os.unlink(self._path)


def parse_multipart_stream(read, length: int, content_type_header: str,
                           spool_dir: Optional[str] = None,
                           spool_threshold: int = 1 << 20) -> Dict[str, Part]:
    """Parse multipart/form-data incrementally from ``read(n)``.

    The body is consumed in 64 KB chunks; file parts larger than
    ``spool_threshold`` stream to ``spool_dir`` instead of accumulating in
    RAM, so a 50 MB video upload is never held in memory. Form fields
    always stay in RAM.
    """
    m = re.search(r'boundary="?([^";]+)"?', content_type_header)
    if not m:
        raise HTTPError(400, "malformed multipart request: no boundary")
    delim = b"\r\n--" + m.group(1).encode()
    keep = len(delim) + 4           # rolling tail: a boundary may span chunks
    remaining = length

    def more() -> bytes:
        nonlocal remaining
        if remaining <= 0:
            return b""
        chunk = read(min(65536, remaining))
        remaining -= len(chunk)
        return chunk

    parts: Dict[str, Part] = {}
    # the body opens with "--boundary" (no leading CRLF); prefix one so the
    # first boundary matches the same delimiter as all the others
    buf = b"\r\n"
    while delim not in buf:
        chunk = more()
        if not chunk:
            raise HTTPError(400, "malformed multipart request")
        buf = buf[-keep:] + chunk
    buf = buf[buf.index(delim) + len(delim):]

    while True:
        # after a boundary: either the terminal "--" or a part's headers
        while b"\r\n\r\n" not in buf:
            if buf.startswith(b"--"):
                return parts
            chunk = more()
            if not chunk:
                if buf.startswith(b"--") or not buf.strip():
                    return parts
                raise HTTPError(400, "malformed multipart request")
            buf += chunk
        if buf.startswith(b"--"):
            return parts
        header_blob, _, buf = buf.partition(b"\r\n\r\n")
        headers = {}
        for line in header_blob.split(b"\r\n"):
            k, _, v = line.partition(b":")
            headers[k.strip().lower().decode("latin-1")] = \
                v.strip().decode("latin-1")
        disp = headers.get("content-disposition", "")
        name_m = re.search(r'name="([^"]*)"', disp)
        file_m = re.search(r'filename="([^"]*)"', disp)
        sink = _PartSink(spool_dir,
                         spool_threshold if file_m is not None else None)
        while True:                  # stream body until the next boundary
            idx = buf.find(delim)
            if idx >= 0:
                sink.write(buf[:idx])
                buf = buf[idx + len(delim):]
                break
            if len(buf) > keep:
                sink.write(buf[:-keep])
                buf = buf[-keep:]
            chunk = more()
            if not chunk:
                sink.discard()
                raise HTTPError(400, "malformed multipart request (truncated)")
            buf += chunk
        if name_m:
            parts[name_m.group(1)] = sink.to_part(
                name_m.group(1), file_m.group(1) if file_m else None,
                headers.get("content-type"))
        else:
            sink.discard()


def parse_multipart(body: bytes, content_type_header: str) -> Dict[str, Part]:
    """Parse an in-memory multipart body (thin wrapper over the streaming
    parser — kept for the ASGI flavor and tests)."""
    import io

    return parse_multipart_stream(io.BytesIO(body).read, len(body),
                                  content_type_header, spool_dir=None)


class FilePayload:
    """A response body that stays on disk until it is streamed to the socket.

    The reference buffers its whole output MP4 in RAM before responding: a
    long clip at 8x can be hundreds of MB per in-flight response. Video endpoints now hand the transport one of these;
    the transport streams it in chunks and calls :meth:`close` when done,
    which removes the backing temp directory.
    """

    CHUNK = 256 * 1024

    def __init__(self, path: str, owned_dir: Optional[str] = None):
        self.path = path
        self._owned_dir = owned_dir
        self.size = os.path.getsize(path)

    def chunks(self):
        with open(self.path, "rb") as f:
            while True:
                chunk = f.read(self.CHUNK)
                if not chunk:
                    return
                yield chunk

    def bytes(self) -> bytes:
        """Whole-body read — for small payloads / the ASGI flavor / tests."""
        with open(self.path, "rb") as f:
            return f.read()

    def close(self) -> None:
        import shutil

        if self._owned_dir is not None:
            shutil.rmtree(self._owned_dir, ignore_errors=True)
            self._owned_dir = None
        elif os.path.exists(self.path):
            os.unlink(self.path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def validate_image_part(part: Optional[Part], field: str,
                        max_bytes: int) -> bytes:
    """Mirror the reference's upload validation (``api/app.py:52-63,139-154``)."""
    if part is None or not part.size:
        raise HTTPError(400, f"missing file field '{field}'")
    if part.size > max_bytes:
        raise HTTPError(400, f"{field} exceeds {max_bytes // (1024*1024)} MB limit")
    ext_ok = bool(part.filename and
                  part.filename.rsplit(".", 1)[-1].lower() in ALLOWED_EXTENSIONS)
    type_ok = (part.content_type or "").lower() in ALLOWED_CONTENT_TYPES
    if not (ext_ok or type_ok):
        raise HTTPError(400, f"{field} must be an image "
                        f"({'/'.join(sorted(ALLOWED_EXTENSIONS))})")
    return part.data


ALLOWED_VIDEO_EXTENSIONS = {"mp4", "avi", "mov", "mkv", "webm"}


def validate_video_part(part: Optional[Part], field: str,
                        max_bytes: int) -> Part:
    """Upload validation for the video endpoint (same 50 MB contract as
    images — reference ``api/app.py:36``)."""
    if part is None or not part.size:
        raise HTTPError(400, f"missing file field '{field}'")
    if part.size > max_bytes:
        raise HTTPError(400, f"{field} exceeds {max_bytes // (1024*1024)} MB limit")
    ext_ok = bool(part.filename and
                  part.filename.rsplit(".", 1)[-1].lower()
                  in ALLOWED_VIDEO_EXTENSIONS)
    type_ok = (part.content_type or "").lower().startswith("video/")
    if not (ext_ok or type_ok):
        raise HTTPError(400, f"{field} must be a video "
                        f"({'/'.join(sorted(ALLOWED_VIDEO_EXTENSIONS))})")
    return part


def decode_image_bytes(data: bytes, grayscale: bool,
                       size: Tuple[int, int]) -> np.ndarray:
    """Upload bytes -> HWC uint8 (gray or RGB) at ``size`` (H, W), resized
    as ``cv2.resize(INTER_LINEAR)`` within 1 LSB (``ops/image.py``)."""
    try:
        img = decode_image(data, grayscale)
    except (ValueError, NotImplementedError):
        raise HTTPError(400, "could not decode image")
    if (img.shape[0], img.shape[1]) != tuple(size):
        img = resize_uint8(img, size)
    return img


# ---------------------------------------------------------------------------
# Application logic (transport-independent — shared with the ASGI variant)
# ---------------------------------------------------------------------------

class InterpolationService:
    """Request handling around a warm engine; transport-agnostic."""

    def __init__(self, engine, cfg: ServeConfig = ServeConfig(),
                 resolution: Tuple[int, int] = (256, 256)):
        from .batcher import DynamicBatcher

        self.engine = engine
        self.cfg = cfg
        self.resolution = resolution
        # serializes device access AND fuses concurrent requests into
        # batched dispatches (continuous batching, serve/batcher.py)
        self.batcher = DynamicBatcher(engine, max_batch=cfg.max_batch,
                                      window_ms=cfg.batch_window_ms)
        self._video_lock = threading.Lock()
        # video-job backpressure: running + waiting jobs, capped (503 beyond)
        self._video_jobs = 0
        self._video_jobs_lock = threading.Lock()
        self.started_at = time.time()
        # stat counters are mutated from ThreadingHTTPServer worker threads;
        # += on an attribute is not atomic, so guard with a dedicated lock
        self._stats_lock = threading.Lock()
        self.requests_served = 0
        self.requests_rejected = 0

    def _count_served(self) -> None:
        with self._stats_lock:
            self.requests_served += 1

    def _count_rejected(self) -> None:
        with self._stats_lock:
            self.requests_rejected += 1

    # -- endpoint catalog (GET /) ------------------------------------------
    def index(self) -> dict:
        return {
            "name": "ai-based-frame-interpolation-tpu",
            "endpoints": {
                "POST /interpolate": "two images + num_intermediate + fps -> MP4",
                "POST /interpolate-video": "a video + factor (2-8), or "
                                           "target_fps for fractional "
                                           "retiming (exact-time models) -> "
                                           "MP4 at the new frame rate",
                "POST /interpolate-frames": "two images + num_intermediate -> "
                                            "JSON of base64 PNG frames",
                "POST /evaluate-interpolation": "three images (frame1, "
                                                "ground_truth, frame2) -> "
                                                "PSNR/SSIM of each method",
                "GET /health": "liveness + engine status",
                "GET /model-info": "model architecture and parameters",
                "GET /": "this catalog",
            },
        }

    def health(self) -> dict:
        return {"status": "healthy",
                "uptime_s": round(time.time() - self.started_at, 1),
                "requests_served": self.requests_served,
                "requests_rejected": self.requests_rejected,
                "video_jobs_in_flight": self._video_jobs,
                "batching": self.batcher.stats,
                "backend": self.engine.device.type}

    def model_info(self) -> dict:
        import dataclasses

        return {"config": dataclasses.asdict(self.engine.cfg),
                "parameters": count_parameters(self.engine.model),
                "resolution": list(self.resolution),
                "compute_dtype": str(self.engine.compute_dtype)
                .rpartition(".")[2]}

    def interpolate(self, parts: Dict[str, Part]) -> Tuple[bytes, str]:
        """Returns (mp4_bytes, suggested_filename)."""
        num = _int_field(parts, "num_intermediate", default=3)
        fps = _int_field(parts, "fps", default=30)
        if not 1 <= num <= self.cfg.max_intermediate:
            raise HTTPError(400, f"num_intermediate must be in "
                            f"[1, {self.cfg.max_intermediate}]")
        if not 10 <= fps <= 60:
            raise HTTPError(400, "fps must be in [10, 60]")
        d1 = validate_image_part(parts.get("frame1"), "frame1",
                                 self.cfg.max_upload_bytes)
        d2 = validate_image_part(parts.get("frame2"), "frame2",
                                 self.cfg.max_upload_bytes)
        grayscale = self.engine.cfg.channels == 1
        f1 = decode_image_bytes(d1, grayscale, self.resolution)
        f2 = decode_image_bytes(d2, grayscale, self.resolution)

        from ..data.video import VideoWriter, _opencv

        _opencv()           # no MP4 without OpenCV: fail before the card
        mids = self.batcher.generate_intermediate_frames(f1, f2, num)
        frames = [f1, *mids, f2]

        # same disk-streaming contract as /interpolate-video: the transport
        # chunks the MP4 from disk and FilePayload.close() removes the dir
        tmp = tempfile.mkdtemp(prefix="fi_frames_")
        try:
            out = os.path.join(tmp, "video.mp4")
            with VideoWriter(out, fps=float(fps)) as w:
                for fr in frames:
                    w.write(fr)
            payload = FilePayload(out, owned_dir=tmp)
        except BaseException:
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._count_served()
        return payload, f"interpolated_frames_{num}inter_{fps}fps.mp4"

    def interpolate_video(self, parts: Dict[str, Part],
                          deadline: Optional[float] = None
                          ) -> Tuple[bytes, str]:
        """Whole-video interpolation: upload a clip, get the 2x/4x/8x-fps
        MP4 back (the ``/interpolate-video`` endpoint the reference README
        promises, ``README.md:130-139``, but never implemented — its
        ``main.py video`` path is broken too, SURVEY.md §8.2).

        Streams through ``engine.interpolate_video_file``: decode ->
        batched device interpolation -> encode, O(1) memory in clip length.
        """
        factor = _int_field(parts, "factor", default=2)
        if not 2 <= factor <= 8:
            raise HTTPError(400, "factor must be an integer in [2, 8]")
        fps = _int_field(parts, "fps", default=0)  # 0 = input fps * factor
        if fps and not 1 <= fps <= 240:
            raise HTTPError(400, "fps must be in [1, 240]")
        target_fps = _float_field(parts, "target_fps", default=0.0)
        if target_fps and not 1.0 <= target_fps <= 240.0:
            raise HTTPError(400, "target_fps must be in [1, 240]")
        if target_fps and not self.engine.supports_exact_time:
            raise HTTPError(400, "target_fps retiming requires an exact-"
                                 "time model (flow family or time-"
                                 "conditioned); this server's model only "
                                 "supports integer factors")
        part = validate_video_part(parts.get("video"), "video",
                                   self.cfg.max_upload_bytes)
        ext = (part.filename or "clip.mp4").rsplit(".", 1)[-1].lower()
        if ext not in ALLOWED_VIDEO_EXTENSIONS:
            ext = "mp4"
        deadline = (time.time() + self.cfg.request_timeout_s
                    if deadline is None else deadline)
        # backpressure: bounded queue of video jobs (one runs, the rest
        # wait); beyond the cap answer 503 + Retry-After instead of letting
        # the queue grow without limit
        with self._video_jobs_lock:
            if self._video_jobs >= self.cfg.max_video_queue:
                self._count_rejected()
                raise HTTPError(503, "server busy: video queue is full",
                                headers={"Retry-After": "10"})
            self._video_jobs += 1
        try:
            # one video job on the device at a time; wait at most the
            # remaining request budget for our turn
            if not self._video_lock.acquire(
                    timeout=max(0.0, deadline - time.time())):
                self._count_rejected()
                raise HTTPError(503, "server busy: timed out waiting for "
                                     "the video queue",
                                headers={"Retry-After": "10"})
            try:
                # the output temp dir outlives this method: the transport
                # streams the MP4 from disk and removes the dir via
                # FilePayload.close() — the response never sits in RAM whole
                tmp = tempfile.mkdtemp(prefix="fi_video_")
                try:
                    in_path = os.path.join(tmp, f"in.{ext}")
                    out_path = os.path.join(tmp, "out.mp4")
                    part.save_to(in_path)
                    try:
                        if target_fps:
                            stats = self.engine.retime_video_file(
                                in_path, out_path, target_fps=target_fps,
                                deadline=deadline)
                        else:
                            stats = self.engine.interpolate_video_file(
                                in_path, out_path, factor=factor,
                                fps=float(fps) if fps else None,
                                deadline=deadline)
                    except TimeoutError as e:
                        raise HTTPError(504, f"video job timed out: {e}")
                    except (ValueError, OSError) as e:
                        raise HTTPError(400,
                                        f"could not interpolate video: {e}")
                    if not stats.get("output_frames"):
                        raise HTTPError(400, "could not decode any frames "
                                             "from the uploaded video")
                    os.unlink(in_path)        # only the output stays
                    payload = FilePayload(out_path, owned_dir=tmp)
                except BaseException:
                    import shutil

                    shutil.rmtree(tmp, ignore_errors=True)
                    raise
            finally:
                self._video_lock.release()
        finally:
            with self._video_jobs_lock:
                self._video_jobs -= 1
        self._count_served()
        name = (f"retimed_{target_fps:g}fps.mp4" if target_fps
                else f"interpolated_{factor}x.mp4")
        return payload, name

    def interpolate_frames(self, parts: Dict[str, Part]) -> dict:
        """PNG frames instead of a video (endpoint the reference README
        promises but never implemented — ``README.md:130-139``).

        An optional ``times`` field (comma-separated fractions in (0, 1),
        e.g. ``0.25,0.4,0.9``) samples those EXACT times instead of the
        evenly spaced ``num_intermediate`` grid — exact-time models only
        (flow family / time-conditioned).
        """
        import base64

        times: Optional[List[float]] = None
        tpart = parts.get("times")
        if tpart is not None:
            try:
                times = [float(s) for s in
                         tpart.data.decode().split(",") if s.strip()]
            except ValueError:
                raise HTTPError(400, "times must be comma-separated numbers")
            if not times or len(times) > self.cfg.max_intermediate:
                raise HTTPError(400, f"times must list 1-"
                                f"{self.cfg.max_intermediate} values")
            if any(not 0.0 < t < 1.0 for t in times):
                raise HTTPError(400, "each time must be in (0, 1)")
            if not self.engine.supports_exact_time:
                raise HTTPError(400, "arbitrary times require an exact-time "
                                     "model (flow family or time-"
                                     "conditioned); use num_intermediate")
        num = _int_field(parts, "num_intermediate", default=3)
        if not 1 <= num <= self.cfg.max_intermediate:
            raise HTTPError(400, f"num_intermediate must be in "
                            f"[1, {self.cfg.max_intermediate}]")
        d1 = validate_image_part(parts.get("frame1"), "frame1",
                                 self.cfg.max_upload_bytes)
        d2 = validate_image_part(parts.get("frame2"), "frame2",
                                 self.cfg.max_upload_bytes)
        grayscale = self.engine.cfg.channels == 1
        f1 = decode_image_bytes(d1, grayscale, self.resolution)
        f2 = decode_image_bytes(d2, grayscale, self.resolution)
        if times is not None:
            mids = self.batcher.call(self.engine.interpolate_at, f1, f2,
                                     times)
        else:
            mids = self.batcher.generate_intermediate_frames(f1, f2, num)

        def b64png(img):
            return base64.b64encode(encode_png(img)).decode()

        self._count_served()
        out = {"num_intermediate": len(mids),
               "frames": [b64png(m) for m in mids],
               "encoding": "base64 PNG, time order"}
        if times is not None:
            out["times"] = times
        return out

    def evaluate_interpolation(self, parts: Dict[str, Part]) -> dict:
        """Score every method against an uploaded ground-truth middle frame
        (endpoint the reference README promises but never implemented)."""
        from ..ops.flow import farneback_midpoint, linear_midpoint
        from ..ops.psnr import psnr
        from ..ops.ssim_fused import ssim_eval_auto

        imgs = {}
        for field in ("frame1", "ground_truth", "frame2"):
            data = validate_image_part(parts.get(field), field,
                                       self.cfg.max_upload_bytes)
            imgs[field] = decode_image_bytes(
                data, self.engine.cfg.channels == 1, self.resolution)
        preds = {"unet": self.batcher.interpolate_pair(imgs["frame1"],
                                                       imgs["frame2"])}
        preds["linear"] = linear_midpoint(imgs["frame1"], imgs["frame2"])
        preds["optical_flow"] = farneback_midpoint(imgs["frame1"],
                                                   imgs["frame2"])
        def metrics():
            dev = self.engine.device
            gt = torch.from_numpy(imgs["ground_truth"]).to(dev)
            out = {}
            for m, p in preds.items():
                p = torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                out[m] = {"psnr": float(psnr(p, gt)),
                          "ssim": float(ssim_eval_auto(p[None], gt[None])[0])}
            return out

        out = self.batcher.call(metrics)   # on the dispatcher's thread
        self._count_served()
        return {"metrics_by_method": out}


def _int_field(parts: Dict[str, Part], name: str, default: int) -> int:
    part = parts.get(name)
    if part is None:
        return default
    try:
        return int(part.data.decode().strip())
    except ValueError:
        raise HTTPError(400, f"{name} must be an integer")


def _float_field(parts: Dict[str, Part], name: str, default: float) -> float:
    part = parts.get(name)
    if part is None:
        return default
    try:
        return float(part.data.decode().strip())
    except ValueError:
        raise HTTPError(400, f"{name} must be a number")


# ---------------------------------------------------------------------------
# stdlib HTTP transport
# ---------------------------------------------------------------------------

def make_handler(service: InterpolationService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send_json(self, obj, status=200, extra_headers=None):
            blob = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.send_header("Access-Control-Allow-Origin", "*")
            for k, v in (extra_headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):
            if self.path == "/":
                self._send_json(service.index())
            elif self.path == "/health":
                self._send_json(service.health())
            elif self.path == "/model-info":
                self._send_json(service.model_info())
            else:
                self._send_json({"detail": "not found"}, 404)

        def do_OPTIONS(self):
            self.send_response(204)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods",
                             "GET, POST, OPTIONS")
            self.send_header("Access-Control-Allow-Headers", "*")
            self.send_header("Content-Length", "0")
            self.end_headers()

        def do_POST(self):
            routes = {"/interpolate", "/interpolate-frames",
                      "/interpolate-video", "/evaluate-interpolation"}
            if self.path not in routes:
                self._send_json({"detail": "not found"}, 404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > service.cfg.max_upload_bytes * 3 + 65536:
                    # reject before reading the oversized body; the
                    # connection is closed rather than draining it
                    self.close_connection = True
                    raise HTTPError(413, "request too large")
                ctype = self.headers.get("Content-Type", "")
                if "multipart/form-data" not in ctype:
                    self.close_connection = True
                    raise HTTPError(400, "expected multipart/form-data")
                deadline = time.time() + service.cfg.request_timeout_s
                with tempfile.TemporaryDirectory() as spool:
                    parts = parse_multipart_stream(
                        self.rfile.read, length, ctype, spool_dir=spool,
                        spool_threshold=service.cfg.spool_threshold_bytes)
                    if self.path == "/interpolate-frames":
                        self._send_json(service.interpolate_frames(parts))
                        return
                    if self.path == "/evaluate-interpolation":
                        self._send_json(
                            service.evaluate_interpolation(parts))
                        return
                    if self.path == "/interpolate-video":
                        blob, fname = service.interpolate_video(
                            parts, deadline=deadline)
                    else:
                        blob, fname = service.interpolate(parts)
            except HTTPError as e:
                self._send_json({"detail": e.detail}, e.status,
                                extra_headers=e.headers)
                return
            except Exception as e:  # 500 mapping (api/app.py:193-195)
                self._send_json({"detail": f"internal error: {e}"}, 500)
                return
            # try/finally (close() is idempotent) rather than `with blob:`
            # around the stream alone: a BrokenPipeError inside
            # send_response/send_header would otherwise leak the payload's
            # temp directory, created above but not yet entered
            try:
                self.send_response(200)
                self.send_header("Content-Type", "video/mp4")
                self.send_header("Content-Disposition",
                                 f'attachment; filename="{fname}"')
                size = (blob.size if isinstance(blob, FilePayload)
                        else len(blob))
                self.send_header("Content-Length", str(size))
                self.send_header("Access-Control-Allow-Origin", "*")
                self.end_headers()
                if isinstance(blob, FilePayload):
                    # stream from disk in chunks: RSS stays flat no matter
                    # how large the output clip is
                    for chunk in blob.chunks():
                        self.wfile.write(chunk)
                else:
                    self.wfile.write(blob)
            finally:
                if isinstance(blob, FilePayload):
                    blob.close()

    return Handler


class Server:
    """Owns the ThreadingHTTPServer; start()/serve_forever()/shutdown()."""

    def __init__(self, engine, cfg: ServeConfig = ServeConfig(),
                 resolution: Tuple[int, int] = (256, 256)):
        self.service = InterpolationService(engine, cfg, resolution)
        self.httpd = ThreadingHTTPServer((cfg.host, cfg.port),
                                         make_handler(self.service))
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start_background(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        self.service.batcher.close()


def warmup(engine, resolution: Tuple[int, int] = (256, 256),
           num: int = 3) -> float:
    """Run the serving path once before the first request: on the card this
    builds and loads the kernels it launches (the startup check the
    reference lacks, ``api/app.py:225-234``). Returns the seconds taken."""
    t0 = time.time()
    c = engine.cfg.channels
    z = np.zeros((*resolution, c), np.uint8)
    engine.generate_intermediate_frames(z, z, num)
    return time.time() - t0
