"""Optional FastAPI/ASGI flavor of the same serving contract (JAX
``serve/asgi.py``).

The stdlib server (``server.py``) is the primary path; this module lets
deployments that already run uvicorn/fastapi (like the reference,
``api/app.py:17-30``) mount the same endpoints. Import-gated: fastapi is
imported inside :func:`make_fastapi_app` only, and raises an
``ImportError`` that names the stdlib server where it is not installed.
"""

from __future__ import annotations

from typing import Tuple

from ..config import ServeConfig
from .server import HTTPError, InterpolationService, Part


def make_fastapi_app(engine, cfg: ServeConfig = ServeConfig(),
                     resolution: Tuple[int, int] = (256, 256)):
    """Build a FastAPI app mirroring ``server.py``'s endpoints.

    Raises ImportError with guidance when fastapi isn't installed.
    """
    try:
        from fastapi import FastAPI, File, Form, HTTPException, UploadFile
        from fastapi.middleware.cors import CORSMiddleware
        from fastapi.responses import StreamingResponse
        from starlette.background import BackgroundTask
    except ImportError as e:
        raise ImportError(
            "fastapi is not installed; use the stdlib server "
            "(ai_based_frame_interpolation_torch.serve.server.Server) instead"
        ) from e

    service = InterpolationService(engine, cfg, resolution)
    app = FastAPI(title="ai-based-frame-interpolation-tpu")
    app.add_middleware(CORSMiddleware, allow_origins=["*"],
                       allow_methods=["*"], allow_headers=["*"])

    @app.get("/")
    def index():
        return service.index()

    @app.get("/health")
    def health():
        return service.health()

    @app.get("/model-info")
    def model_info():
        return service.model_info()

    @app.post("/interpolate")
    async def interpolate(frame1: UploadFile = File(...),
                          frame2: UploadFile = File(...),
                          num_intermediate: int = Form(3),
                          fps: int = Form(30)):
        parts = {
            "frame1": Part("frame1", frame1.filename, frame1.content_type,
                           await frame1.read()),
            "frame2": Part("frame2", frame2.filename, frame2.content_type,
                           await frame2.read()),
            "num_intermediate": Part("num_intermediate", None, None,
                                     str(num_intermediate).encode()),
            "fps": Part("fps", None, None, str(fps).encode()),
        }
        try:
            payload, fname = service.interpolate(parts)
        except HTTPError as e:
            raise HTTPException(e.status, e.detail)

        def _stream():
            yield from payload.chunks()

        # cleanup rides the response's background task, NOT generator
        # finalization: a StreamingResponse whose generator is closed
        # before its first iteration (client disconnect mid-headers)
        # never enters the generator body, which would leak the temp dir.
        # close() is idempotent.
        return StreamingResponse(_stream(), media_type="video/mp4", headers={
            "Content-Length": str(payload.size),
            "Content-Disposition": f'attachment; filename="{fname}"'},
            background=BackgroundTask(payload.close))

    @app.post("/interpolate-video")
    async def interpolate_video(video: UploadFile = File(...),
                                factor: int = Form(2),
                                fps: int = Form(0),
                                target_fps: float = Form(0.0)):
        parts = {
            "video": Part("video", video.filename, video.content_type,
                          await video.read()),
            "factor": Part("factor", None, None, str(factor).encode()),
            "fps": Part("fps", None, None, str(fps).encode()),
            "target_fps": Part("target_fps", None, None,
                               str(target_fps).encode()),
        }
        try:
            payload, fname = service.interpolate_video(parts)
        except HTTPError as e:
            raise HTTPException(e.status, e.detail)

        def _stream():
            # FilePayload: stream from disk; dir removal is the response's
            # background task (see /interpolate above)
            yield from payload.chunks()

        return StreamingResponse(_stream(), media_type="video/mp4", headers={
            "Content-Length": str(payload.size),
            "Content-Disposition": f'attachment; filename="{fname}"'},
            background=BackgroundTask(payload.close))

    return app
