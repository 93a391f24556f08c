"""Streaming video decode and encode on the host (JAX ``data/video.py``).

Frames stream through with constant host memory whatever the clip's
length; the async variants decode ahead and encode behind in a thread, so
decode, device work and encode overlap. OpenCV (``cv2.VideoCapture``,
``cv2.VideoWriter`` with the mp4v codec) is the only backend, imported when
a reader or writer opens a file: without it, opening one raises an
``ImportError`` that names it. Elsewhere the port uses OpenCV only for
the Farneback baseline and for image formats other than PNG.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Optional

import numpy as np


def _opencv():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("video files are read and written through OpenCV "
                          "(the cv2 module), which is not installed") from e
    return cv2


class VideoReader:
    """Iterate RGB (or grayscale) HWC uint8 frames from a video file."""

    def __init__(self, path: str, grayscale: bool = False):
        cv2 = _opencv()
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self._cv2 = cv2
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise IOError(f"could not open video: {path}")
        self.fps = float(self.cap.get(cv2.CAP_PROP_FPS)) or 30.0
        self.width = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.frame_count = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.grayscale = grayscale

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            ok, frame = self.cap.read()
            if not ok:
                break
            if self.grayscale:
                yield self._cv2.cvtColor(frame,
                                         self._cv2.COLOR_BGR2GRAY)[..., None]
            else:
                yield frame[:, :, ::-1]  # BGR -> RGB
        self.cap.release()

    def close(self):
        self.cap.release()


class AsyncVideoReader(VideoReader):
    """VideoReader with a thread that keeps ``max_queue`` frames decoded
    ahead of the consumer."""

    def __init__(self, path: str, grayscale: bool = False,
                 max_queue: int = 32):
        super().__init__(path, grayscale=grayscale)
        self._q: "queue.Queue[Optional[np.ndarray]]" = queue.Queue(max_queue)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        try:
            for frame in VideoReader.__iter__(self):
                self._q.put(frame)
        except BaseException as e:  # noqa: BLE001 — re-raised by __iter__
            self._err = e
        finally:
            self._q.put(None)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            frame = self._q.get()
            if frame is None:
                break
            yield frame
        self._thread.join()
        if self._err is not None:
            raise self._err


class VideoWriter:
    """Write RGB or grayscale HWC uint8 frames to an MP4, streaming."""

    def __init__(self, path: str, fps: float = 30.0, codec: str = "mp4v"):
        self.path = path
        self.fps = fps
        self.codec = codec
        self._writer = None
        self.frames_written = 0

    def _open(self, h: int, w: int, color: bool):
        cv2 = _opencv()
        self._cv2 = cv2
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        fourcc = cv2.VideoWriter_fourcc(*self.codec)
        # a gray stream is encoded as it is (isColor=False), without a
        # GRAY -> BGR conversion per frame
        self._writer = cv2.VideoWriter(self.path, fourcc, self.fps, (w, h),
                                       isColor=color)
        self._color = color
        if not self._writer.isOpened():
            raise IOError(f"could not open video writer: {self.path}")

    def write(self, frame: np.ndarray):
        frame = np.asarray(frame)
        if frame.ndim == 2:
            frame = frame[..., None]
        h, w = frame.shape[:2]
        if self._writer is None:
            self._open(h, w, color=frame.shape[-1] != 1)
        if frame.shape[-1] == 1:
            out = self._cv2.cvtColor(frame[..., 0], self._cv2.COLOR_GRAY2BGR) \
                if self._color else frame[..., 0]
        else:
            out = frame[:, :, ::-1]  # RGB -> BGR
        self._writer.write(np.ascontiguousarray(out))
        self.frames_written += 1

    def close(self):
        if self._writer is not None:
            self._writer.release()
            self._writer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class AsyncVideoWriter(VideoWriter):
    """VideoWriter with an encode thread: ``write`` queues the frame and
    returns; an encode error is raised by the next ``write`` or by
    ``close``."""

    def __init__(self, path: str, fps: float = 30.0, codec: str = "mp4v",
                 max_queue: int = 64):
        super().__init__(path, fps, codec)
        self._q: "queue.Queue[Optional[np.ndarray]]" = queue.Queue(max_queue)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        # after an error, keep taking frames (dropped) so that neither
        # write nor close blocks on a full queue
        while True:
            frame = self._q.get()
            if frame is None:
                return
            if self._err is not None:
                continue
            try:
                super(AsyncVideoWriter, self).write(frame)
            except BaseException as e:  # noqa: BLE001 — raised by write/close
                self._err = e

    def write(self, frame: np.ndarray):
        if self._err is not None:
            raise self._err
        self._q.put(np.asarray(frame))

    def close(self):
        self._q.put(None)
        self._thread.join()
        super().close()
        if self._err is not None:
            raise self._err
