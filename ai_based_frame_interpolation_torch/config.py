"""Configuration dataclasses of the PyTorch port.

The port keeps its own copy of the JAX package's ``ModelConfig`` and
``ServeConfig`` with the same field names and defaults, so one
``model_config.json`` means the same model on both sides. The comments on
each field say what it selects; the JAX package's ``config.py`` holds the
measurements behind the defaults.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """Model architecture knobs (defaults: the reference's deployed U-Net,
    2 gray frames in, 1 out, widths 64..1024, 17,262,401 parameters)."""

    arch: str = "unet"          # "unet" | "tower" | "flow"
    channels: int = 1           # channels per frame: 1 gray, 3 RGB
    in_frames: int = 2          # frames concatenated on the channel axis
    base_width: int = 64        # width of the first encoder stage
    depth: int = 4              # number of down/up levels
    bilinear: bool = True       # bilinear decoder vs 2x2 transposed conv
    # decoder upsample grid: "align_corners" (reference nn.Upsample
    # semantics) or "half_pixel" (F.interpolate(align_corners=False))
    upsample: str = "align_corners"
    time_conditioned: bool = False  # append a constant-t input channel
    # space-to-depth stem: the U-Net runs at (H/r, W/r) with r*r x channels
    space_to_depth: int = 1
    # predict the correction to the linear midpoint (f1+f2)/2
    residual: bool = False
    # width of the full-resolution refinement head after an s2d U-Net
    # (0 = off)
    refine_width: int = 0
    # depthwise 3x3 + pointwise 1x1 in place of the head's dense 3x3 conv2
    refine_depthwise: bool = False
    # rearrange factor at which the refinement head runs (1 = full res)
    refine_factor: int = 1
    # tower family: 1x1 projections of the fused skips
    slim_decoder: bool = False
    # flow family: backbone at 1/flow_scale resolution
    flow_scale: int = 1
    # flow family: two independent motion fields
    flow_bidir: bool = False
    # flow family: residual field-refinement stages
    flow_cascade: int = 0
    # flow family: backward warp strategy
    warp_impl: str = "shifts"
    # flow family: per-axis displacement bound of the shifts warp (px)
    max_flow: int = 32

    @property
    def in_channels(self) -> int:
        r2 = self.space_to_depth ** 2
        return (self.in_frames * self.channels * r2 +
                (1 if self.time_conditioned else 0))

    @property
    def out_channels(self) -> int:
        return self.channels * self.space_to_depth ** 2

    @property
    def pad_multiple(self) -> int:
        return max(self.space_to_depth, self.flow_scale) * 2 ** self.depth


@dataclass(frozen=True)
class ServeConfig:
    """Serving knobs (reference ``api/app.py``)."""

    host: str = "0.0.0.0"
    port: int = 8000
    model_path: str = "checkpoints"
    max_upload_bytes: int = 50 * 1024 * 1024
    max_intermediate: int = 10
    request_timeout_s: float = 300.0
    max_video_queue: int = 3
    spool_threshold_bytes: int = 1024 * 1024
    # continuous request batching (serve/batcher.py): at most max_batch
    # requests per dispatch, after an optional straggler wait
    max_batch: int = 8
    batch_window_ms: float = 0.0


def replace(cfg, **kwargs):
    """Functional update helper (frozen dataclasses)."""
    return dataclasses.replace(cfg, **kwargs)
