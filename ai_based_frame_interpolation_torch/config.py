"""Configuration dataclasses of the PyTorch port.

The port keeps its own copy of the JAX package's ``ModelConfig``,
``LossConfig``, ``TrainConfig``, ``DataConfig``, ``ServeConfig``,
``VideoConfig``, ``MeshConfig`` and ``Config`` with the same field names
and defaults, so one ``model_config.json`` means the same model on both
sides. The comments on each field say what it selects; the JAX package's
``config.py`` holds the measurements behind the defaults.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


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
class LossConfig:
    """Training loss: ``mse_weight * MSE + ssim_weight * (1 - SSIM)``
    (11x11 Gaussian SSIM, sigma 1.5; reference ``model/train.py:18-87``),
    plus the optional terms below, each 0 = off and train-time only (the
    validation loss stays the plain combined loss)."""

    mse_weight: float = 0.5
    ssim_weight: float = 0.5
    ssim_window: int = 11
    ssim_sigma: float = 1.5
    # flow family: edge-aware first-order smoothness of the motion field
    flow_smooth_weight: float = 0.0
    flow_smooth_edge: float = 10.0
    # flow family: L1 between each frame and its full warp from the other
    # frame (the field grounded at both endpoints)
    flow_photo_weight: float = 0.0
    # any family: soft census distance between prediction and ground truth
    # (ops/census.py)
    census_weight: float = 0.0
    census_window: int = 7


@dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters (reference ``model/train.py:153-316``)."""

    epochs: int = 100
    batch_size: int = 8
    learning_rate: float = 1e-4
    val_split: float = 0.2
    # ReduceLROnPlateau(factor=0.5, patience=10), reference train.py:163-165
    plateau_factor: float = 0.5
    plateau_patience: int = 10
    seed: int = 0
    # EMA of the weights (0 = off); when on, validation scores and the
    # export holds the EMA weights
    ema_decay: float = 0.0
    # flips and the temporal swap of the input frames (data/loader.py)
    augment: bool = False
    # sequential microbatches per optimizer step (1 = off); batch_size must
    # divide evenly
    grad_accum: int = 1
    # epochs between "latest" (resume point) checkpoints; "best" always
    # saves on improvement
    save_every: int = 1
    loss: LossConfig = field(default_factory=LossConfig)
    checkpoint_dir: str = "checkpoints"
    resume: bool = False
    log_every: int = 10
    nan_guard: bool = True


@dataclass(frozen=True)
class DataConfig:
    """Triplet dataset layout (reference ``model/train.py:89-151``)."""

    data_dir: str = "data/train"
    height: int = 256
    width: int = 256
    prefetch: int = 2            # batches decoded ahead of the trainer
    num_workers: int = 4         # host decode threads
    shuffle_buffer: int = 2048


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


@dataclass(frozen=True)
class VideoConfig:
    """Streaming video interpolation (``InterpolationEngine``'s
    ``interpolate_video_file``)."""

    factor: int = 2              # 2x or 4x (recursive midpoint bisection)
    batch_pairs: int = 8         # frame pairs per device batch
    fps: Optional[float] = None  # None = scale source fps by factor
    codec: str = "mp4v"


@dataclass(frozen=True)
class MeshConfig:
    """Data parallelism (``parallel/``): the batch axis split over
    ``data_axis`` cards, one process each for training, one replica each
    for the engine. ``data_axis=-1`` means every visible card."""

    data_axis: int = -1
    axis_name: str = "data"


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    video: VideoConfig = field(default_factory=VideoConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)


def replace(cfg, **kwargs):
    """Functional update helper (frozen dataclasses)."""
    return dataclasses.replace(cfg, **kwargs)
