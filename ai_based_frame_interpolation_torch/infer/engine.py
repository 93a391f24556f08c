"""Warm inference engine with recursive midpoint bisection (JAX
``infer/engine.py``).

uint8 NHWC frame pairs go in and come out, as in the JAX engine. Inside:
normalize in the compute dtype, edge-pad to ``cfg.pad_multiple``, the model
in NCHW, crop, round to uint8. The U-Net and tower families bisect; the
flow family runs one motion pass and then samples each output time
exactly, through the ``sample_fused`` and ``refine_head`` CUDA kernels on
the card. PyTorch runs eagerly, so the JAX engine's per-shape compile
cache becomes a cache of pair functions.

Video streams (``interpolate_video_frames``, ``retime_video_frames`` and
their ``_file`` forms) batch consecutive pairs, assemble the output on
the host (``ops/native.py``) and, for 2x/4x, queue batch k+1 on the card
before they drain batch k (``_Transfers``).
"""

from __future__ import annotations

import math
import time
from typing import Iterable, Iterator, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..config import ModelConfig
from ..models import build_model, core_t
from ..models.bridge import flax_to_state_dict
from ..models.unet import fold_batchnorm
from ..ops import native, warp_fused
from ..ops.image import denormalize_to_uint8, normalize_uint8
from ..ops.resize import crop_to, pad_to_multiple


_CORE_IMPLS = ("xla", "auto", "pallas")


def resolve_device(device=None) -> torch.device:
    """``device``, or the CUDA card when none is given. Nothing falls back
    to the CPU: without a card the caller must ask for ``"cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port on the CPU")
    return torch.device("cuda")


def _bisect(fwd, model, x1, x2, depth: int) -> List[torch.Tensor]:
    """All 2**depth - 1 intermediates between x1 and x2, in time order."""
    if depth == 0:
        return []
    mid = fwd(model, x1, x2)
    return (_bisect(fwd, model, x1, mid, depth - 1) + [mid] +
            _bisect(fwd, model, mid, x2, depth - 1))


def _init_weights(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Flax's default init drawn from ``generator``: LeCun-normal conv
    kernels (normal truncated at 2 sigma, rescaled to variance 1/fan_in),
    zero biases, BatchNorm scale 1, bias 0, mean 0, var 1."""
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            w = m.weight
            fan_in = w[0].numel() if isinstance(m, torch.nn.Conv2d) \
                else w.shape[0] * w[0, 0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                        generator=generator)
            if m.bias is not None:
                torch.nn.init.zeros_(m.bias)
        elif isinstance(m, torch.nn.BatchNorm2d):
            m.reset_parameters()


class _Transfers:
    """One video stream's host <-> device copies, through pinned host
    buffers, two a direction: one for each batch the stream has in flight.

    :meth:`upload` stacks frames into a pinned buffer and queues the copy
    to the card on the current stream, without waiting. :meth:`download`
    copies a batch's output into a pinned buffer on a side stream once the
    batch's own event (:meth:`mark`) has fired, and waits for that copy
    alone, so the next batch keeps the card busy meanwhile. A buffer is
    reused two calls later, after the copy that last used it, so what a
    call returns stays valid until the second call after it. On the CPU
    both are numpy <-> tensor views.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self._side = torch.cuda.Stream(device) if self.cuda else None
        self._slots = {"up": [[None, None], [None, None]],
                       "down": [[None, None], [None, None]]}
        self._turn = {"up": 0, "down": 0}

    def _buffer(self, way: str, shape: tuple):
        """The next pinned buffer of ``way``, viewed as ``shape``, once its
        last copy is done, and a fresh event for the copy that uses it."""
        i = self._turn[way]
        self._turn[way] = 1 - i
        slot = self._slots[way][i]
        if slot[1] is not None:
            slot[1].synchronize()
        n = math.prod(shape)
        if slot[0] is None or slot[0].numel() < n:
            slot[0] = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        slot[1] = torch.cuda.Event()
        return slot[0][:n].view(shape), slot[1]

    def upload(self, frames: Sequence[np.ndarray]):
        """(host array, device tensor) of the uint8 HWC ``frames`` stacked
        on a new leading axis."""
        if not self.cuda:
            host = np.stack(frames)
            return host, torch.from_numpy(host)
        buf, event = self._buffer("up", (len(frames), *np.shape(frames[0])))
        host = buf.numpy()
        np.stack(frames, out=host)
        dev = buf.to(self.device, non_blocking=True)
        event.record()
        return host, dev

    def mark(self) -> Optional[torch.cuda.Event]:
        """An event at this point of the current stream (None on the CPU)."""
        if not self.cuda:
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    def download(self, out: torch.Tensor, done) -> np.ndarray:
        """``out`` on the host, copied once ``done`` has fired."""
        if not self.cuda:
            return out.numpy()
        buf, event = self._buffer("down", tuple(out.shape))
        self._side.wait_event(done)
        with torch.cuda.stream(self._side):
            buf.copy_(out, non_blocking=True)
            event.record()
        event.synchronize()
        return buf.numpy()


class InterpolationEngine:
    """Load-once, serve-forever interpolation engine.

    ``fold=True`` (default) folds inference-mode BatchNorm into the conv
    weights (``models.unet.fold_batchnorm``). ``device=None`` means the
    CUDA card and raises without one. ``model`` is a module of either
    ported family (``models.build_model``).

    ``core_impl`` selects the U-Net core, as in the JAX engine: ``"xla"``
    (the default) runs the model's own forward (cuDNN convs); ``"auto"``
    runs the option core (``models/core_t.py``: the outer DoubleConv blocks
    on the ``double_conv`` kernels) on the card where ``core_t.eligible``
    holds; ``"pallas"`` forces it, raises where it does not apply, and on
    the CPU runs the kernels' plain versions. Both need folded weights and
    a full-resolution head, and are followed by the head. ``"auto"`` copies
    the JAX engine's choice, which a TPU measurement made. On an NVIDIA
    H100 80GB HBM3 at 700.00 W, ``chip_smoke.py`` read 1111.1 output fps on
    the option core against 1072.3 on the default route at b8 1080p gray
    2x, and 1225.0 against 1079.6 at b32 (``PERF.md``). The route may be
    assigned after construction (:attr:`core_impl`).
    """

    def __init__(self, model: torch.nn.Module,
                 state: Optional[Mapping[str, torch.Tensor]] = None,
                 compute_dtype=torch.bfloat16, fold: bool = True,
                 device=None, core_impl: str = "xla"):
        self.device = resolve_device(device)
        cfg = model.cfg
        state = dict(state if state is not None else model.state_dict())
        if fold and not model.folded:
            state = fold_batchnorm(state)
            model = build_model(cfg, compute_dtype, folded=True)
        elif model.compute_dtype != compute_dtype:
            model = build_model(cfg, compute_dtype, folded=model.folded)
        model.load_state_dict(state)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.model.pack_head()          # the head kernel's weight layouts
        self.cfg: ModelConfig = cfg
        self.compute_dtype = compute_dtype
        self.core_impl = core_impl
        # Cap on the batch one dispatch sees (None = off); larger batches
        # run as sequential chunks, concatenated on the device.
        self.max_dispatch_batch: Optional[int] = None
        self._fn_cache: dict = {}

    @property
    def core_impl(self) -> str:
        """The U-Net core route (class docstring). Pair functions read it at
        call time, so it may be assigned after construction, as the JAX
        engine's is: the setter validates the value and, for ``"auto"`` or
        ``"pallas"`` where the core applies, packs the core kernels' weight
        layouts once."""
        return self._core_impl

    @core_impl.setter
    def core_impl(self, value: str) -> None:
        if value not in _CORE_IMPLS:
            raise ValueError(f"core_impl must be one of {_CORE_IMPLS}; got "
                             f"{value!r}")
        if value != "xla" and self._core_applies() \
                and self.model.packed_core is None:
            self.model.pack_core()
        self._core_impl = value

    @property
    def variables(self) -> torch.nn.Module:
        """The module holding the weights: pair functions take it first,
        where the JAX engine's take the variables tree."""
        return self.model

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # -- factories ---------------------------------------------------------

    @classmethod
    def random_init(cls, cfg: Optional[ModelConfig] = None, seed: int = 0,
                    compute_dtype=torch.bfloat16, fold: bool = True,
                    device=None, core_impl: str = "xla"
                    ) -> "InterpolationEngine":
        """Engine with random weights from ``seed`` (plumbing and speed
        runs). The numbers differ from JAX's for the same seed."""
        cfg = cfg or ModelConfig()
        model = build_model(cfg, compute_dtype)
        _init_weights(model, torch.Generator().manual_seed(seed))
        return cls(model, None, compute_dtype, fold=fold, device=device,
                   core_impl=core_impl)

    @classmethod
    def from_checkpoint(cls, path: str, cfg: Optional[ModelConfig] = None,
                        compute_dtype=torch.bfloat16, fold: bool = True,
                        device=None, core_impl: str = "xla"
                        ) -> "InterpolationEngine":
        """Engine over an inference export of the port's trainer
        (``train/checkpoint.py:save_variables``: ``variables.pt`` and
        ``model_config.json``) or a reference-format ``.pth`` (or ``.pt``;
        ``train/checkpoint.py:import_pth``), folded and packed as
        ``__init__`` does; ``cfg`` overrides the export's config. A
        ``.pth`` without ``cfg`` implies the reference's config, with the
        channels, width, depth and decoder its weights have
        (``pth_config``)."""
        import os

        from ..train.checkpoint import import_pth, load_variables, pth_config

        if path.endswith((".pth", ".pt")):
            variables = import_pth(path, cfg)
            cfg = cfg or pth_config(variables)
        elif (os.path.exists(os.path.join(path, "variables.pt")) or
              os.path.exists(os.path.join(path, "model_config.json"))):
            variables, loaded_cfg = load_variables(path)
            cfg = cfg or loaded_cfg or ModelConfig()
        else:
            raise FileNotFoundError(
                f"no checkpoint at {path} (expected a .pth file or a "
                "directory with variables.pt, written by save_variables)")
        return cls(build_model(cfg, compute_dtype), variables, compute_dtype,
                   fold=fold, device=device, core_impl=core_impl)

    @classmethod
    def from_flax_variables(cls, variables: Mapping, cfg: ModelConfig,
                            compute_dtype=torch.bfloat16, fold: bool = True,
                            device=None, core_impl: str = "xla"
                            ) -> "InterpolationEngine":
        """Engine over a Flax variables tree given as numpy arrays
        (``models/bridge.py``)."""
        folded = not variables.get("batch_stats")
        model = build_model(cfg, compute_dtype, folded=folded)
        return cls(model, flax_to_state_dict(variables), compute_dtype,
                   fold=fold, device=device, core_impl=core_impl)

    # -- the pair function --------------------------------------------------

    def _core_applies(self) -> bool:
        """The option core's model conditions: the U-Net family, folded
        weights, a full-resolution head."""
        model = self.model
        return (self.cfg.arch == "unet" and model.folded and model.has_head
                and self.cfg.refine_factor == 1)

    def _core_t_ok(self, x: torch.Tensor) -> bool:
        """Whether ``_forward`` takes the option core for padded NCHW
        frames ``x``: never under ``"xla"``; under ``"auto"`` on the card
        where ``core_t.eligible`` holds; always under ``"pallas"``, which
        raises where the core does not apply."""
        if self.core_impl == "xla":
            return False
        ok = self._core_applies() and core_t.eligible(
            self.cfg, int(x.shape[-2]), int(x.shape[-1]))
        if self.core_impl == "auto":
            return ok and x.is_cuda
        if not ok:
            raise ValueError(
                f"core_impl='pallas': the option core does not take this "
                f"model and shape ({self.cfg}, frames {tuple(x.shape)}; it "
                "needs core_t.eligible, folded weights and a head at "
                "refine_factor=1)")
        return True

    def _forward(self, model, x1, x2):
        if self._core_t_ok(x1):
            y = core_t.forward_pre_refine(model, x1, x2)
            return model.refine(y, x1, x2).to(self.compute_dtype)
        return model(x1, x2).to(self.compute_dtype)

    def _pair_fn(self, n_out: int, depth: int):
        key = ("pair", n_out, depth)
        if key not in self._fn_cache:
            self._fn_cache[key] = self._chunk_batches(
                self._build_pair_fn(n_out, depth))
        return self._fn_cache[key]

    def _chunk_batches(self, fn):
        """Honour ``max_dispatch_batch``: split a larger batch into
        sequential chunks and concatenate the results."""

        def wrapper(model, f1_u8, f2_u8):
            limit = self.max_dispatch_batch
            b = int(f1_u8.shape[0])
            if not limit or b <= limit:
                return fn(model, f1_u8, f2_u8)
            return torch.cat([fn(model, f1_u8[i:i + limit],
                                 f2_u8[i:i + limit])
                              for i in range(0, b, limit)], 0)

        return wrapper

    def _prep(self, f_u8: torch.Tensor):
        """uint8 [B,H,W,C] -> (padded NCHW frames in the compute dtype,
        the unpadded (H, W))."""
        return pad_to_multiple(normalize_uint8(f_u8.permute(0, 3, 1, 2),
                                               self.compute_dtype),
                               self.cfg.pad_multiple)

    def _flow_sample(self, model, x1, x2, flow, mask, t):
        """One sample at times ``t`` [B] from a precomputed field: the
        sampler, then the head (on the card the ``sample_fused`` and
        ``refine_head`` kernels, which launch or raise)."""
        if not warp_fused.eligible(self.cfg, x1.permute(0, 2, 3, 1).shape):
            raise ValueError(f"the flow sampler does not take frames of "
                             f"shape {tuple(x1.shape)} (NCHW)")
        return model.sample(x1, x2, flow, mask, t)

    def _build_pair_fn(self, n_out: int, depth: int):
        """uint8 [B,H,W,C] pair -> uint8 [B, n_out, H, W, C].

        U-Net family: ``n_out`` of the 2**depth - 1 dyadic intermediates,
        at the times nearest to i/(n_out+1) (exact when n_out+1 is a power
        of two). Flow family: one motion pass, then ``n_out`` samples at
        the exact times i/(n_out+1); ``depth`` is ignored."""
        cdt = self.compute_dtype
        if self.cfg.arch == "flow":

            def flow_fn(model, f1_u8, f2_u8):
                with torch.inference_mode():
                    x1, hw = self._prep(f1_u8)
                    x2, _ = self._prep(f2_u8)
                    flow, mask = model.motion(x1, x2)
                    outs = []
                    for i in range(n_out):
                        t = torch.full((x1.shape[0],), (i + 1) / (n_out + 1),
                                       dtype=torch.float32, device=x1.device)
                        y = self._flow_sample(model, x1, x2, flow, mask, t)
                        outs.append(crop_to(y.to(cdt), hw))
                    out = denormalize_to_uint8(torch.stack(outs, 1))
                    return out.permute(0, 1, 3, 4, 2)

            return flow_fn
        total = 2 ** depth - 1
        if n_out == total:
            idx = list(range(total))
        else:
            idx = [min(total - 1, round((i + 1) * (total + 1) / (n_out + 1)) - 1)
                   for i in range(n_out)]

        def fn(model, f1_u8, f2_u8):
            with torch.inference_mode():
                x1, hw = self._prep(f1_u8)
                x2, _ = self._prep(f2_u8)
                mids = _bisect(self._forward, model, x1, x2, depth)
                out = torch.stack([crop_to(mids[i], hw) for i in idx], 1)
                return denormalize_to_uint8(out).permute(0, 1, 3, 4, 2)

        return fn

    def _time_fn(self, n_t: int):
        key = ("time", n_t)
        if key not in self._fn_cache:
            self._fn_cache[key] = self._build_time_fn(n_t)
        return self._fn_cache[key]

    def _build_time_fn(self, n_t: int):
        """uint8 pair batch and times ``ts`` ([n_t], or [n_t, B] for a time
        per pair) -> uint8 [B, n_t, H, W, C]: one motion pass for the flow
        family, one forward per time for a ``time_conditioned`` U-Net."""
        cdt = self.compute_dtype
        is_flow = self.cfg.arch == "flow"

        def fn(model, f1_u8, f2_u8, ts):
            with torch.inference_mode():
                x1, hw = self._prep(f1_u8)
                x2, _ = self._prep(f2_u8)
                b = x1.shape[0]
                if is_flow:
                    flow, mask = model.motion(x1, x2)
                outs = []
                for i in range(n_t):
                    t = ts[i].to(torch.float32).expand(b).contiguous()
                    if is_flow:
                        y = self._flow_sample(model, x1, x2, flow, mask, t)
                    else:
                        y = model(x1, x2, t=t)
                    outs.append(crop_to(y.to(cdt), hw))
                out = denormalize_to_uint8(torch.stack(outs, 1))
                return out.permute(0, 1, 3, 4, 2)

        return fn

    def _tower_stream_fn(self):
        key = ("tower_stream",)
        if key not in self._fn_cache:
            self._fn_cache[key] = self._build_tower_stream_fn()
        return self._fn_cache[key]

    def _build_tower_stream_fn(self):
        """Tower stream step: uint8 [K,H,W,C] consecutive frames -> uint8
        [K-1,H,W,C] midpoints, each frame encoded once (the pyramids of
        pair (i, i+1) are slices of one batched encode)."""
        cdt = self.compute_dtype

        def fn(model, frames_u8):
            with torch.inference_mode():
                x, hw = self._prep(frames_u8)
                feats = model.encode(x)
                y = model.decode([f[:-1] for f in feats],
                                 [f[1:] for f in feats], x[:-1], x[1:])
                return denormalize_to_uint8(crop_to(y.to(cdt), hw)) \
                    .permute(0, 2, 3, 1)

        return fn

    def _stream(self, frames: Iterable[np.ndarray], batch_pairs: int,
                step) -> Iterator[np.ndarray]:
        """Playback-order output of ``frames`` through batches of
        ``batch_pairs`` consecutive pairs: ``step`` maps a batch's P+1
        frames on the device to its in-betweens, uint8 [P, K, H, W, C]. The
        trailing original of a batch is held back (it opens the next
        batch); batch k+1 is queued on the device before batch k is
        drained; a single frame passes through."""
        io = _Transfers(self.device)

        def dispatch(run: List[np.ndarray]):
            host, dev = io.upload(run)
            return host, step(dev), io.mark()

        def emit(batch, final: bool):
            host, out, done = batch
            stream = native.interleave(host, io.download(out, done))
            end = len(stream) if final else len(stream) - 1
            for i in range(end):
                yield stream[i]

        run: List[np.ndarray] = []
        in_flight = None
        for frame in frames:
            run.append(np.asarray(frame))
            if len(run) == batch_pairs + 1:
                batch = dispatch(run)             # dispatch k+1 ...
                run = [run[-1]]
                if in_flight is not None:
                    yield from emit(in_flight, final=False)  # ... drain k
                in_flight = batch
        if len(run) >= 2:
            batch = dispatch(run)
            if in_flight is not None:
                yield from emit(in_flight, final=False)
            in_flight = batch
        if in_flight is not None:
            yield from emit(in_flight, final=True)
        elif run:
            yield run[0]                          # 1-frame passthrough

    # -- public API ---------------------------------------------------------

    @property
    def supports_exact_time(self) -> bool:
        """True when the model samples arbitrary times in one shot (the
        flow family by construction, or a ``time_conditioned`` U-Net)."""
        return self.cfg.time_conditioned or self.cfg.arch == "flow"

    def interpolate_at(self, f1: np.ndarray, f2: np.ndarray,
                       times: Sequence[float]) -> List[np.ndarray]:
        """HWC uint8 frames at the given times in (0, 1), in that order."""
        if not self.supports_exact_time:
            raise ValueError(
                "interpolate_at requires a time_conditioned model; "
                "use generate_intermediate_frames (bisection) instead")
        ts = torch.tensor(list(times), dtype=torch.float32, device=self.device)
        out = self._time_fn(len(times))(self.model, self._put(f1[None]),
                                        self._put(f2[None]), ts)
        out = out[0].cpu().numpy()
        return [out[i] for i in range(len(times))]

    def interpolate_pair(self, f1: np.ndarray, f2: np.ndarray) -> np.ndarray:
        """Midpoint between two HWC uint8 frames -> HWC uint8."""
        return self.interpolate_batch(f1[None], f2[None])[0]

    def interpolate_batch(self, f1: np.ndarray, f2: np.ndarray) -> np.ndarray:
        """Batched midpoints: [B,H,W,C] u8 x2 -> [B,H,W,C] u8."""
        out = self._pair_fn(1, 1)(self.model, self._put(f1), self._put(f2))
        return out[:, 0].cpu().numpy()

    def generate_intermediate_frames(self, f1: np.ndarray, f2: np.ndarray,
                                     num: int) -> List[np.ndarray]:
        """``num`` in-between HWC uint8 frames in time order: by recursive
        midpoint bisection (U-Net family), or sampled at the exact times
        i/(num+1) from one motion pass (flow family)."""
        if num < 1:
            raise ValueError("num must be >= 1")
        depth = max(1, math.ceil(math.log2(num + 1)))
        out = self._pair_fn(num, depth)(self.model, self._put(f1[None]),
                                        self._put(f2[None]))
        out = out[0].cpu().numpy()
        return [out[i] for i in range(num)]

    def interpolate_video_frames(
            self, frames: Iterable[np.ndarray], factor: int = 2,
            batch_pairs: int = 8) -> Iterator[np.ndarray]:
        """Stream-interpolate a frame iterable to ``factor``x frame rate.

        Yields f0, m0_1.., f1, m1_1.., ..., fN: each consecutive pair
        contributes ``factor - 1`` in-betweens. Any integer ``factor >= 2``:
        the flow family samples the exact times i/factor; bisection models
        are exact for powers of two and take the nearest dyadic times
        otherwise (``_pair_fn``). Pairs go to the device ``batch_pairs`` at
        a time (split further by ``max_dispatch_batch``). The tower family
        at 2x encodes each frame once (``_tower_stream_fn``)."""
        if factor < 2:
            raise ValueError("factor must be an integer >= 2")
        if self.cfg.arch == "tower" and factor == 2:
            fn = self._tower_stream_fn()
            yield from self._stream(frames, batch_pairs,
                                    lambda x: fn(self.model, x)[:, None])
            return
        depth = max(1, math.ceil(math.log2(factor)))
        fn = self._pair_fn(factor - 1, depth)
        yield from self._stream(frames, batch_pairs,
                                lambda x: fn(self.model, x[:-1], x[1:]))

    def interpolate_video_file(self, in_path: str, out_path: str,
                               factor: int = 2, batch_pairs: int = 8,
                               fps: Optional[float] = None,
                               progress: bool = False,
                               deadline: Optional[float] = None) -> dict:
        """Decode -> interpolate -> encode, all streaming (OpenCV,
        ``data/video.py``). Returns stats. ``deadline`` (absolute
        ``time.time()``) stops the job between output frames with
        ``TimeoutError``; work already queued on the device completes.
        ``progress`` is accepted for the JAX signature and unused, as
        there."""
        from ..data.video import AsyncVideoReader, AsyncVideoWriter

        reader = AsyncVideoReader(in_path, grayscale=self.cfg.channels == 1)
        out_fps = fps if fps is not None else reader.fps * factor
        t0 = time.time()
        n_out = 0
        with AsyncVideoWriter(out_path, fps=out_fps) as writer:
            for frame in self.interpolate_video_frames(
                    iter(reader), factor=factor, batch_pairs=batch_pairs):
                if deadline is not None and time.time() > deadline:
                    raise TimeoutError(
                        f"video job exceeded its deadline after {n_out} "
                        f"output frames")
                writer.write(frame)
                n_out += 1
        dt = time.time() - t0
        return {"input_frames": reader.frame_count, "output_frames": n_out,
                "output_fps": out_fps, "seconds": dt,
                "frames_per_second": n_out / dt if dt > 0 else float("inf")}

    def retime_video_frames(self, frames: Iterable[np.ndarray], rate: float,
                            eps: float = 1e-6,
                            batch_pairs: int = 8) -> Iterator[np.ndarray]:
        """Resample a frame stream's timeline by ``rate`` (output/input
        frame-count ratio; 24->60 fps is ``rate=2.5``).

        Output frame k sits at input time k/rate: where that lands within
        ``eps`` after an input frame, the original passes through;
        otherwise the exact time is synthesized. ``batch_pairs`` pairs go
        to the device in one call, each with its own times, padded to the
        batch's largest count (the last time repeated; dropped on output).
        Needs an exact-time model (``supports_exact_time``)."""
        if rate <= 0:
            raise ValueError("rate must be positive")
        if not self.supports_exact_time:
            raise ValueError(
                "retiming requires exact-time sampling: use --arch flow or "
                "a time_conditioned model (bisection models only support "
                "integer factors)")
        it = iter(frames)
        prev = next(it, None)
        if prev is None:
            return
        io = _Transfers(self.device)
        k = 0          # next output index
        i = 0          # current pair is (frame i, frame i+1)
        jobs: List[tuple] = []   # (f1, f2, originals first, times)

        def flush():
            """One device call for every queued pair that needs frames,
            then the whole group in time order."""
            need = [j for j in jobs if j[3]]
            mids = {}
            if need:
                m = max(len(j[3]) for j in need)
                tmat = np.stack([np.asarray(
                    j[3] + [j[3][-1]] * (m - len(j[3])), np.float32)
                    for j in need], axis=1)
                _, dev = io.upload([j[0] for j in need] +
                                   [j[1] for j in need])
                out = self._time_fn(m)(
                    self.model, dev[:len(need)], dev[len(need):],
                    torch.from_numpy(tmat).to(self.device)).cpu().numpy()
                for row, j in enumerate(need):
                    mids[id(j)] = out[row]
            for j in jobs:
                for _ in range(j[2]):
                    yield j[0]
                for q in range(len(j[3])):
                    yield mids[id(j)][q]
            jobs.clear()

        for cur in it:
            ts: List[float] = []
            originals_first = 0
            while True:
                tau = k / rate
                if tau >= i + 1 - eps:
                    break
                t = tau - i
                if t <= eps and not ts:
                    originals_first += 1
                else:
                    ts.append(min(max(t, 0.0), 1.0))
                k += 1
            jobs.append((prev, cur, originals_first, ts))
            if len(jobs) >= batch_pairs:
                yield from flush()
            prev = cur
            i += 1
        yield from flush()
        if k / rate <= i + eps:   # the last input frame is an output sample
            yield prev

    def retime_video_file(self, in_path: str, out_path: str,
                          target_fps: float, batch_pairs: int = 8,
                          deadline: Optional[float] = None) -> dict:
        """Retime a clip to ``target_fps``: decode -> exact-time synthesis
        -> encode, streaming. ``deadline`` as in
        :meth:`interpolate_video_file`."""
        from ..data.video import AsyncVideoReader, AsyncVideoWriter

        reader = AsyncVideoReader(in_path, grayscale=self.cfg.channels == 1)
        in_fps = reader.fps or 30.0
        rate = target_fps / in_fps
        t0 = time.time()
        n_out = 0
        with AsyncVideoWriter(out_path, fps=target_fps) as writer:
            for frame in self.retime_video_frames(iter(reader), rate,
                                                  batch_pairs=batch_pairs):
                if deadline is not None and time.time() > deadline:
                    raise TimeoutError(
                        f"retime job exceeded its deadline after {n_out} "
                        f"output frames")
                writer.write(frame)
                n_out += 1
        dt = time.time() - t0
        return {"input_frames": reader.frame_count, "output_frames": n_out,
                "input_fps": in_fps, "output_fps": target_fps, "rate": rate,
                "seconds": dt,
                "frames_per_second": n_out / dt if dt > 0 else float("inf")}

    @staticmethod
    def linear_transition_frames(f1: np.ndarray, f2: np.ndarray,
                                 num: int) -> List[np.ndarray]:
        """Alpha-blend sequence, the comparison baseline."""
        out = []
        for i in range(1, num + 1):
            a = i / (num + 1)
            out.append(np.clip((1 - a) * f1.astype(np.float32) +
                               a * f2.astype(np.float32), 0, 255)
                       .astype(np.uint8))
        return out
