"""Warm inference engine with recursive midpoint bisection (JAX
``infer/engine.py``).

uint8 NHWC frame pairs go in and come out, as in the JAX engine. Inside:
normalize in the compute dtype, edge-pad to ``cfg.pad_multiple``, the model
in NCHW, crop, round to uint8. The U-Net family bisects; the flow family
runs one motion pass and then samples each output time exactly, through
the ``sample_fused`` and ``refine_head`` CUDA kernels on the card. PyTorch
runs eagerly, so the JAX engine's per-shape compile cache becomes a cache
of pair functions.
"""

from __future__ import annotations

import math
from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..config import ModelConfig
from ..models import build_model, core_t
from ..models.bridge import flax_to_state_dict
from ..models.unet import fold_batchnorm
from ..ops import warp_fused
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
    the JAX engine's choice, which a TPU measurement made: on the H100 the
    option core is slower than the default route (11-12% at b8 1080p,
    about 3% at b32; ``PERF.md``), so ``"auto"`` is not a speed setting on
    the card.
    """

    def __init__(self, model: torch.nn.Module,
                 state: Optional[Mapping[str, torch.Tensor]] = None,
                 compute_dtype=torch.bfloat16, fold: bool = True,
                 device=None, core_impl: str = "xla"):
        if core_impl not in _CORE_IMPLS:
            raise ValueError(f"core_impl must be one of {_CORE_IMPLS}; got "
                             f"{core_impl!r}")
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
        if core_impl != "xla" and self._core_applies():
            self.model.pack_core()      # the core kernels' weight layouts
        # Cap on the batch one dispatch sees (None = off); larger batches
        # run as sequential chunks, concatenated on the device.
        self.max_dispatch_batch: Optional[int] = None
        self._fn_cache: dict = {}

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
