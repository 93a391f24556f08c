"""Warm inference engine with recursive midpoint bisection (JAX
``infer/engine.py``).

uint8 NHWC frame pairs go in and come out, as in the JAX engine. Inside:
normalize in the compute dtype, edge-pad to ``cfg.pad_multiple``, the model
in NCHW, crop, round to uint8. The U-Net and tower families bisect; the
flow family runs one motion pass and then samples each output time
exactly, through the ``sample_fused`` kernel where the config is the
single-field shifts warp (stock PyTorch warps otherwise) and the
``refine_head`` kernel on the card. PyTorch runs eagerly, so the JAX
engine's per-shape compile cache becomes a cache of pair functions.

Video streams (``interpolate_video_frames``, ``retime_video_frames`` and
their ``_file`` forms) batch consecutive pairs, assemble the output on
the host (``ops/native.py``) and, for 2x/4x, queue batch k+1 on the card
before they drain batch k (``_Transfers``).

Every dispatch of the model, from any entry, counts ``engine.dispatches``
and runs its host steps in the spans ``engine.upload`` (host to card),
``engine.enqueue`` (the host issuing the model's work) and
``engine.download`` (the host waiting for the output and copying it
back), and a stream's batch its interleave in ``stream.interleave``
(``utils/profiling.py``: recorded while a profiler runs, one flag check
otherwise). No span stays open across a ``yield``.

With ``mesh`` (an engine mesh, ``parallel/mesh.py``) the engine keeps a
replica of its folded weights on each card of the mesh and splits each
dispatch as JAX's ``choose_spec`` does: the batch into equal chunks, one a
card (``_over_mesh``), or, where the batch does not divide and the height
does, each model pass by rows (``_over_rows``): every card runs the pass
over its rows of the padded frames and a halo of ``halo_rows(cfg)`` more
on each side, and the rows it keeps are the whole frame's. Each chunk or
window takes the routes the engine takes at its shape, the kernels
included.
"""

from __future__ import annotations

import copy
import math
import re
import time
from typing import Iterable, Iterator, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..config import ModelConfig
from ..models import build_model, core_t
from ..models.bridge import flax_to_state_dict
from ..models.unet import fold_batchnorm, tile_params_packed
from ..ops import native, warp_fused
from ..ops.image import denormalize_to_uint8, normalize_uint8
from ..ops.resize import crop_to, pad_to_multiple
from ..parallel.sharding import choose_spec, halo_rows, put_frames, row_parts
from ..utils.profiling import annotate, count


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


def dispatch(engine, fn, arrays: Sequence[np.ndarray]) -> np.ndarray:
    """One dispatch of an entry on host arrays: each of ``arrays`` to the
    engine's device (``_put``, a pageable copy), ``fn(engine.variables,
    *tensors)``, its output back on the host, each step in its span."""
    count("engine.dispatches")
    with annotate("engine.upload"):
        xs = [engine._put(a) for a in arrays]
    with annotate("engine.enqueue"):
        out = fn(engine.variables, *xs)
    return _download(out)


def _download(out: torch.Tensor) -> np.ndarray:
    """``out`` on the host: the wait for it and the copy."""
    with annotate("engine.download"):
        return out.cpu().numpy()


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
    zero biases, BatchNorm scale 1, bias 0, mean 0, var 1; the flow
    cascade's out convs (``cascade{k}_out``) zero, as the Flax model
    initialises them."""
    for name, m in model.named_modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            w = m.weight
            fan_in = w[0].numel() if isinstance(m, torch.nn.Conv2d) \
                else w.shape[0] * w[0, 0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                        generator=generator)
            if re.fullmatch(r"cascade\d+_out", name):
                torch.nn.init.zeros_(w)
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

    ``core_pack`` g > 1 runs the U-Net family's core with g batch items
    folded into the channels (grouped convs over weights repeated per
    group, ``models/unet.py``; built once, on the device, at the first
    packed dispatch), as the JAX engine's ``core_pack``: for the bilinear
    decoder and folded weights, on dispatches whose batch is a multiple of
    g while ``max_dispatch_batch`` is too (:meth:`_use_pack`); other
    dispatches run unpacked. A packed dispatch never takes the option
    core: ``"auto"`` leaves it on cuDNN, ``"pallas"`` raises. The JAX
    package packs to fill the TPU's 128 lanes; what it gains on the card is
    measured, not assumed (``PERF.md``).

    ``mesh`` (``parallel.make_mesh`` without a process group; its first
    card replaces ``device``) splits every dispatch across the mesh's
    cards, as the JAX engine's ``mesh`` does, with one replica of the
    weights on each (module docstring). A batch the cards do not divide
    takes JAX's choice (``parallel.sharding.choose_spec``): where that is
    the frames' height, each model pass runs over row windows, one a card
    (:meth:`_over_rows`; each card computes its rows and the halo, so two
    cards at 1080p compute 1024 and 960 of the 1088 padded rows of the
    production U-Net, and the first card alone the whole frame where a
    window would hold it, as for the flow config at 1080p); where it
    replicates, the first card runs it. The
    JAX engine turns its Pallas routes off under a mesh because a Pallas
    call does not run inside its sharded program; the port's kernels run
    per card, so every route stays on.
    """

    def __init__(self, model: torch.nn.Module,
                 state: Optional[Mapping[str, torch.Tensor]] = None,
                 compute_dtype=torch.bfloat16, fold: bool = True,
                 device=None, core_impl: str = "xla", core_pack: int = 1,
                 mesh=None):
        if mesh is not None and mesh.grouped:
            raise ValueError("an engine's mesh holds this process's cards: "
                             "make_mesh(devices=...) outside a process group")
        self.mesh = mesh
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
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
        # one replica a card of the mesh, the first the engine's own model
        self.replicas = [self.model]
        for dev in (mesh.devices[1:] if mesh is not None else ()):
            replica = copy.deepcopy(self.model).to(dev)
            replica.pack_head()
            self.replicas.append(replica)
        self.cfg: ModelConfig = cfg
        self.compute_dtype = compute_dtype
        self.core_pack = int(core_pack or 1)
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
        if value != "xla" and self._core_applies():
            for model in self.replicas:
                if model.packed_core is None:
                    model.pack_core()
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
                    device=None, core_impl: str = "xla", core_pack: int = 1,
                    mesh=None) -> "InterpolationEngine":
        """Engine with random weights from ``seed`` (plumbing and speed
        runs). The numbers differ from JAX's for the same seed."""
        cfg = cfg or ModelConfig()
        model = build_model(cfg, compute_dtype)
        _init_weights(model, torch.Generator().manual_seed(seed))
        return cls(model, None, compute_dtype, fold=fold, device=device,
                   core_impl=core_impl, core_pack=core_pack, mesh=mesh)

    @classmethod
    def from_checkpoint(cls, path: str, cfg: Optional[ModelConfig] = None,
                        compute_dtype=torch.bfloat16, fold: bool = True,
                        device=None, core_impl: str = "xla",
                        core_pack: int = 1, mesh=None
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
                   fold=fold, device=device, core_impl=core_impl,
                   core_pack=core_pack, mesh=mesh)

    @classmethod
    def from_flax_variables(cls, variables: Mapping, cfg: ModelConfig,
                            compute_dtype=torch.bfloat16, fold: bool = True,
                            device=None, core_impl: str = "xla",
                            core_pack: int = 1, mesh=None
                            ) -> "InterpolationEngine":
        """Engine over a Flax variables tree given as numpy arrays
        (``models/bridge.py``)."""
        folded = not variables.get("batch_stats")
        model = build_model(cfg, compute_dtype, folded=folded)
        return cls(model, flax_to_state_dict(variables), compute_dtype,
                   fold=fold, device=device, core_impl=core_impl,
                   core_pack=core_pack, mesh=mesh)

    # -- the pair function --------------------------------------------------

    def _core_applies(self) -> bool:
        """The option core's model conditions: the U-Net family, folded
        weights, a full-resolution head."""
        model = self.model
        return (self.cfg.arch == "unet" and model.folded and model.has_head
                and self.cfg.refine_factor == 1)

    def _use_pack(self, batch: int) -> bool:
        """Whether a dispatch of ``batch`` items runs the packed core (JAX
        ``_use_pack``): ``core_pack`` g > 1, the U-Net family, the bilinear
        decoder, folded weights, ``batch`` and ``max_dispatch_batch``
        multiples of g."""
        g = self.core_pack
        if g <= 1 or self.cfg.arch != "unet" or not self.cfg.bilinear \
                or not self.model.folded:
            return False
        limit = self.max_dispatch_batch
        return not (limit and limit % g) and batch % g == 0

    def _packed_core(self, replica: torch.nn.Module) -> torch.nn.Module:
        """The ``pack=core_pack`` model on ``replica``'s weights, built
        once (the repeated weights made on its device) and cached."""
        i = self.replicas.index(replica)
        key = ("packed_core", self.core_pack) + ((i,) if i else ())
        if key not in self._fn_cache:
            with torch.device("meta"):
                model = build_model(self.cfg, self.compute_dtype,
                                    folded=True, pack=self.core_pack)
            model.load_state_dict(tile_params_packed(
                replica.state_dict(), self.core_pack), assign=True)
            model = model.eval().requires_grad_(False)
            model.pack_head()
            self._fn_cache[key] = model
        return self._fn_cache[key]

    def _core_t_ok(self, x: torch.Tensor) -> bool:
        """Whether ``_forward`` takes the option core for padded NCHW
        frames ``x``: never under ``"xla"`` nor for a packed dispatch;
        under ``"auto"`` on the card where ``core_t.eligible`` holds;
        always under ``"pallas"``, which raises where the core does not
        apply or the dispatch packs."""
        if self.core_impl == "xla":
            return False
        packed = self._use_pack(int(x.shape[0]))
        ok = not packed and self._core_applies() and core_t.eligible(
            self.cfg, int(x.shape[-2]), int(x.shape[-1]))
        if self.core_impl == "auto":
            return ok and x.is_cuda
        if packed:
            raise ValueError(
                f"core_impl='pallas' and core_pack={self.core_pack}: a "
                f"batch of {int(x.shape[0])} runs the packed core, which "
                "the option core does not take; pass core_pack=1 or "
                "core_impl='auto'")
        if not ok:
            raise ValueError(
                f"core_impl='pallas': the option core does not take this "
                f"model and shape ({self.cfg}, frames {tuple(x.shape)}; it "
                "needs core_t.eligible, folded weights and a head at "
                "refine_factor=1)")
        return True

    def _forward(self, model, x1, x2, rows=None):
        """One U-Net-family forward on padded NCHW frames (``rows``: a
        height split's window, ``FrameInterpolationUNet.forward``)."""
        if self._core_t_ok(x1):
            y = core_t.forward_pre_refine(model, x1, x2, rows)
            return model.refine(y, x1, x2).to(self.compute_dtype)
        if self._use_pack(int(x1.shape[0])):
            model = self._packed_core(model)
        return model(x1, x2, rows=rows).to(self.compute_dtype)

    def _pass(self, split: bool, fn, model, xs, *extra):
        """One model pass ``fn(model, *xs, *extra)`` over the padded NCHW
        frames ``xs``, or with ``split`` over the mesh's row windows
        (:meth:`_over_rows`)."""
        if not split:
            return fn(model, *xs, *extra)
        return self._over_rows(fn, xs, extra)

    def _over_rows(self, fn, xs, extra=()):
        """The height split of one model pass: for each part of
        ``parallel.sharding.row_parts`` (the padded height cut at multiples
        of ``cfg.pad_multiple``, the halo ``halo_rows(cfg)``), ``fn(replica,
        *windows, *extra, rows=(first row, padded height))`` on its card,
        issued in turn from this thread; the rows each part keeps cropped
        out of its output (rows on axis -2) and put together in order on the
        first card."""
        hp = int(xs[0].shape[-2])
        parts = row_parts(hp, self.mesh.size, self.cfg.pad_multiple,
                          halo_rows(self.cfg))
        outs = []
        for i, (a, b, lo, hi) in enumerate(parts):
            dev = self.mesh.devices[i]
            wins = [x[..., lo:hi, :].contiguous().to(dev) for x in xs]
            y = fn(self.replicas[i], *wins, *(e.to(dev) for e in extra),
                   rows=(lo, hp))
            outs.append(y[..., a - lo:b - lo, :].to(self.device))
        return torch.cat(outs, -2)

    def _pair_fn(self, n_out: int, depth: int):
        key = ("pair", n_out, depth)
        if key not in self._fn_cache:
            self._fn_cache[key] = self._chunk_batches(
                self._build_pair_fn(n_out, depth),
                None if self.mesh is None
                else self._build_pair_fn(n_out, depth, True))
        return self._fn_cache[key]

    def _chunk_batches(self, fn, split_fn=None):
        """The batch splitter over a pair function ``fn``: with a mesh,
        JAX's choice (:meth:`_over_mesh`: one chunk a card, or the whole
        batch through ``split_fn``, whose model passes run over row
        windows); then ``max_dispatch_batch``, a larger chunk split into
        sequential dispatches; the results concatenated in order."""

        def limited(pair):
            def run(model, f1_u8, f2_u8):
                limit = self.max_dispatch_batch
                b = int(f1_u8.shape[0])
                if not limit or b <= limit:
                    return pair(model, f1_u8, f2_u8)
                return torch.cat([pair(model, f1_u8[i:i + limit],
                                       f2_u8[i:i + limit])
                                  for i in range(0, b, limit)], 0)
            return run

        plain = limited(fn)
        if self.mesh is None:
            return plain
        split = limited(split_fn)
        return lambda model, f1_u8, f2_u8: self._over_mesh(
            plain, split, f1_u8, f2_u8)

    def _over_mesh(self, fn, split_fn, f1_u8, f2_u8, ts=None):
        """JAX's choice for the batch (``parallel.sharding.choose_spec``).
        A batch split: ``fn(replica, f1 chunk, f2 chunk[, times])`` for
        each card's chunk (``parallel.sharding.put_frames``), issued in
        turn from this thread with no wait between them (how far the
        cards' work overlaps is PERF.md's to say); the outputs
        concatenated in order on the first card. Times per pair (``ts``
        [n_t, B]) are split with the pairs. A height split: ``split_fn``
        on the first card, whose model passes run over row windows
        (:meth:`_over_rows`). Replicated: ``fn`` on the first card."""
        spec = choose_spec(int(f1_u8.shape[0]), int(f1_u8.shape[1]),
                           self.mesh)
        parts = [put_frames(f, self.mesh, spec) for f in (f1_u8, f2_u8)]
        if len(spec) > 1:
            fn = split_fn
        n = len(parts[0])
        outs = []
        for i, (a, b) in enumerate(zip(*parts)):
            args = [self.replicas[i], a, b]
            if ts is not None:
                t = ts.to(a.device)
                if t.ndim == 2:
                    per = t.shape[1] // n
                    t = t[:, i * per:(i + 1) * per]
                args.append(t)
            outs.append(fn(*args))
        return torch.cat([o.to(self.device) for o in outs], 0)

    def _prep(self, f_u8: torch.Tensor):
        """uint8 [B,H,W,C] -> (padded NCHW frames in the compute dtype,
        the unpadded (H, W))."""
        return pad_to_multiple(normalize_uint8(f_u8.permute(0, 3, 1, 2),
                                               self.compute_dtype),
                               self.cfg.pad_multiple)

    def _flow_sample(self, model, x1, x2, flow, mask, t):
        """One sample at times ``t`` [B] from a precomputed field, routed as
        the JAX engine routes it, from the config: where the sampler
        computes the config's warps (``warp_fused.config_eligible``), the
        ``sample_fused`` kernel, else the model's stock PyTorch warps and
        blend; then the ``refine_head`` kernel. On the card the kernels
        launch or raise; a frame shape the sampler does not take raises
        ``ValueError``."""
        if warp_fused.config_eligible(self.cfg) and not warp_fused.eligible(
                self.cfg, x1.permute(0, 2, 3, 1).shape):
            raise ValueError(f"the flow sampler does not take frames of "
                             f"shape {tuple(x1.shape)} (NCHW)")
        return model.sample(x1, x2, flow, mask, t)

    def _build_pair_fn(self, n_out: int, depth: int, split: bool = False):
        """uint8 [B,H,W,C] pair -> uint8 [B, n_out, H, W, C].

        U-Net family: ``n_out`` of the 2**depth - 1 dyadic intermediates,
        at the times nearest to i/(n_out+1) (exact when n_out+1 is a power
        of two); each forward is one model pass. Flow family: one motion
        pass, then ``n_out`` samples at the exact times i/(n_out+1), all
        one model pass; ``depth`` is ignored. ``split``: each model pass
        over the mesh's row windows (:meth:`_pass`); the pad, the crop and
        the uint8 conversion run once, on the whole frames."""
        cdt = self.compute_dtype
        if self.cfg.arch == "flow":

            def samples(model, x1, x2, rows=None):
                flow, mask = model.motion(x1, x2, rows=rows)
                outs = []
                for i in range(n_out):
                    t = torch.full((x1.shape[0],), (i + 1) / (n_out + 1),
                                   dtype=torch.float32, device=x1.device)
                    y = self._flow_sample(model, x1, x2, flow, mask, t)
                    outs.append(y.to(cdt))
                return torch.stack(outs, 1)

            def flow_fn(model, f1_u8, f2_u8):
                with torch.inference_mode():
                    x1, hw = self._prep(f1_u8)
                    x2, _ = self._prep(f2_u8)
                    y = self._pass(split, samples, model, (x1, x2))
                    out = denormalize_to_uint8(crop_to(y, hw))
                    return out.permute(0, 1, 3, 4, 2)

            return flow_fn
        total = 2 ** depth - 1
        if n_out == total:
            idx = list(range(total))
        else:
            idx = [min(total - 1, round((i + 1) * (total + 1) / (n_out + 1)) - 1)
                   for i in range(n_out)]

        def forward(model, x1, x2):
            return self._pass(split, self._forward, model, (x1, x2))

        def fn(model, f1_u8, f2_u8):
            with torch.inference_mode():
                x1, hw = self._prep(f1_u8)
                x2, _ = self._prep(f2_u8)
                mids = _bisect(forward, model, x1, x2, depth)
                out = torch.stack([crop_to(mids[i], hw) for i in idx], 1)
                return denormalize_to_uint8(out).permute(0, 1, 3, 4, 2)

        return fn

    def _time_fn(self, n_t: int):
        key = ("time", n_t)
        if key not in self._fn_cache:
            fn = self._build_time_fn(n_t)
            if self.mesh is not None:
                plain, split = fn, self._build_time_fn(n_t, True)
                fn = lambda model, f1, f2, ts: self._over_mesh(  # noqa: E731
                    plain, split, f1, f2, ts)
            self._fn_cache[key] = fn
        return self._fn_cache[key]

    def _build_time_fn(self, n_t: int, split: bool = False):
        """uint8 pair batch and times ``ts`` ([n_t], or [n_t, B] for a time
        per pair) -> uint8 [B, n_t, H, W, C]: one motion pass for the flow
        family, one forward per time for a ``time_conditioned`` U-Net, all
        one model pass (``split`` as in :meth:`_build_pair_fn`)."""
        cdt = self.compute_dtype
        is_flow = self.cfg.arch == "flow"

        def times(model, x1, x2, ts, rows=None):
            b = x1.shape[0]
            if is_flow:
                flow, mask = model.motion(x1, x2, rows=rows)
            outs = []
            for i in range(n_t):
                t = ts[i].to(torch.float32).expand(b).contiguous()
                if is_flow:
                    y = self._flow_sample(model, x1, x2, flow, mask, t)
                else:
                    y = model(x1, x2, t=t, rows=rows)
                outs.append(y.to(cdt))
            return torch.stack(outs, 1)

        def fn(model, f1_u8, f2_u8, ts):
            with torch.inference_mode():
                x1, hw = self._prep(f1_u8)
                x2, _ = self._prep(f2_u8)
                y = self._pass(split, times, model, (x1, x2), ts)
                out = denormalize_to_uint8(crop_to(y, hw))
                return out.permute(0, 1, 3, 4, 2)

        return fn

    def _tower_stream_fn(self):
        key = ("tower_stream",)
        if key not in self._fn_cache:
            fn = self._build_tower_stream_fn()
            if self.mesh is not None:
                plain, split = fn, self._build_tower_stream_fn(True)
                fn = lambda model, frames: self._tower_over_mesh(  # noqa: E731
                    plain, split, frames)
            self._fn_cache[key] = fn
        return self._fn_cache[key]

    def _tower_over_mesh(self, fn, split_fn, frames: torch.Tensor
                         ) -> torch.Tensor:
        """The tower stream step over the mesh: the K frames split as JAX
        splits them (``choose_spec`` on K), each card taking its K/n frames
        and the next one, so that the K-1 pairs are each encoded on one
        card; or, where JAX splits the height, ``split_fn`` on the first
        card, whose encode and decode run over row windows."""
        k, h = int(frames.shape[0]), int(frames.shape[1])
        spec = choose_spec(k, h, self.mesh)
        if len(spec) > 1:
            return split_fn(self.model, frames.to(self.device))
        if not spec:
            return fn(self.model, frames)
        per = k // self.mesh.size
        outs = [fn(replica, frames[i * per:(i + 1) * per + 1].to(dev))
                for i, (replica, dev) in enumerate(
                    zip(self.replicas, self.mesh.devices))]
        return torch.cat([o.to(self.device) for o in outs], 0)

    def _build_tower_stream_fn(self, split: bool = False):
        """Tower stream step: uint8 [K,H,W,C] consecutive frames -> uint8
        [K-1,H,W,C] midpoints, each frame encoded once (the pyramids of
        pair (i, i+1) are slices of one batched encode); the encode and
        decode are one model pass (``split`` as in
        :meth:`_build_pair_fn`)."""
        cdt = self.compute_dtype

        def step(model, x, rows=None):
            feats = model.encode(x)
            return model.decode([f[:-1] for f in feats],
                                [f[1:] for f in feats], x[:-1], x[1:],
                                rows=rows).to(cdt)

        def fn(model, frames_u8):
            with torch.inference_mode():
                x, hw = self._prep(frames_u8)
                y = self._pass(split, step, model, (x,))
                return denormalize_to_uint8(crop_to(y, hw)) \
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

        def queue(run: List[np.ndarray]):
            count("engine.dispatches")
            with annotate("engine.upload"):
                host, dev = io.upload(run)
            with annotate("engine.enqueue"):
                out = step(dev)
                done = io.mark()
            return host, out, done

        def emit(batch, final: bool):
            host, out, done = batch
            with annotate("engine.download"):
                out = io.download(out, done)
            with annotate("stream.interleave"):
                stream = native.interleave(host, out)
            end = len(stream) if final else len(stream) - 1
            for i in range(end):
                yield stream[i]

        run: List[np.ndarray] = []
        in_flight = None
        for frame in frames:
            run.append(np.asarray(frame))
            if len(run) == batch_pairs + 1:
                batch = queue(run)                # dispatch k+1 ...
                run = [run[-1]]
                if in_flight is not None:
                    yield from emit(in_flight, final=False)  # ... drain k
                in_flight = batch
        if len(run) >= 2:
            batch = queue(run)
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
        ts = np.asarray(list(times), np.float32)
        out = dispatch(self, self._time_fn(len(times)),
                       (f1[None], f2[None], ts))[0]
        return [out[i] for i in range(len(times))]

    def interpolate_pair(self, f1: np.ndarray, f2: np.ndarray) -> np.ndarray:
        """Midpoint between two HWC uint8 frames -> HWC uint8."""
        return self.interpolate_batch(f1[None], f2[None])[0]

    def interpolate_batch(self, f1: np.ndarray, f2: np.ndarray) -> np.ndarray:
        """Batched midpoints: [B,H,W,C] u8 x2 -> [B,H,W,C] u8."""
        return dispatch(self, self._pair_fn(1, 1), (f1, f2))[:, 0]

    def generate_intermediate_frames(self, f1: np.ndarray, f2: np.ndarray,
                                     num: int) -> List[np.ndarray]:
        """``num`` in-between HWC uint8 frames in time order: by recursive
        midpoint bisection (U-Net family), or sampled at the exact times
        i/(num+1) from one motion pass (flow family)."""
        if num < 1:
            raise ValueError("num must be >= 1")
        depth = max(1, math.ceil(math.log2(num + 1)))
        out = dispatch(self, self._pair_fn(num, depth),
                       (f1[None], f2[None]))[0]
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
                count("engine.dispatches")
                with annotate("engine.upload"):
                    _, dev = io.upload([j[0] for j in need] +
                                       [j[1] for j in need])
                    ts = torch.from_numpy(tmat).to(self.device)
                with annotate("engine.enqueue"):
                    out = self._time_fn(m)(self.model, dev[:len(need)],
                                           dev[len(need):], ts)
                out = _download(out)
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
