"""Training loop of the PyTorch port (JAX ``train/loop.py``).

The reference's training contract (``model/train.py:153-316``: Adam at
lr 1e-4, the combined loss 0.5 MSE + 0.5 (1 - SSIM), ReduceLROnPlateau with
factor 0.5 and patience 10, best-val checkpoints), with the JAX package's
additions: the census, flow smoothness and flow photometric terms, EMA
weights, sequential microbatches (``grad_accum``), the NaN guard and a
resume that restores the optimizer too.

A train step is the model's training forward (``train=True``: BatchNorm
on the batch's statistics, the head and the flow sampler as plain PyTorch)
and stock autograd over cuDNN convs, the counterpart of XLA's autodiff: no
CUDA kernel of the port has a backward, and their wrappers refuse to run
under grad (``ops/_build.py:refuse_grad``). Validation runs the inference
forward, so on the card it launches the head kernel (and the flow
sampler) on weights packed once per validation phase from the weights it
scores, and the SSIM kernel through ``ssim_eval_auto``.

Layout: batches are uint8 NHWC as in JAX; the models take NCHW views, and
the losses NHWC. Everything runs on ``device``: the card unless the
caller passes ``"cpu"``.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import LossConfig, TrainConfig
from ..infer.engine import resolve_device
from ..models.flow import FlowInterpolator
from ..ops.census import census_loss
from ..ops.image import denormalize_to_uint8, normalize_uint8
from ..ops.psnr import psnr
from ..ops.ssim import combined_loss
from ..ops.ssim_fused import ssim_eval_auto
from ..ops.warp import backward_warp


@dataclasses.dataclass
class TrainState:
    """What a train step changes: the model's parameters and BatchNorm
    buffers, the optimizer (``tx``) and its state, the step count, and the
    EMA of the parameters (``None`` when EMA is off)."""

    model: torch.nn.Module
    tx: torch.optim.Adam
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    # the inference copy validation scores, keyed by (step, use_ema)
    _scored: Optional[tuple] = dataclasses.field(default=None, repr=False)

    def variables(self, use_ema: bool = False) -> Dict[str, torch.Tensor]:
        """The model's state dict, detached, with the EMA in place of the
        parameters when ``use_ema``: what validation scores and what exports
        for inference."""
        out = {k: v.detach() for k, v in self.model.state_dict().items()}
        if use_ema:
            out.update(self.ema_params)
        return out


def _f32(x: float) -> float:
    """``x`` rounded to f32, as optax holds an injected hyperparameter."""
    return float(np.float32(x))


def make_optimizer(cfg: TrainConfig, params: Iterable[torch.nn.Parameter]
                   ) -> torch.optim.Adam:
    """Adam with optax's defaults (betas 0.9 and 0.999, eps 1e-8); the
    learning rate lives on the param group (:func:`set_learning_rate`)."""
    return torch.optim.Adam(params, lr=_f32(cfg.learning_rate),
                            betas=(0.9, 0.999), eps=1e-8)


def create_train_state(model: torch.nn.Module,
                       variables: Optional[Mapping[str, torch.Tensor]],
                       cfg: TrainConfig, device=None) -> TrainState:
    """The model on ``device`` (the card unless ``"cpu"``) with
    ``variables`` loaded (a state dict; ``None`` keeps the model's own),
    its optimizer, step 0, and the EMA seeded from the parameters when
    ``cfg.ema_decay > 0``."""
    if variables is not None:
        model.load_state_dict(variables)
    model.to(resolve_device(device))
    ema = ({n: p.detach().clone() for n, p in model.named_parameters()}
           if cfg.ema_decay > 0 else None)
    return TrainState(model=model, tx=make_optimizer(cfg, model.parameters()),
                      ema_params=ema)


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Set the learning rate of every param group (the plateau schedule)."""
    for group in state.tx.param_groups:
        group["lr"] = _f32(lr)
    return state


def get_learning_rate(state: TrainState) -> float:
    return float(state.tx.param_groups[0]["lr"])


def flow_smoothness(flow: torch.Tensor, img: torch.Tensor,
                    edge_scale: float = 10.0) -> torch.Tensor:
    """Edge-aware first-order smoothness of a motion field: mean |d flow/dx|
    + |d flow/dy|, each weighted by exp(-edge_scale |dI|) so motion
    boundaries at image edges cost less. NHWC; ``img`` in [-1, 1], ``flow``
    in pixels; f32."""
    f = flow.float()
    i = img.float()
    d_ix = torch.mean(torch.abs(i[:, :, 1:] - i[:, :, :-1]), -1, keepdim=True)
    d_iy = torch.mean(torch.abs(i[:, 1:] - i[:, :-1]), -1, keepdim=True)
    d_fx = torch.abs(f[:, :, 1:] - f[:, :, :-1])
    d_fy = torch.abs(f[:, 1:] - f[:, :-1])
    return (torch.mean(torch.exp(-edge_scale * d_ix) * d_fx) +
            torch.mean(torch.exp(-edge_scale * d_iy) * d_fy))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def train_forward(model: torch.nn.Module, f0: torch.Tensor, f1: torch.Tensor
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The training forward on normalized NHWC frames: (the prediction,
    the flow family's motion field or ``None``), both NHWC. The flow family
    runs :meth:`~..models.flow.FlowInterpolator.motion` and ``sample`` at
    t = 0.5, as its forward does, and hands the field to the flow losses
    (JAX's ``sow("intermediates", "flow")``)."""
    x0, x1 = _nchw(f0), _nchw(f1)
    if isinstance(model, FlowInterpolator):
        flow, mask = model.motion(x0, x1, train=True)
        t = torch.full((x0.shape[0],), 0.5, dtype=torch.float32,
                       device=x0.device)
        return _nhwc(model.sample(x0, x1, flow, mask, t, train=True)), \
            _nhwc(flow)
    return _nhwc(model(x0, x1, train=True)), None


def _loss_and_updates(model: torch.nn.Module, batch: Mapping[str, torch.Tensor],
                      loss_cfg: LossConfig) -> torch.Tensor:
    """The training loss of one (micro)batch; the BatchNorm running
    statistics update in place as the forward runs."""
    f0 = normalize_uint8(batch["f0"])
    f1 = normalize_uint8(batch["f1"])
    gt = normalize_uint8(batch["gt"])
    pred, flow = train_forward(model, f0, f1)
    loss = combined_loss(pred, gt, loss_cfg.mse_weight, loss_cfg.ssim_weight,
                         loss_cfg.ssim_window, loss_cfg.ssim_sigma)
    if loss_cfg.census_weight > 0:
        loss = loss + loss_cfg.census_weight * census_loss(
            pred, gt, loss_cfg.census_window)
    if loss_cfg.flow_smooth_weight > 0 and flow is not None:
        loss = loss + loss_cfg.flow_smooth_weight * flow_smoothness(
            flow, 0.5 * (f0 + f1), loss_cfg.flow_smooth_edge)
    if loss_cfg.flow_photo_weight > 0 and flow is not None:
        # the t=1 field (-F01 for the single field) carries f0 onto f1, the
        # t=0 field F01 carries f1 onto f0: the sampler's own endpoints,
        # warped exactly (gather4), as JAX does
        f01 = flow.float()
        r1 = backward_warp(f0, -f01, impl="gather4")
        r0 = backward_warp(f1, f01, impl="gather4")
        loss = loss + loss_cfg.flow_photo_weight * (
            torch.mean(torch.abs(r1 - f1)) + torch.mean(torch.abs(r0 - f0)))
    return loss


def _grads(model: torch.nn.Module, batch: Mapping[str, torch.Tensor],
           loss_cfg: LossConfig, grad_accum: int) -> torch.Tensor:
    """The loss and the parameters' ``.grad``, each the mean over
    ``grad_accum`` microbatches run in sequence (the BatchNorm statistics
    update once per microbatch, as if each were a step)."""
    for p in model.parameters():
        p.grad = None
    if grad_accum == 1:
        loss = _loss_and_updates(model, batch, loss_cfg)
        loss.backward()
        return loss.detach()
    n = next(iter(batch.values())).shape[0]
    if n % grad_accum:
        raise ValueError(f"grad_accum {grad_accum} must divide the batch {n}")
    m = n // grad_accum
    lsum = torch.zeros((), dtype=torch.float32,
                       device=next(iter(batch.values())).device)
    for k in range(grad_accum):
        loss = _loss_and_updates(
            model, {key: v[k * m:(k + 1) * m] for key, v in batch.items()},
            loss_cfg)
        loss.backward()
        lsum = lsum + loss.detach()
    inv = 1.0 / grad_accum
    for p in model.parameters():
        if p.grad is not None:
            p.grad.mul_(inv)
    return lsum * inv


def _on(batch: Mapping, device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's uint8 arrays as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def train_step(state: TrainState, batch: Mapping[str, torch.Tensor],
               loss_cfg: LossConfig, ema_decay: float = 0.0,
               grad_accum: int = 1) -> Tuple[TrainState, torch.Tensor]:
    """One optimizer step; returns ``(state, loss)``, the loss a 0-d tensor
    on the device.

    The NaN guard keeps JAX's semantics without a host sync: on a
    non-finite loss the gradients become zeros and Adam still steps on
    them (its moments decay and its step count advances, as optax's state
    does), then the parameters and the BatchNorm running statistics return
    to their values before the step. ``step`` counts every call."""
    model = state.model
    device = next(model.parameters()).device
    batch = _on(batch, device)
    params = list(model.parameters())
    buffers = [b for b in model.buffers() if b.is_floating_point()]
    with torch.no_grad():
        before = [t.clone() for t in params + buffers]
    loss = _grads(model, batch, loss_cfg, grad_accum)
    ok = torch.isfinite(loss)
    with torch.no_grad():
        for p in params:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = torch.where(ok, g, torch.zeros_like(g))
        state.tx.step()
        for t, old in zip(params + buffers, before):
            t.copy_(torch.where(ok, t, old))
        if ema_decay > 0 and state.ema_params is not None:
            d = _f32(ema_decay)
            keep = float(np.float32(1) - np.float32(ema_decay))
            for name, p in model.named_parameters():
                e = state.ema_params[name]
                e.copy_(e * d + p * keep)
    state.step += 1
    return state, loss


def _scored_model(state: TrainState, use_ema: bool) -> torch.nn.Module:
    """An inference copy of the model holding the weights validation
    scores, its head packed from them (``pack_head``): built once per
    (step, use_ema), so once per validation phase, and never stale."""
    key = (state.step, use_ema)
    if state._scored is None or state._scored[0] != key:
        with torch.no_grad():
            scored = copy.deepcopy(state.model).requires_grad_(False).eval()
            if use_ema:
                for name, p in scored.named_parameters():
                    p.copy_(state.ema_params[name])
            scored.pack_head()
        state._scored = (key, scored)
    return state._scored[1]


def eval_step(state: TrainState, batch: Mapping[str, torch.Tensor],
              loss_cfg: LossConfig, use_ema: bool = False
              ) -> Dict[str, torch.Tensor]:
    """Validation of one batch: the combined loss, and the mean PSNR and
    skimage SSIM of the uint8 prediction against the uint8 ground truth
    (0-d tensors on the device). The inference forward, BatchNorm unfolded
    on its running statistics; with ``use_ema`` the EMA weights are scored
    (they are what exports)."""
    model = _scored_model(state, use_ema)
    device = next(model.parameters()).device
    batch = _on(batch, device)
    with torch.no_grad():
        f0 = normalize_uint8(batch["f0"])
        f1 = normalize_uint8(batch["f1"])
        gt = normalize_uint8(batch["gt"])
        pred = _nhwc(model(_nchw(f0), _nchw(f1)))
        loss = combined_loss(pred, gt, loss_cfg.mse_weight,
                             loss_cfg.ssim_weight, loss_cfg.ssim_window,
                             loss_cfg.ssim_sigma)
        pred_u8 = denormalize_to_uint8(pred)
        return {"loss": loss,
                "psnr": torch.mean(psnr(pred_u8, batch["gt"])),
                "ssim": torch.mean(ssim_eval_auto(pred_u8, batch["gt"]))}


@dataclasses.dataclass
class PlateauScheduler:
    """ReduceLROnPlateau (reference ``model/train.py:163-165``), host-side."""

    factor: float = 0.5
    patience: int = 10
    best: float = float("inf")
    bad_epochs: int = 0

    def update(self, metric: float, lr: float) -> float:
        if metric < self.best - 1e-12:
            self.best = metric
            self.bad_epochs = 0
            return lr
        self.bad_epochs += 1
        if self.bad_epochs > self.patience:
            self.bad_epochs = 0
            return lr * self.factor
        return lr


@dataclasses.dataclass
class History:
    train_loss: List[float] = dataclasses.field(default_factory=list)
    val_loss: List[float] = dataclasses.field(default_factory=list)
    val_psnr: List[float] = dataclasses.field(default_factory=list)
    val_ssim: List[float] = dataclasses.field(default_factory=list)
    lr: List[float] = dataclasses.field(default_factory=list)


def train_model(model: torch.nn.Module,
                variables: Optional[Mapping[str, torch.Tensor]],
                train_loader: Iterable, val_loader: Iterable,
                cfg: TrainConfig, device=None,
                checkpointer=None, log_fn: Callable[[str], None] = print,
                start_epoch: int = 0, state: Optional[TrainState] = None,
                history: Optional[History] = None
                ) -> Tuple[TrainState, History]:
    """The epoch loop: train steps, a validation phase, the plateau
    schedule, best and latest checkpoints (``save_every``), on ``device``
    (the card unless ``"cpu"``). A resume passes the restored ``state``,
    ``start_epoch`` and ``history``; the plateau replays the history, and a
    loader with ``set_epoch`` (``TripletLoader``) is set to each epoch, so
    a resumed run sees the batches the uninterrupted one would."""
    device = resolve_device(device)
    try:
        if len(train_loader) == 0:
            raise ValueError(
                "train loader yields zero batches per epoch (batch size "
                "larger than the train set with drop_remainder): every "
                "epoch would be a no-op with train loss nan")
    except TypeError:
        pass  # plain iterables without __len__
    if state is None:
        state = create_train_state(model, variables, cfg, device)
    history = history or History()
    sched = PlateauScheduler(cfg.plateau_factor, cfg.plateau_patience)
    for past in history.val_loss:          # resume: replay the plateau
        sched.update(past, get_learning_rate(state))
    best_val = min(history.val_loss, default=float("inf"))
    loss_cfg = cfg.loss

    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.time()
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(epoch)
        train_losses = []
        for batch in train_loader:
            state, loss = train_step(state, batch, loss_cfg,
                                     ema_decay=cfg.ema_decay,
                                     grad_accum=cfg.grad_accum)
            train_losses.append(loss)
        train_loss = float(np.mean([float(x) for x in train_losses])) \
            if train_losses else float("nan")

        val_metrics = {"loss": [], "psnr": [], "ssim": []}
        use_ema = cfg.ema_decay > 0 and state.ema_params is not None
        for batch in val_loader:
            m = eval_step(state, batch, loss_cfg, use_ema=use_ema)
            for k in val_metrics:
                val_metrics[k].append(float(m[k]))
        val_loss = float(np.mean(val_metrics["loss"])) if val_metrics["loss"] \
            else float("nan")

        lr = get_learning_rate(state)
        new_lr = sched.update(val_loss, lr)
        if new_lr != lr:
            state = set_learning_rate(state, new_lr)
            log_fn(f"  plateau: lr {lr:.2e} -> {new_lr:.2e}")

        history.train_loss.append(train_loss)
        history.val_loss.append(val_loss)
        history.val_psnr.append(float(np.mean(val_metrics["psnr"]))
                                if val_metrics["psnr"] else float("nan"))
        history.val_ssim.append(float(np.mean(val_metrics["ssim"]))
                                if val_metrics["ssim"] else float("nan"))
        history.lr.append(new_lr)

        log_fn(f"epoch {epoch + 1}/{cfg.epochs}  "
               f"train {train_loss:.6f}  val {val_loss:.6f}  "
               f"psnr {history.val_psnr[-1]:.2f}  "
               f"ssim {history.val_ssim[-1]:.4f}  lr {new_lr:.2e}  "
               f"({time.time() - t0:.1f}s)")

        if checkpointer is not None:
            improved = val_loss < best_val
            if improved:
                best_val = val_loss
            last = epoch + 1 == cfg.epochs
            latest = (cfg.save_every <= 1
                      or (epoch + 1) % cfg.save_every == 0 or last)
            if improved or latest:
                checkpointer.save(state=state, epoch=epoch, history=history,
                                  best=improved, latest=latest)
    return state, history
