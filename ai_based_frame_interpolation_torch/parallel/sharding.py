"""Placement of batches and weights on a mesh (JAX
``parallel/sharding.py``).

Two dimensions scale in this workload: the batch (``batch_spec``, the
default wherever the batch divides across the mesh) and the frames'
height (``spatial_spec``, JAX's answer for a batch smaller than the mesh
at high resolution). XLA's partitioner splits the height for JAX with a
halo exchange at every conv, pool, upsample and warp. An engine mesh
splits it with one halo taken up front instead (:func:`row_parts`): each
card runs a whole model pass over its rows and :func:`halo_rows` more on
each side, wide enough that the rows it keeps are the rows of the whole
frame, and the kept rows are put together in order.

Within a process group a global batch of B items, taken as ``grad_accum``
microbatches of m = B / grad_accum, puts on rank r of n the items
``[k m + r m/n, k m + (r+1) m/n)`` of each microbatch k, in that order
(:func:`shard_items`): each microbatch is then JAX's, whose reshape takes
global items ``[k m, (k+1) m)``.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..config import ModelConfig
from .mesh import Mesh


def batch_spec(axis_name: str = "data") -> tuple:
    return (axis_name,)


def spatial_spec(axis_name: str = "data") -> tuple:
    """Split H of [B, H, W, C]."""
    return (None, axis_name)


def choose_spec(batch: int, height: int, mesh: Mesh,
                axis_name: str = "data") -> tuple:
    """JAX's choice: the batch where it divides evenly, else the height,
    else replicate."""
    n = mesh.size
    if batch % n == 0:
        return batch_spec(axis_name)
    if height % n == 0:
        return spatial_spec(axis_name)
    return ()


def shard_items(batch: int, mesh: Mesh, grad_accum: int = 1
                ) -> Tuple[np.ndarray, int]:
    """(the global items this rank holds, how many of them are real).

    Where each microbatch divides across the ranks: the items of the
    module docstring, all real. A batch the ranks do not divide (the last
    batch of a validation set; ``grad_accum`` 1 only) is padded: rank r
    holds ``[r p, (r+1) p)`` with p = ceil(B / n), cut at B, then repeats
    of its last item (of item B - 1 where it holds none) up to p; the
    caller masks the repeats out. Raises ``ValueError`` where
    ``grad_accum`` does not divide the batch or a microbatch does not
    divide across the ranks: JAX re-lays such a batch silently, the port
    refuses it."""
    n, r = mesh.size, mesh.rank
    if grad_accum < 1 or batch % grad_accum:
        raise ValueError(f"grad_accum {grad_accum} must divide the batch "
                         f"{batch}")
    m = batch // grad_accum
    if m % n == 0:
        per = m // n
        idx = np.concatenate([np.arange(k * m + r * per, k * m + (r + 1) * per)
                              for k in range(grad_accum)])
        return idx, len(idx)
    if grad_accum > 1:
        raise ValueError(f"a microbatch of {m} items (batch {batch}, "
                         f"grad_accum {grad_accum}) does not divide across "
                         f"{n} ranks")
    per = -(-batch // n)
    own = np.arange(r * per, min((r + 1) * per, batch))
    last = own[-1] if len(own) else batch - 1
    return np.concatenate([own, np.full(per - len(own), last)]), len(own)


@functools.lru_cache(maxsize=64)
def halo_rows(cfg: ModelConfig) -> Optional[int]:
    """How many rows beyond its block of ``cfg.pad_multiple`` rows one
    input row of the padded frame reaches in one model pass, on either
    side, rounded up to a multiple of the pad multiple; None where the pass
    may read any row (the ``gather4`` and ``patch`` warps). The reach is an
    upper bound that the model's own modules give from their layers
    (``row_reach``, built here on the meta device, which holds no weights).

    A window cut at multiples of the pad multiple that keeps the rows more
    than this far inside its edges keeps the whole frame's rows: what it
    lacks lies in the blocks beyond its edges. Each pass is periodic in a
    row's place modulo the pad multiple, so one period is walked."""
    from ..models import build_model

    with torch.device("meta"):
        model = build_model(cfg, torch.float32)
    m = cfg.pad_multiple
    block = 1024 * m
    reach = 0
    for p in range(block, block + m):
        iv = model.row_reach(p)
        if iv is None:
            return None
        reach = max(reach, block - iv[0], iv[1] - (block + m - 1))
    return -(-reach // m) * m


def row_parts(height: int, parts: int, multiple: int,
              halo: Optional[int]) -> List[Tuple[int, int, int, int]]:
    """The height split of a padded frame of ``height`` rows over
    ``parts`` cards: ``(a, b, lo, hi)`` for each part that runs, in order.
    The part keeps rows ``[a, b)`` and computes over ``[lo, hi)``, its rows
    and ``halo`` more on each side, cut at the frame. The height, in units
    of ``multiple``, is cut as evenly as possible, the first parts taking
    the extra units; a part with no units does not run. Where a window
    would hold the whole frame, or with ``halo`` None (a pass that may read
    any row), the first part computes the whole frame alone: the others
    would only repeat its work."""
    whole = [(0, height, 0, height)]
    if halo is None:
        return whole
    per, extra = divmod(height // multiple, parts)
    out, a = [], 0
    for i in range(parts):
        units = per + (i < extra)
        if not units:
            break
        b = a + units * multiple
        out.append((a, b, max(0, a - halo), min(height, b + halo)))
        a = b
    if any(hi - lo == height for _, _, lo, hi in out):
        return whole
    return out


def put_frames(arr, mesh: Optional[Mesh], spec: Optional[tuple] = None
               ) -> Union[torch.Tensor, List[torch.Tensor]]:
    """Place a global [B,H,W,C] batch (numpy or a tensor) on ``mesh``.

    No mesh: the tensor as it is. A process group's mesh: this rank's
    items (:func:`shard_items`) on its card. An engine mesh: a list of
    tensors, for a batch split the equal chunks in order, one on each
    card; replicated or split by height, the whole batch on the first
    card, where a replicated computation runs and where the engine cuts
    the padded frames into row windows (:func:`row_parts`). A process
    group splits batches only: a height split raises ``ValueError``."""
    t = torch.as_tensor(arr)
    if mesh is None:
        return t
    if spec is None:
        spec = choose_spec(t.shape[0], t.shape[1], mesh, mesh.axis_name)
    if mesh.grouped:
        if len(spec) > 1:
            raise ValueError(
                f"a process group's mesh splits the batch: {t.shape[0]} "
                f"items do not divide across its {mesh.size} ranks")
        if not spec:
            return t.to(mesh.device)
        idx, _ = shard_items(t.shape[0], mesh)
        return t[torch.from_numpy(idx)].to(mesh.device)
    if len(spec) != 1:
        return [t.to(mesh.device)]
    per = t.shape[0] // mesh.size
    return [t[i * per:(i + 1) * per].to(dev)
            for i, dev in enumerate(mesh.devices)]


def put_replicated(tree: Dict[str, torch.Tensor], mesh: Optional[Mesh]):
    """Replicate a dict of tensors (a state dict) over ``mesh``.

    A process group's mesh: every tensor takes rank 0's values in place
    (``broadcast``) and the dict is returned. An engine mesh: a list of
    copies, one on each card."""
    if mesh is None:
        return tree
    if mesh.grouped:
        if mesh.world_size > 1:
            for v in tree.values():
                dist.broadcast(v.data, 0)
        return tree
    return [{k: v.to(dev) for k, v in tree.items()} for dev in mesh.devices]


def replicas_agree(tensors: List[torch.Tensor], mesh: Mesh) -> bool:
    """Whether every rank holds rank 0's values of ``tensors`` bit for bit
    (a debugging check: one broadcast of their concatenation)."""
    if not mesh.grouped or mesh.world_size == 1:
        return True
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    same = torch.tensor([float(torch.equal(flat, ref))], device=flat.device)
    dist.all_reduce(same, dist.ReduceOp.MIN)
    return bool(same.item())
