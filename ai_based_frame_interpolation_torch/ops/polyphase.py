"""The half-pixel 2x upsample fused into the conv after it (JAX
``ops/polyphase.py``), in stock PyTorch.

The decoder's ``Up`` block computes ``conv3x3(concat(skip, up2(low)))``.
On the half-pixel grid every even output row of the upsample is ``0.25
x[i-1] + 0.75 x[i]`` and every odd one ``0.75 x[i] + 0.25 x[i+1]``
(edge-clamped), so the conv over the upsampled half collapses into one 3x3
conv at LOW resolution with four times the output channels, one block per
output phase ``(p, q)``, followed by a depth-to-space shuffle:

    conv3x3(up2(x))[2i+p, 2j+q] = sum_{e,f} Weff[p,q][e,f] @ x[i+e, j+f]

with ``Weff[p,q] = sum_{dy,dx} W[dy,dx] A[p,dy,e] A[q,dx,f]``. The phase
conv runs over the edge-padded ``x``, which matches the upsample's clamp
but also charges the four border rows and columns with neighbours the
true conv sees as zeros; closed-form one-row and one-column corrections
take them off and add back the corners taken off twice. In f32 the result
equals the composition to rounding. Layout is NCHW, kernels OIHW.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# _A[p, 1+dy, 1+e]: weight of the low-resolution tap x[i+e] in upsampled
# row 2i+p+dy (up[2k] = 0.25 x[k-1] + 0.75 x[k], up[2k+1] = 0.75 x[k] +
# 0.25 x[k+1])
_A = ((0.75, 0.25, 0.0), (0.25, 0.75, 0.0), (0.0, 0.75, 0.25)), \
    ((0.25, 0.75, 0.0), (0.0, 0.75, 0.25), (0.0, 0.25, 0.75))


def polyphase_kernel(w: torch.Tensor) -> torch.Tensor:
    """A [Co,C,3,3] conv kernel composed with the half-pixel 2x upsample:
    [4*Co,C,3,3], output channels in (p, q, co) order, as
    :func:`_depth_to_space2` reads them."""
    a = torch.tensor(_A, dtype=w.dtype, device=w.device)
    weff = torch.einsum("ocyx,pye,qxf->pqocef", w, a, a)
    return weff.reshape(-1, *w.shape[1:])


def _depth_to_space2(x: torch.Tensor) -> torch.Tensor:
    """[B,4C,H,W] with channels in (p, q, c) order -> [B,C,2H,2W]."""
    b, c4, h, w = x.shape
    c = c4 // 4
    x = x.reshape(b, 2, 2, c, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, c, 2 * h, 2 * w)


def _up1d(x: torch.Tensor) -> torch.Tensor:
    """Half-pixel 2x upsample of axis 1 of [B,N,C] (edge-clamped), f32."""
    x = x.float()
    xm = torch.cat([x[:, :1], x[:, :-1]], 1)
    xp = torch.cat([x[:, 1:], x[:, -1:]], 1)
    even = 0.25 * xm + 0.75 * x
    odd = 0.75 * x + 0.25 * xp
    return torch.stack([even, odd], 2).reshape(x.shape[0], -1, x.shape[2])


def _edge_corr(v: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """One border line's correction: ``sum_d w3[d]`` applied to ``v``
    [B,N,C] (the virtual line the phase conv saw, edge-extended) shifted by
    ``d - 1``; ``w3`` [3,C,Co] is the kernel's row or column facing that
    border. Returns [B,N,Co]."""
    n = v.shape[1]
    ve = torch.cat([v[:, :1], v, v[:, -1:]], 1)
    out = ve[:, 0:n] @ w3[0]
    for d in (1, 2):
        out = out + ve[:, d:d + n] @ w3[d]
    return out


def up2_conv_half_pixel(x_low: torch.Tensor, x_skip: torch.Tensor,
                        weight: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``conv3x3(concat(x_skip, up2_half_pixel(x_low)))``, fused.

    x_low  : [B,Cl,H,W], the decoder activation before the upsample
    x_skip : [B,Cs,2H,2W], the encoder skip (concatenated first, as in Up)
    weight : [Co,Cs+Cl,3,3] f32, the conv's kernel; bias [Co] or None
    returns [B,Co,2H,2W] f32. The two convs run in ``compute_dtype`` and
    are summed in f32 with the f32 corrections and the bias (the JAX
    function accumulates its convs in f32; in f32 the two agree).
    """
    cdt = compute_dtype
    cs = x_skip.shape[1]
    w_skip, w_low = weight[:, :cs], weight[:, cs:]
    out = F.conv2d(x_skip.to(cdt), w_skip.to(cdt), padding=1).float()
    xp = F.pad(x_low.to(cdt), (1, 1, 1, 1), mode="replicate")
    out = out + _depth_to_space2(
        F.conv2d(xp, polyphase_kernel(w_low).to(cdt)).float())

    wl = w_low.float().permute(2, 3, 1, 0)         # [3(y), 3(x), Cl, Co]
    xl = x_low.float()
    rows = xl.permute(0, 2, 3, 1)                   # [B, H, W, Cl]
    out[:, :, 0] -= _edge_corr(_up1d(rows[:, 0]), wl[0]).transpose(1, 2)
    out[:, :, -1] -= _edge_corr(_up1d(rows[:, -1]), wl[2]).transpose(1, 2)
    out[:, :, :, 0] -= _edge_corr(_up1d(rows[:, :, 0]),
                                  wl[:, 0]).transpose(1, 2)
    out[:, :, :, -1] -= _edge_corr(_up1d(rows[:, :, -1]),
                                   wl[:, 2]).transpose(1, 2)
    for (ri, ci), (ky, kx) in (((0, 0), (0, 0)), ((0, -1), (0, 2)),
                               ((-1, 0), (2, 0)), ((-1, -1), (2, 2))):
        out[:, :, ri, ci] += xl[:, :, ri, ci] @ wl[ky, kx]
    if bias is not None:
        out = out + bias.float().view(1, -1, 1, 1)
    return out
