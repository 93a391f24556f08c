"""SSIM, two variants, NHWC, f32 (JAX ``ops/ssim.py``).

1. **Training loss**: 11x11 Gaussian window (sigma 1.5), zero ``SAME``
   padding, population covariance, C1 = 0.01^2 and C2 = 0.03^2 (data
   range 1), mean over the map; the loss is ``1 - ssim``.
2. **Evaluation metric** (:func:`ssim_eval`): skimage's
   ``structural_similarity`` semantics, a 7x7 uniform window over the
   fully covered (VALID) positions, sample covariance, C constants scaled
   by ``data_range``. This is the plain version beside the CUDA kernel of
   ``ops/ssim_fused.py``.

Both are plain PyTorch on every device. Each separable 1-D window is
applied as a sum of shifted slices, tap by tap in f32, rather than as a
depthwise ``F.conv2d``: cuDNN runs an f32 convolution in TF32 on the card
by default, which would cost the metric three decimal digits, and the
shifted sum rounds the same way on the CPU and on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=16)
def _gaussian_window_np(size: int, sigma: float) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2.0 * sigma ** 2))
    # the reference's construction: normalize the 1-D window in f32
    return (g / g.sum()).astype(np.float32)


def _blur_1d(x: torch.Tensor, window, axis: int, same: bool) -> torch.Tensor:
    """``sum_d window[d] * x[.., i + d, ..]`` along ``axis`` of NHWC ``x``
    (VALID; ``same`` zero-pads (k-1)/2 on each side first)."""
    k = len(window)
    if same:
        pad = [0, 0] * (x.ndim - 1 - axis) + [(k - 1) // 2, k // 2]
        x = F.pad(x, pad)
    n = x.shape[axis] - k + 1
    if n <= 0:
        shape = list(x.shape)
        shape[axis] = 0
        return x.new_zeros(shape)
    out = x.narrow(axis, 0, n) * float(window[0])
    for d in range(1, k):
        out = out + x.narrow(axis, d, n) * float(window[d])
    return out


def _blur(x: torch.Tensor, window, same: bool) -> torch.Tensor:
    """The separable window: along H, then along W."""
    return _blur_1d(_blur_1d(x, window, 1, same), window, 2, same)


def ssim_loss_map(img1: torch.Tensor, img2: torch.Tensor,
                  window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Per-pixel SSIM map with the training-loss semantics, NHWC."""
    img1 = img1.to(torch.float32)
    img2 = img2.to(torch.float32)
    w = _gaussian_window_np(window_size, sigma)
    mu1 = _blur(img1, w, True)
    mu2 = _blur(img2, w, True)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _blur(img1 * img1, w, True) - mu1_sq
    sigma2_sq = _blur(img2 * img2, w, True) - mu2_sq
    sigma12 = _blur(img1 * img2, w, True) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) /
            ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)))


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Scalar mean SSIM (training-loss variant)."""
    return torch.mean(ssim_loss_map(img1, img2, window_size, sigma))


def ssim_loss(pred: torch.Tensor, target: torch.Tensor, window_size: int = 11,
              sigma: float = 1.5) -> torch.Tensor:
    """``1 - SSIM``, the differentiable loss term."""
    return 1.0 - ssim(pred, target, window_size, sigma)


def combined_loss(pred: torch.Tensor, target: torch.Tensor,
                  mse_weight: float = 0.5, ssim_weight: float = 0.5,
                  window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """0.5 MSE + 0.5 (1 - SSIM) (reference ``model/train.py:75-87``)."""
    pred = pred.to(torch.float32)
    target = target.to(torch.float32)
    mse = torch.mean((pred - target) ** 2)
    return mse_weight * mse + ssim_weight * ssim_loss(pred, target,
                                                      window_size, sigma)


def ssim_eval(img1: torch.Tensor, img2: torch.Tensor,
              data_range: float = 255.0, win_size: int = 7) -> torch.Tensor:
    """skimage-compatible SSIM per image, on the inputs' device.

    Takes [N,H,W,C] (or [H,W,C]) in any numeric dtype and returns [N] f32
    (or a scalar): the mean over every channel and fully covered window
    position. Images smaller than the window give NaN (a mean of nothing),
    as in JAX.
    """
    squeeze = img1.ndim == 3
    if squeeze:
        img1, img2 = img1[None], img2[None]
    x = img1.to(torch.float32)
    y = img2.to(torch.float32)
    w = [np.float32(1.0 / win_size)] * win_size
    ux = _blur(x, w, False)
    uy = _blur(y, w, False)
    uxx = _blur(x * x, w, False)
    uyy = _blur(y * y, w, False)
    uxy = _blur(x * y, w, False)
    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1.0)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux * ux + uy * uy + c1) *
                                                 (vx + vy + c2))
    out = torch.mean(s, dim=(1, 2, 3))
    return out[0] if squeeze else out
