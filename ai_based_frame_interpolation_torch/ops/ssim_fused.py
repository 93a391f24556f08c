"""skimage SSIM per image: the CUDA kernel and its plain version.

Counterpart of the JAX package's ``ops/pallas/ssim_fused.py``, with its
three entry points and signatures (``interpret`` has no counterpart).
For CUDA tensors all three launch ``csrc/ssim_eval.cu``, one kernel for
every B, H, W and every channel count: RGB too, which JAX sends to XLA.
The JAX module's VMEM gates (``fits_vmem``, ``tiled_eligible``) are TPU
budgets with no counterpart here, so nothing on the CUDA route reaches the
plain version, and a failed build or launch raises. For CPU tensors all
three compute the plain :func:`ops.ssim.ssim_eval`.

``ssim_eval_fused.launches`` counts the kernel's launches, one per call
(each call runs the band kernel and the per-image mean kernel of the same
source). :func:`band_geometry` mirrors how the kernel cuts an image plane
into strips of columns and bands of rows, one warp each, and
:func:`partials_per_plane` how many partials it sums per plane: one per
strip and two output rows, whatever the bands.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from . import _build
from .ssim import ssim_eval


# csrc/ssim_eval.cu's decomposition: a one-warp block per (image plane,
# strip, band); a lane takes LANE_COLS consecutive output columns; one
# partial per strip and GROUP output rows; bands of a multiple of GROUP
# rows, MIN_BAND or more, as many as give about BLOCKS_PER_SM blocks an SM
WIN = 7
LANES = 32
LANE_COLS = {torch.uint8: 8, torch.float32: 2}
GROUP = 2
MIN_BAND = 2
BLOCKS_PER_SM = 16


def strip_cols(dtype) -> int:
    """Output columns a strip (one warp) takes for uint8 or f32 inputs."""
    return LANES * LANE_COLS[dtype]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def band_geometry(b: int, c: int, h: int, w: int, dtype, sms: int) -> tuple:
    """(strips, bands, band rows) of the kernel's grid for [b,h,w,c]
    images on a card of ``sms`` SMs: ``b * c * strips * bands`` blocks.
    The bands schedule the work; the partials do not depend on them."""
    valid_h, valid_w = h - WIN + 1, w - WIN + 1
    strips = _cdiv(valid_w, strip_cols(dtype))
    bands = max(1, min(_cdiv(sms * BLOCKS_PER_SM, b * c * strips), valid_h))
    band_h = max(MIN_BAND, _cdiv(_cdiv(valid_h, bands), GROUP) * GROUP)
    return strips, _cdiv(valid_h, band_h), band_h


def partials_per_plane(h: int, w: int) -> int:
    """The kernel's ``ssim_eval_tiles``: one partial per strip and GROUP
    output rows of an image plane, at the narrower f32 strips; 0 below
    the window."""
    if h < WIN or w < WIN:
        return 0
    return (_cdiv(w - WIN + 1, strip_cols(torch.float32))
            * _cdiv(h - WIN + 1, GROUP))


def _lib():
    lib = _build.load("ssim_eval")
    fn = lib.ssim_eval
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2 +
                       [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int] +
                       [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 +
                       [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.ssim_eval_tiles.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.ssim_eval_tiles.restype = ctypes.c_int
    return lib


def _launch(img1: torch.Tensor, img2: torch.Tensor,
            data_range: float) -> torch.Tensor:
    """[B,H,W,C] pairs on the card -> [B] f32 by the kernel."""
    if img1.shape != img2.shape or img1.ndim != 4:
        raise ValueError(f"ssim_eval kernel: images {tuple(img1.shape)} and "
                         f"{tuple(img2.shape)} must be the same [B,H,W,C]")
    if img2.device != img1.device:
        raise ValueError("ssim_eval kernel: both images must be on one device")
    if img1.dtype != torch.uint8 or img2.dtype != torch.uint8:
        # the kernel reads uint8 or f32; JAX casts in its kernel
        img1, img2 = img1.to(torch.float32), img2.to(torch.float32)
    if img1.stride() != img2.stride():
        img1, img2 = img1.contiguous(), img2.contiguous()
    b, h, w, c = img1.shape
    dev = img1.device
    lib = _lib()
    tiles = lib.ssim_eval_tiles(h, w)
    # the [B] result and the [B, C * tiles] partials: one allocation
    buf = torch.empty(b + b * c * tiles, dtype=torch.float32, device=dev)
    out, partials = buf[:b], buf[b:]
    strides = (ctypes.c_longlong * 4)(*img1.stride())
    here = dev.index is None or dev.index == torch.cuda.current_device()
    with contextlib.nullcontext() if here else torch.cuda.device(dev):
        err = lib.ssim_eval(img1.data_ptr(), img2.data_ptr(), strides,
                            int(img1.dtype == torch.float32),
                            partials.data_ptr(), out.data_ptr(), b, h, w, c,
                            (0.01 * data_range) ** 2, (0.03 * data_range) ** 2,
                            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"ssim_eval kernel launch failed: CUDA error {err}")
    ssim_eval_fused.launches += 1
    return out


def _route(img1, img2, data_range):
    if img1.device.type == "cpu":
        return ssim_eval(img1, img2, data_range=data_range)
    if img1.device.type != "cuda":
        raise ValueError(f"ssim_eval: unsupported device {img1.device}")
    return _launch(img1, img2, data_range)


def ssim_eval_fused(img1: torch.Tensor, img2: torch.Tensor,
                    data_range: float = 255.0) -> torch.Tensor:
    """[B,H,W,C] (or [B,H,W]) pairs -> [B] f32 SSIM: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if img1.ndim == 3:
        img1, img2 = img1[..., None], img2[..., None]
    return _route(img1, img2, data_range)


def ssim_eval_tiled(img1: torch.Tensor, img2: torch.Tensor,
                    data_range: float = 255.0) -> torch.Tensor:
    """The JAX package's row-tiled entry point (1080p/4K); on the card the
    same kernel as :func:`ssim_eval_fused`, which tiles every size."""
    return ssim_eval_fused(img1, img2, data_range)


def ssim_eval_auto(img1: torch.Tensor, img2: torch.Tensor,
                   data_range: float = 255.0) -> torch.Tensor:
    """``ssim_eval``'s signature ([N,H,W,C] -> [N], or [H,W,C] -> a
    scalar): the kernel for CUDA tensors, the plain version for CPU ones."""
    if img1.ndim == 3:
        return _route(img1[None], img2[None], data_range)[0]
    return _route(img1, img2, data_range)


ssim_eval_fused.launches = 0
