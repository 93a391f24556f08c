from .flow import FlowInterpolator  # noqa: F401
from .tower import TowerInterpolator  # noqa: F401
from .unet import (DoubleConv, Down, FrameInterpolationUNet, UNet, Up,  # noqa: F401
                   count_parameters, fold_batchnorm)


def build_model(cfg, compute_dtype=None, folded=False):
    """Construct the configured model family (weights as PyTorch's default
    init; callers load a state dict or initialise them)."""
    import torch

    cdt = compute_dtype or torch.bfloat16
    families = {"unet": FrameInterpolationUNet, "tower": TowerInterpolator,
                "flow": FlowInterpolator}
    return families[cfg.arch](cfg, cdt, folded=folded)
