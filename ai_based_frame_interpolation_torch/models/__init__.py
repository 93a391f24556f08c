from .flow import FlowInterpolator  # noqa: F401
from .unet import (DoubleConv, Down, FrameInterpolationUNet, UNet, Up,  # noqa: F401
                   count_parameters, fold_batchnorm)


def build_model(cfg, compute_dtype=None, folded=False):
    """Construct the configured model family (weights as PyTorch's default
    init; callers load a state dict or initialise them)."""
    import torch

    cdt = compute_dtype or torch.bfloat16
    if cfg.arch == "flow":
        return FlowInterpolator(cfg, cdt, folded=folded)
    if cfg.arch != "unet":
        raise NotImplementedError(
            f"the {cfg.arch!r} family is not ported yet (ROADMAP Queue A "
            "item 11)")
    return FrameInterpolationUNet(cfg, cdt, folded=folded)
