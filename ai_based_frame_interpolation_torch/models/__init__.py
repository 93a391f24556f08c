from .unet import (DoubleConv, Down, FrameInterpolationUNet, UNet, Up,  # noqa: F401
                   count_parameters, fold_batchnorm)


def build_model(cfg, compute_dtype=None, folded=False):
    """Construct the configured model family (weights as PyTorch's default
    init; callers load a state dict or initialise them)."""
    import torch

    if cfg.arch != "unet":
        raise NotImplementedError(
            f"the {cfg.arch!r} family is not ported yet (ROADMAP Queue A "
            f"item {8 if cfg.arch == 'flow' else 11})")
    return FrameInterpolationUNet(cfg, compute_dtype or torch.bfloat16,
                                  folded=folded)
