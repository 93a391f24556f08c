from .flow import FlowInterpolator  # noqa: F401
from .tower import TowerInterpolator  # noqa: F401
from .unet import (DoubleConv, Down, FrameInterpolationUNet, UNet, Up,  # noqa: F401
                   count_parameters, fold_batchnorm)

# model-family registry: ModelConfig.arch -> module class
MODEL_REGISTRY = {
    "unet": FrameInterpolationUNet,
    "tower": TowerInterpolator,
    "flow": FlowInterpolator,
}


def build_model(cfg, compute_dtype=None, folded=False, pack=1):
    """Construct the configured model family (weights as PyTorch's default
    init; callers load a state dict or initialise them). ``pack`` g > 1
    builds the U-Net family's batch-packed core (folded weights only)."""
    import torch

    cdt = compute_dtype or torch.bfloat16
    if pack > 1:
        if cfg.arch != "unet":
            raise ValueError(f"pack > 1 is for the U-Net family, not "
                             f"arch={cfg.arch!r}")
        return FrameInterpolationUNet(cfg, cdt, folded=folded, pack=pack)
    return MODEL_REGISTRY[cfg.arch](cfg, cdt, folded=folded)
