"""PyTorch / CUDA port of multi_degradation_image_enhancement_tpu for NVIDIA Hopper."""

from multi_degradation_image_enhancement_tpu_torch.version import __version__

__all__ = ["__version__"]
