"""PyTorch / CUDA port of multi_degradation_image_enhancement_tpu for NVIDIA Hopper."""

__version__ = "0.1.0"
