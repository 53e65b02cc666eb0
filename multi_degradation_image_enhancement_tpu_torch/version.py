"""The port's version (counterpart of ``multi_degradation_image_enhancement_tpu/version.py``)."""

__version__ = "0.1.0"
