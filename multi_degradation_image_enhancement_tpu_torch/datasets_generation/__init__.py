"""Offline dataset generators (counterpart of ``multi_degradation_image_enhancement_tpu/datasets_generation``)."""
