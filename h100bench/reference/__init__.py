"""The plain reference that decides ``correct``: CDAN, its loss terms and
Adam in plain PyTorch float32 (TF32 off), written from the published model
(``models/cdan.py`` and ``models/cbam.py`` of
danielluca00/Multi-Degradation-Image-Enhancement) and the recipes' loss
terms.  It imports nothing of the program under test, of the JAX package or
of ``jax``, and works only from the weights, inputs and dropout masks that
the harness made.

``quant="fp8"`` is the control, the reference in the precision below the
configuration's bf16, as FP8 training runs it: every CDAN conv and linear
takes its operands in float8 e4m3 and, in the backward, the gradient
reaching it in float8 e5m2, each with a per-tensor scale (f32 accumulation).
"""

import contextlib

import torch


@contextlib.contextmanager
def exact_f32():
    """TF32 off for matmuls and cuDNN convs inside the block, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
