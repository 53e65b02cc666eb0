"""Re-estimate the BatchNorm statistics of a trained checkpoint (counterpart of
``tools/recalibrate_bn.py``):

    python -m multi_degradation_image_enhancement_tpu_torch.recalibrate_bn \\
        -c multi_degradation_image_enhancement_tpu/config/noise_synthetic.json [--passes 3]

The operation of ``train.bn_recalibration``, after the fact: the config's
train session (``run.build_session``: same dataset, loader and device) and
``Model.recalibrate_bn``, i.e. ``passes`` frozen-weight, dropout-free sweeps
of the training data in ``stats_refresh`` mode.  The checkpoint at
``train.model_path/model_name`` is rewritten with the new statistics (the
parameters are untouched) and the original is kept beside it as
``<name>.prerecal``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from multi_degradation_image_enhancement_tpu_torch.run import build_session
from multi_degradation_image_enhancement_tpu_torch.utils.config import load_config


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Re-estimate a checkpoint's BatchNorm statistics.")
    parser.add_argument("-c", "--config", required=True, help="Path to the JSON configuration file")
    parser.add_argument("--passes", type=int, default=3, help="sweeps of the training data")
    args = parser.parse_args(argv)
    logger, engine = build_session(load_config(args.config, phase="train"))
    try:
        engine.recalibrate_bn(passes=args.passes)
    finally:
        logger.close()


if __name__ == "__main__":
    main()
