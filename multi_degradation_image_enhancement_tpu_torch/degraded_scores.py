"""Score the degraded inputs themselves: the test phase's metrics of the
identity restorer, the floor a trained restorer has to beat.

    python -m multi_degradation_image_enhancement_tpu_torch.degraded_scores \\
        -c multi_degradation_image_enhancement_tpu/config/blur_synthetic.json

Builds the config's test session (same dataset, degradation, seed, batch and
device as ``run -p test``) and averages the metrics pipeline of each batch's
inputs against its targets over the batches, as the test phase averages its
PRE metrics.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json

import torch

from multi_degradation_image_enhancement_tpu_torch.engine.model import _mean_of_dicts
from multi_degradation_image_enhancement_tpu_torch.run import build_session
from multi_degradation_image_enhancement_tpu_torch.utils.config import load_config


@torch.inference_mode()
def degraded_scores(config) -> dict:
    """Mean over the test loader's batches of the metrics of input vs target."""
    logger, engine = build_session(config)
    logger.close()
    per_batch = [engine.metrics_pipe(inputs, targets=targets, mask=mask)
                 for inputs, targets, mask in engine.dataloader]
    return _mean_of_dicts(per_batch)


def _cli():
    parser = argparse.ArgumentParser(description="Metrics of the degraded test inputs.")
    parser.add_argument("-c", "--config", required=True, help="Path to the JSON configuration file")
    args = parser.parse_args()
    cfg = load_config(args.config, phase="test")
    cfg["logging"] = {"enabled": False}
    print(json.dumps({"config": args.config, "degraded_input": degraded_scores(cfg)}))


if __name__ == "__main__":
    _cli()
