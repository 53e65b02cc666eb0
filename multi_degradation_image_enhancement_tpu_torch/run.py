"""CLI runner of the PyTorch port (counterpart of ``run.py`` at the repo root):

    python -m multi_degradation_image_enhancement_tpu_torch.run \\
        -c multi_degradation_image_enhancement_tpu/config/noise_synthetic.json -p train
    python -m multi_degradation_image_enhancement_tpu_torch.run \\
        -c multi_degradation_image_enhancement_tpu/config/noise_synthetic.json -p test

The same ``-c/-p`` contract and config files as the JAX runner (read as
files; nothing of the JAX package is imported).  ``-p train`` trains,
writes the checkpoint and draws the loss curves into the run directory's
``plots/``; ``-p test`` scores it.  The phase's block picks the
device (``train.device`` / ``test.device``): missing, null, ``"cuda"`` or
``"tpu"`` → CUDA (raises without a card), ``"cpu"`` → CPU.

Several GPUs (``train.mesh``, ``parallel.mesh``), one process each::

    torchrun --nproc_per_node N -m multi_degradation_image_enhancement_tpu_torch.run \
        -c cfg.json -p train

Under torchrun (its ``WORLD_SIZE`` set, at any size) the process joins the
process group first (``parallel.distributed.initialize``: ``nccl`` on the
card, ``gloo`` for a ``"cpu"`` phase); only rank 0 logs and writes.
"""

from __future__ import annotations

import argparse

from multi_degradation_image_enhancement_tpu_torch.data.loader import define_dataloader
from multi_degradation_image_enhancement_tpu_torch.engine.model import resolve_device
from multi_degradation_image_enhancement_tpu_torch.parallel import distributed
from multi_degradation_image_enhancement_tpu_torch.utils.config import load_config
from multi_degradation_image_enhancement_tpu_torch.utils.logger import ExperimentLogger
from multi_degradation_image_enhancement_tpu_torch.utils.registry import (
    create_model,
    define_dataset,
    define_network,
)
from multi_degradation_image_enhancement_tpu_torch.utils.rng import set_seed_and_cudnn


def build_session(config):
    """Resolve a config into ``(logger, engine)`` without running anything."""
    phase = config["phase"]
    phase_cfg = config[phase]
    device = resolve_device(phase_cfg["device"])
    if distributed.launched_by_torchrun():
        distributed.initialize(backend="gloo" if device.type == "cpu" else None)
    set_seed_and_cudnn()
    if not distributed.is_primary():  # rank 0 alone logs, writes runs and plots
        config = {**config, "logging": {**(config.get("logging") or {}), "enabled": False}}
    logger = ExperimentLogger(config)
    network = define_network(config["model"]["networks"][0])
    dataset = define_dataset(phase_cfg["dataset"])
    dataloader = define_dataloader(dataset, phase_cfg["dataloader"]["args"], device)
    engine = create_model(config=config, network=network, dataloader=dataloader, logger=logger)
    return logger, engine


def main(config):
    logger, engine = build_session(config)
    if logger.run_dir():
        print(f"[LOGGER] Run dir: {logger.run_dir()}")
    try:
        if config["phase"] == "train":
            engine.train()
            logger.generate_plots()
        else:
            engine.test()
    finally:
        logger.close()
    return engine


def _cli():
    parser = argparse.ArgumentParser(
        description="Train or evaluate a restoration task from a JSON config (PyTorch port).")
    parser.add_argument("-c", "--config", type=str,
                        default="multi_degradation_image_enhancement_tpu/config/noise_synthetic.json",
                        help="Path to the JSON configuration file")
    parser.add_argument("-p", "--phase", type=str, choices=["train", "test"], default="train",
                        help="Phase to run (train or test)")
    return parser.parse_args()


if __name__ == "__main__":
    args = _cli()
    main(load_config(args.config, phase=args.phase))
