"""The FLOP counts of ``h100bench.flops`` against forward hooks on the port's
modules, which count 2 per multiply-add of every conv, deconv and linear."""

import pytest
import torch

from h100bench import flops


def _hook_count(module, *inputs):
    total = []

    def hook(m, inp, out):
        if isinstance(m, torch.nn.Linear):
            total.append(2 * m.in_features * m.out_features * out.shape[0])
        elif isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            k = m.kernel_size[0] * m.kernel_size[1]
            c_in = m.in_channels // m.groups
            total.append(2 * k * c_in * m.out_channels * out.shape[0] * out.shape[2] * out.shape[3])

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    try:
        with torch.no_grad():
            module(*inputs)
    finally:
        for h in handles:
            h.remove()
    return sum(total)


def test_cdan_forward_count_matches_hooks_at_256():
    from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN

    model = CDAN().eval()
    counted = _hook_count(model, torch.rand(1, 256, 256, 3))
    assert counted == pytest.approx(flops.cdan_forward_flops(256, 256), rel=1e-9)
    assert flops.cdan_forward_flops(256, 256) / 1e9 == pytest.approx(16.570, abs=5e-4)


@pytest.mark.parametrize("hw", [(64, 96), (48, 80)])
def test_loss_network_counts_match_hooks(hw):
    from multi_degradation_image_enhancement_tpu_torch.ops.perceptual import (
        AlexNetFeatures,
        VGG19Features,
    )

    h, w = hw
    assert _hook_count(VGG19Features(20), torch.rand(1, h, w, 3)) == pytest.approx(
        flops.vgg19_20_flops(h, w), rel=1e-9)
    assert _hook_count(AlexNetFeatures(), torch.rand(1, 3, h, w)) == pytest.approx(
        flops.alex_flops(h, w), rel=1e-9)


def test_roofline_never_counts_more_than_the_work():
    work = flops.dense_block_work(flops.dense_block_shapes(128, 256, 256))
    t, binds = flops.bound(*work)
    assert binds == "operations" and flops.roofline_share(work, t) == pytest.approx(100.0)
    f_fwd, _ = flops.growth_train_work(16, 256, 384, False)
    f_bwd, _ = flops.growth_train_work(16, 256, 384, True)
    assert f_bwd == 2 * f_fwd
