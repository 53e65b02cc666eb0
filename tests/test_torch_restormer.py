"""PyTorch port: Restormer (``models/restormer.py``) against the benchmark's
plain float32 reference (``h100bench/reference/restormer.py``), on the
harness's seeded weights (``h100bench/weights_restormer.py``) and noisy
procedural images, on the CPU:

* at published widths the network has 26,111,668 parameters under the
  published module names, and 44 transformer blocks;
* the module and the float32 served forward equal the reference within
  :data:`F32_TOL` at a reduced width (dim 8, one block a level, B=2·32×48),
  both LayerNorm types, and at published widths (B=1·16×24);
* the bf16 served forward errs at most :data:`BF16_RATIO` times as far as the
  reference with every conv's and attention product's operands rounded to
  bf16 (the cell's witness);
* through the engine on a tiny config, ``-p train`` runs a step and ``-p
  test`` scores through ``serving_forward``; ``train.fused_dense`` /
  ``train.remat`` on a Restormer stop the build;
* under a profiler the served forward's spans appear (``serve/forward``
  once, ``restormer/mdta`` and ``restormer/gdfn`` 44 times each,
  ``restormer/dwconv`` 88 times) and its counters add 44 each; with none,
  no span is built;
* ``flax_lecun_std`` takes a grouped conv's fan-in per group, and a CDAN's
  draws from a seed are what they were;
* ``flops_restormer`` counts what ``FlopCounterMode`` counts over the
  reference: 309.76 GFLOP at 256², 1,452.02 at 480×640.
"""

import json
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from h100bench import flops_restormer, traffic, weights_restormer
from h100bench.reference.restormer import RefRestormer, restormer_shapes
from multi_degradation_image_enhancement_tpu_torch import run
from multi_degradation_image_enhancement_tpu_torch.engine import model as engine_model
from multi_degradation_image_enhancement_tpu_torch.engine.model import Model
from multi_degradation_image_enhancement_tpu_torch.models import restormer, torch_init
from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN
from multi_degradation_image_enhancement_tpu_torch.models.restormer import Restormer, serving_forward
from multi_degradation_image_enhancement_tpu_torch.utils import registry, tracing
from multi_degradation_image_enhancement_tpu_torch.utils.config import load_config

from tests.torch_train_cli import ROOT

CONFIG = ROOT / "multi_degradation_image_enhancement_tpu_torch" / "config" / "restormer_noise_synthetic.json"
SMALL = {"dim": 8, "num_blocks": [1, 1, 1, 1], "num_refinement_blocks": 1}
# float32 against float32 in another order of operations (the Gram divided by
# the norms after it, rsqrt for LayerNorm's divide): at most 5.8e-6 measured
# at published widths, 1.6e-6 at the reduced width, on outputs of mean
# |out - x| 0.26-0.56.  A wrong operation moves the output by 1e-2 or more
# (rounding to bf16 alone moves it 2e-3 on average).
F32_TOL = 5e-5
# The bf16 served forward against the witness (the reference with every
# conv's and attention product's operands rounded to bf16): its mean gap was
# 1.10-1.23x the witness's over these cases (1.12-1.52x while the Gram was
# rounded to bf16); FP8 operands read 8-19x and a planted fault 20-50x.
BF16_RATIO = 3.0
CASES = {
    "small_biasfree": (SMALL, 2, 32, 48),
    "small_withbias": (dict(SMALL, layer_norm_type="WithBias", bias=True), 2, 32, 48),
    "published": ({}, 1, 16, 24),
}


def _setup(args, b, h, w, seed=0):
    gen = torch.Generator().manual_seed(seed)
    state = weights_restormer.restormer_state(gen, {"network": {"args": args}}, "cpu")
    x = traffic.serve_pool(gen, {"batch": b, "height": h, "width": w, "pool": 1},
                           {"name": "noise", "sigma": [10, 50]}, "cpu")[0]
    model = Restormer(**args)
    model.load_state_dict(state)
    return state, x, model.eval()


def test_published_widths_parameter_count_and_names():
    model = Restormer()
    assert sum(p.numel() for p in model.parameters()) == 26_111_668
    shapes = restormer_shapes()
    assert [(k, tuple(v.shape)) for k, v in model.state_dict().items()] == list(shapes.items())
    assert sum(isinstance(m, restormer.TransformerBlock) for m in model.modules()) == 44
    assert registry.resolve("models.restormer", "Restormer") is Restormer
    assert registry.resolve("multi_degradation_image_enhancement_tpu_torch.models.restormer",
                            "Restormer") is Restormer


@pytest.mark.parametrize("case", list(CASES))
def test_module_and_f32_served_forward_equal_the_reference(case):
    state, x, model = _setup(*CASES[case])
    with torch.no_grad():
        want = RefRestormer(state)(x)
        assert (model(x) - want).abs().max() <= F32_TOL
        assert (serving_forward(model, torch.float32, "cpu")(x) - want).abs().max() <= F32_TOL


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_served_forward_within_bf16_rounding_of_the_reference(case):
    state, x, model = _setup(*CASES[case], seed=1)
    with torch.no_grad():
        want = RefRestormer(state)(x)
        witness = (RefRestormer(state, "bf16")(x) - want).abs().mean()
        got = serving_forward(model, torch.bfloat16, "cpu")(x)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert (got - want).abs().mean() <= BF16_RATIO * witness


def test_a_depthwise_conv_is_drawn_at_its_per_group_fan_in():
    dw = torch.nn.Conv2d(510, 510, 3, groups=510)
    assert torch_init.flax_lecun_std(dw) == pytest.approx(math.sqrt(1 / 9) / torch_init.TRUNCATED_STD)
    dense = torch.nn.Conv2d(64, 16, 3)
    assert torch_init.flax_lecun_std(dense) == pytest.approx(
        math.sqrt(1 / (9 * 64)) / torch_init.TRUNCATED_STD)


def test_a_cdan_draws_what_it_drew_before_the_grouped_fan_in():
    """The draw loop with the fan-in as it was (kh·kw·in_channels, no groups),
    against ``flax_default_init_``: CDAN has no grouped conv, so every
    tensor is bit for bit the same."""
    got = torch_init.flax_default_init_(CDAN(), torch.Generator().manual_seed(7)).state_dict()
    gen, want = torch.Generator().manual_seed(7), CDAN()
    with torch.no_grad():
        for m in want.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear)):
                fan_in = m.in_features if isinstance(m, torch.nn.Linear) else (
                    m.kernel_size[0] * m.kernel_size[1] * m.in_channels)
                std = math.sqrt(1.0 / fan_in) / torch_init.TRUNCATED_STD
                w = torch.empty(m.weight.shape)
                torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.reset_parameters()
    for k, v in want.state_dict().items():
        assert torch.equal(got[k], v), k


def _tiny_config(tmp_path, **train):
    cfg = json.loads(json.dumps(load_config(str(CONFIG))))
    assert cfg["model"]["networks"][0]["name"] == ["models.restormer", "Restormer"]
    assert not {"fused_dense", "remat", "bn_recalibration"} & set(cfg["train"])
    cfg["model"]["networks"][0]["args"].update(SMALL)
    tr, te = cfg["train"], cfg["test"]
    tr.update(device="cpu", n_epoch=1, precision="fp32", model_path=str(tmp_path / "weights"), **train)
    te.update(device="cpu", model_path=str(tmp_path / "weights"), fused_kernels=True)
    tr["dataset"]["args"]["n_images"] = 2
    te["dataset"]["args"]["n_images"] = 3
    for block in (tr, te):
        for op in block["dataset"]["args"]["transform"]["ops"]:
            if op["name"] == "Resize":
                op["args"] = {"height": 32, "width": 48}
        block["dataloader"]["args"]["batch_size"] = 2
    cfg["save_outputs"]["output_dir"] = str(tmp_path / "outputs")
    cfg["logging"]["root_dir"] = str(tmp_path / "runs")
    path = tmp_path / "tiny_restormer.json"
    path.write_text(json.dumps(cfg))
    return path


def test_engine_trains_a_step_and_tests_through_the_served_forward(tmp_path, monkeypatch):
    path = _tiny_config(tmp_path)
    run.main(load_config(str(path), phase="train"))
    assert (tmp_path / "weights" / "Restormer_noise_synthetic.pt").is_file()
    (csv_path,) = (tmp_path / "runs").glob("restormer_noise_synthetic/*/train.csv")
    header, row = csv_path.read_text().splitlines()
    assert math.isfinite(float(dict(zip(header.split(","), row.split(",")))["loss_total"]))

    built = []

    def spy(model, dtype, device):
        built.append((type(model).__name__, dtype, str(device)))
        return serving_forward(model, dtype, device)

    monkeypatch.setattr(engine_model, "serving_forward", spy)
    run.main(load_config(str(path), phase="test"))
    assert built == [("Restormer", torch.float32, "cpu")]
    assert sorted(p.name for p in (tmp_path / "outputs").glob("*.png")) == [
        "raw_1.png", "raw_2.png", "raw_3.png"]


@pytest.mark.parametrize("key", ["fused_dense", "remat"])
def test_cdan_train_options_on_a_restormer_stop_the_build(tmp_path, key):
    cfg = load_config(str(_tiny_config(tmp_path, **{key: True})), phase="train")
    with pytest.raises(ValueError, match=f"train.{key} name CDAN modules; the network is a "
                                         f"Restormer"):
        Model(network=Restormer(**SMALL), config=cfg, dataloader=[])


def test_auto_keeps_the_module_on_the_cpu_and_true_takes_the_served_forward(tmp_path):
    cfg = load_config(str(_tiny_config(tmp_path)), phase="test")
    engine = Model(network=Restormer(**SMALL), config=cfg, dataloader=None)
    assert isinstance(engine._fused_eval_forward(Restormer(**SMALL).eval()),
                      restormer.ServingForward)
    cfg["test"]["fused_kernels"] = "auto"
    engine = Model(network=Restormer(**SMALL), config=cfg, dataloader=None)
    assert engine._fused_eval_forward(Restormer(**SMALL).eval()) is None


def test_spans_and_counters_under_a_profiler_and_nothing_without(monkeypatch):
    _, x, model = _setup({}, 1, 16, 24)
    apply = serving_forward(model, torch.bfloat16, "cpu")
    built = []
    span_class = tracing._Span

    def counting(*args):
        built.append(args[0])
        return span_class(*args)

    monkeypatch.setattr(tracing, "_Span", counting)
    apply(x)
    assert built == [] and (apply.mdta_calls, apply.gdfn_calls) == (44, 44)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        apply(x)
    names = [e.name for e in prof.events()]
    assert [names.count(n) for n in ("serve/forward", "restormer/mdta", "restormer/gdfn",
                                     "restormer/dwconv")] == [1, 44, 44, 88]
    assert (apply.mdta_calls, apply.gdfn_calls) == (88, 88)


@pytest.mark.parametrize("hw, gflop", [((256, 256), 309.764063232), ((480, 640), 1452.0190464)])
def test_flops_restormer_counts_what_the_flop_counter_counts(hw, gflop):
    from torch.utils.flop_counter import FlopCounterMode

    state = {k: torch.empty(s, device="meta") for k, s in restormer_shapes().items()}
    with FlopCounterMode(display=False) as counter:
        RefRestormer(state)(torch.empty(1, *hw, 3, device="meta"))
    assert counter.get_total_flops() == pytest.approx(gflop * 1e9, rel=1e-12)
    assert flops_restormer.forward_flops(*hw) == pytest.approx(gflop * 1e9, rel=1e-12)
    assert len(flops_restormer.mdta_work(4, *hw)) == 44
