"""PyTorch port: the routed serving pipeline against the JAX package's.

* ``RoutedRestorer`` against the JAX ``RoutedRestorer`` on ``tests/tiny_net``
  experts and a torch counterpart carrying the same weights: top1 with a
  capacity overflow and a clean passthrough, sequential ``fixed``,
  ``severity`` and ``severity_asc`` with a tie (1e-5);
* the slice as a whole: the port's ``run_pipeline`` CLI on the CPU (3 images
  at 32×48, 3 full-width experts) against the JAX ``FullPipeline`` in process
  on the same weights: probabilities within 1e-4, the same route for every
  image, passthrough images bit-equal, restored images within the fused
  forward's tolerance (tests/test_cdan_fast.py:36: max 2e-2, mean 2e-3);
* the expert bank in bf16 on the CPU (the eval module under autocast, the
  JAX pipeline's route) against the JAX bank of ``CDAN(dtype=bfloat16)``,
  held to twice the JAX bank's own bf16-vs-f32 distance, beside the fused
  forward's distance; ``load_expert_bank`` builds the module route;
* ``resolve_thresholds`` and the u8 conversion of the CLI.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch import nn

from multi_degradation_image_enhancement_tpu.classification.model import (
    MultiHeadClassifier as JaxClassifier,
)
from multi_degradation_image_enhancement_tpu.models.cdan import CDAN as JaxCDAN
from multi_degradation_image_enhancement_tpu.pipeline import (
    FullPipeline as JaxFullPipeline,
    RoutedRestorer as JaxRoutedRestorer,
    stack_expert_variables,
)
from multi_degradation_image_enhancement_tpu_torch import run_pipeline
from multi_degradation_image_enhancement_tpu_torch.data.streaming import decode_chunk
from multi_degradation_image_enhancement_tpu_torch.ops.degradations import DEGRADATIONS
from multi_degradation_image_enhancement_tpu_torch.models.cdan_fast import build_serving_apply
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import dense_block
from multi_degradation_image_enhancement_tpu_torch.pipeline import (
    CLEAN,
    DROPPED,
    RoutedRestorer,
    load_expert_bank,
)
from multi_degradation_image_enhancement_tpu_torch.utils.jax_port import (
    classifier_mapping,
    convert_entries,
    state_dict_to_flax,
)
from tests.tiny_net import TinyNet
from tests.torch_pipeline_cli import (
    EXPERTS,
    HW,
    cli_args,
    write_thresholds,
    write_tiny_pipeline,
)

NAMES = ["noise", "blur", "low_light"]


class TorchTinyNet(nn.Module):
    """``tests/tiny_net.TinyNet`` in eval mode, NHWC in and out."""

    ENTRIES = [(("Conv_0",), "conv0", "conv"), (("BatchNorm_0",), "bn", "bn"),
               (("Conv_1",), "conv1", "conv")]

    def __init__(self, features: int = 8):
        super().__init__()
        self.conv0 = nn.Conv2d(3, features, 3, padding=1)
        self.bn = nn.BatchNorm2d(features)
        self.conv1 = nn.Conv2d(features, 3, 3, padding=1)

    def forward(self, x_nhwc):
        x = x_nhwc.permute(0, 3, 1, 2)
        h = self.conv1(torch.relu(self.bn(self.conv0(x))))
        return torch.sigmoid(h + x).permute(0, 2, 3, 1).float()


@pytest.fixture(scope="module")
def tiny_bank():
    """(JAX net, stacked JAX variables, torch forwards) of three TinyNets
    with random BatchNorm statistics, the same weights on both sides."""
    net = TinyNet()
    rng = np.random.RandomState(0)
    variables, forwards = [], []
    for i in range(3):
        v = net.init({"params": jax.random.key(i)}, jnp.zeros((1, 16, 24, 3)), train=False)
        v = {"params": jax.tree.map(np.asarray, v["params"]),
             "batch_stats": jax.tree.map(lambda t: rng.uniform(0.5, 1.5, t.shape).astype(np.float32),
                                         v["batch_stats"])}
        variables.append(v)
        module = TorchTinyNet()
        module.load_state_dict(convert_entries(v, TorchTinyNet.ENTRIES), strict=True)
        module.eval()
        forwards.append(torch.no_grad()(module))
    return net, stack_expert_variables(variables), forwards


# (mode, ordering, capacity factor, probs, thresholds, severities, top1 routes or sequential order)
CASES = {
    # capacity ceil(8/3 * 1.0) = 3: images 0-4 argmax expert 0, so 3 and 4
    # are dropped; image 5 is clean; image 6's argmax (expert 1, 0.6 < its
    # 0.9) is taken because expert 2 clears its own threshold.
    "top1_overflow_and_clean": (
        "top1", "fixed", 1.0,
        [[0.9, 0.1, 0.1]] * 5 + [[0.2, 0.1, 0.1], [0.2, 0.6, 0.4], [0.1, 0.2, 0.8]],
        [0.5, 0.9, 0.3], None, [0, 0, 0, DROPPED, DROPPED, CLEAN, 1, 2]),
    "sequential_fixed": (
        "sequential", "fixed", 2.0,
        [[0.9, 0.9, 0.0], [0.0, 0.0, 0.0], [0.6, 0.0, 0.7], [0.1, 0.8, 0.9]],
        [0.5, 0.5, 0.5], None, [0, 1, 2]),
    "severity": (
        "sequential", "severity", 2.0,
        [[0.9, 0.9, 0.0], [0.9, 0.9, 0.6], [0.0, 0.9, 0.9], [0.1, 0.1, 0.1]],
        [0.5, 0.5, 0.5], [[0.2, 0.8, 0.1], [0.4, 0.6, 0.9], [0.3, 0.5, 0.5], [0.9, 0.9, 0.9]],
        [2, 1, 0]),
    "severity_asc": (
        "sequential", "severity_asc", 2.0,
        [[0.9, 0.9, 0.0], [0.9, 0.9, 0.6], [0.0, 0.9, 0.9], [0.1, 0.1, 0.1]],
        [0.5, 0.5, 0.5], [[0.2, 0.8, 0.1], [0.4, 0.6, 0.9], [0.3, 0.5, 0.5], [0.9, 0.9, 0.9]],
        [0, 1, 2]),
    # experts 0 and 2 tie on mean severity 0.5: a stable sort keeps bank
    # order between them, in both directions
    "severity_tie": (
        "sequential", "severity", 2.0,
        [[0.9, 0.9, 0.9], [0.9, 0.9, 0.9]], [0.5, 0.5, 0.5],
        [[0.5, 0.7, 0.25], [0.5, 0.9, 0.75]], [1, 0, 2]),
    "severity_asc_tie": (
        "sequential", "severity_asc", 2.0,
        [[0.9, 0.9, 0.9], [0.9, 0.9, 0.9]], [0.5, 0.5, 0.5],
        [[0.5, 0.7, 0.25], [0.5, 0.9, 0.75]], [0, 2, 1]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_routed_restorer_matches_jax(tiny_bank, case):
    net, stacked, forwards = tiny_bank
    mode, ordering, cf, probs, thr, sevs, expect = CASES[case]
    probs = np.asarray(probs, np.float32)
    sevs = None if sevs is None else np.asarray(sevs, np.float32)
    x = np.random.RandomState(len(case)).rand(len(probs), 16, 24, 3).astype(np.float32)

    jax_router = JaxRoutedRestorer(net, NAMES, stacked, mode=mode, capacity_factor=cf,
                                   ordering=ordering)
    want = np.asarray(jax_router(jnp.asarray(x), jnp.asarray(probs), thr,
                                 severities=None if sevs is None else jnp.asarray(sevs)))
    router = RoutedRestorer(forwards, NAMES, mode=mode, capacity_factor=cf, ordering=ordering)
    tp, tthr = torch.from_numpy(probs), torch.tensor(thr)
    ts = None if sevs is None else torch.from_numpy(sevs)
    got = router(torch.from_numpy(x), tp, thr, severities=ts).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if mode == "top1":
        routes = router.route(tp, tthr).tolist()
        assert routes == expect
        for i, r in enumerate(routes):
            if r < 0:  # dropped and clean images pass through untouched
                np.testing.assert_array_equal(got[i], x[i])
    else:
        assert router.order(tp, tthr, ts) == expect
        untouched = ~(probs >= np.asarray(thr)).any(axis=1)
        np.testing.assert_array_equal(got[untouched], x[untouched])


def test_invalid_mode_and_ordering_raise(tiny_bank):
    forwards = tiny_bank[2]
    with pytest.raises(ValueError, match="mode"):
        RoutedRestorer(forwards, NAMES, mode="bogus")
    with pytest.raises(ValueError, match="ordering"):
        RoutedRestorer(forwards, NAMES, mode="sequential", ordering="bogus")


def _jax_routes(probs: np.ndarray, thr: np.ndarray, capacity: int) -> list:
    """The routes of the JAX top1 dispatch (``pipeline.py:164-197``) in NumPy:
    one-hot argmax of the active images, rank in bucket by cumsum, kept
    below capacity."""
    n = probs.shape[1]
    onehot = np.eye(n)[probs.argmax(-1)] * (probs >= thr).any(-1)[:, None]
    position = (np.cumsum(onehot, axis=0) - 1.0) * onehot
    kept = ((position < capacity) * onehot).any(-1)
    return np.where(kept, probs.argmax(-1), np.where(onehot.any(-1), DROPPED, CLEAN)).tolist()


def _separating_thresholds(probs: np.ndarray):
    """Per-expert thresholds from the port's own probabilities that leave one
    image clean and make at least one other active, each probability as far
    (in 1e-4 units) from its threshold as such a choice allows: in each
    column, halfway between the clean image's value and the next one above
    it.  Returns (thresholds, margin)."""
    best = None
    for c in range(probs.shape[0]):
        thr = np.empty(probs.shape[1], np.float32)
        for e, col in enumerate(probs.T):
            above = np.sort(col[col > col[c]])
            thr[e] = (col[c] + above[0]) / 2 if above.size else min(col[c] + 0.05, 1.0)
        active = (probs >= thr).any(axis=1)
        margin = float(np.abs(probs - thr).min())
        if active.any() and (best is None or margin > best[1]):
            best = (thr, margin)
    return best


@pytest.mark.parametrize("mode,ordering", [("top1", "fixed"), ("sequential", "severity")])
def test_cli_matches_jax_full_pipeline(tmp_path, mode, ordering):
    paths = write_tiny_pipeline(tmp_path)
    files = sorted(p.name for p in paths["images"].iterdir())
    u8 = decode_chunk([str(paths["images"] / f) for f in files], HW)
    pipe = run_pipeline.build_full_pipeline(str(paths["classifier"]), str(paths["weights"]),
                                            mode, ordering, device="cpu")
    names = pipe.router.expert_names
    thr_e, margin = _separating_thresholds(pipe.classify(run_pipeline.to_01(u8, "cpu")).numpy())
    assert margin > 1e-3, "the test's images should give separable probabilities"
    thr = {**dict.fromkeys(DEGRADATIONS, 0.5), **dict(zip(names, thr_e.tolist()))}
    write_thresholds(tmp_path, thr)

    out = tmp_path / "out"
    run_pipeline.main(cli_args(paths, out, "--save-probs", "--mode", mode, "--ordering", ordering))
    got_u8 = np.stack([np.asarray(Image.open(out / f"{f[:-4]}.png")) for f in files])
    rows = [json.loads(line) for line in (out / "probs.jsonl").read_text().splitlines()]
    assert [r["file"] for r in rows] == files
    got_probs = np.array([[r["probs"][n] for n in names] for r in rows], np.float32)

    clf_vars = state_dict_to_flax(paths["clf"].state_dict(), classifier_mapping())
    bank = stack_expert_variables(
        [state_dict_to_flax(paths["experts"][n].state_dict()) for n in names])
    jax_router = JaxRoutedRestorer(JaxCDAN(dtype=jnp.float32), names, bank, mode=mode,
                                   ordering=ordering)
    jax_pipe = JaxFullPipeline(JaxClassifier(num_classes=len(DEGRADATIONS)), clf_vars, jax_router,
                               [thr[c] for c in DEGRADATIONS], classes=list(DEGRADATIONS))
    restored, want_probs = jax_pipe(jnp.asarray(u8, jnp.float32) / 255.0)
    want_u8 = np.clip(np.asarray(restored) * 255.0, 0, 255).astype(np.uint8)
    want_probs = np.asarray(want_probs)
    assert np.abs(got_probs - want_probs).max() <= 1e-4

    # the route of each image: top1's expert, clean or dropped; sequential's
    # set of experts that apply
    thr_t = torch.from_numpy(thr_e)
    if mode == "top1":
        routes = pipe.router.route(torch.from_numpy(got_probs), thr_t).tolist()
        assert routes == _jax_routes(want_probs, thr_e, pipe.router.capacity(len(files)))
        restored_rows = [r >= 0 for r in routes]
    else:
        active = got_probs >= thr_e
        np.testing.assert_array_equal(active, want_probs >= thr_e)
        restored_rows = active.any(axis=1).tolist()
    assert any(restored_rows) and not all(restored_rows)
    identity = np.clip(run_pipeline.to_01(u8, "cpu").numpy() * 255.0, 0, 255).astype(np.uint8)
    for i, restored_row in enumerate(restored_rows):
        if not restored_row:  # clean or dropped: passed through
            np.testing.assert_array_equal(got_u8[i], want_u8[i])
            np.testing.assert_array_equal(got_u8[i], identity[i])
        else:
            d = np.abs(got_u8[i].astype(np.float64) - want_u8[i]) / 255.0
            assert d.max() <= 2e-2 and d.mean() <= 2e-3, (i, d.max(), d.mean())
            assert (got_u8[i] != u8[i]).any()  # an expert did run


def _bank_paths(paths) -> dict:
    return {n: str(paths["weights"] / f"CDAN_{n}.pt") for n in EXPERTS}


def test_expert_bank_bf16_matches_jax_bank(tmp_path):
    """The bank in bf16 against the JAX pipeline's, sequential ``fixed`` (every
    expert over the whole batch, each on the last one's output), on the same
    images and probabilities.  The floor is the JAX bank's own distance
    between ``CDAN(dtype=bfloat16)`` and ``CDAN(dtype=float32)``; the port is
    held to twice it (the rule tests/test_torch_train.py holds the fused
    train step to).  Measured at
    4×32×48: floor max 5.46e-3, mean 9.76e-4; the module route max 5.50e-3,
    mean 1.14e-3 from JAX's bf16 bank; the fused serving forward, which the
    bank ran before, max 5.97e-3, mean 1.18e-3.  On the CPU the two bf16
    routes sit about as far from JAX's bf16 rounding as bf16 sits from f32;
    the route, not this distance, is what the repair fixes (the card's
    phase 24 of chip_smoke.py measures what it changes there)."""
    paths = write_tiny_pipeline(tmp_path)
    names = list(EXPERTS)
    x = np.random.RandomState(1).rand(4, *HW, 3).astype(np.float32)
    probs = np.full((4, len(names)), 0.9, np.float32)
    thr = [0.5] * len(names)

    bank = stack_expert_variables(
        [state_dict_to_flax(paths["experts"][n].state_dict()) for n in names])
    want = {}
    for dt in (jnp.bfloat16, jnp.float32):
        router = JaxRoutedRestorer(JaxCDAN(dtype=dt), names, bank, mode="sequential",
                                   ordering="fixed")
        want[dt] = np.asarray(router(jnp.asarray(x), jnp.asarray(probs), thr))
    floor = np.abs(want[jnp.bfloat16] - want[jnp.float32])

    def run(forwards):
        router = RoutedRestorer(forwards, names, mode="sequential", ordering="fixed")
        out = router(torch.from_numpy(x), torch.from_numpy(probs), thr)
        return np.abs(out.numpy() - want[jnp.bfloat16])

    got_names, forwards = load_expert_bank(_bank_paths(paths), "cpu", torch.bfloat16)
    assert got_names == names
    err = run(forwards)
    fused = run([build_serving_apply(paths["experts"][n], torch.bfloat16, "cpu") for n in names])
    report = (f"floor max {floor.max():.3e} mean {floor.mean():.3e}; module max {err.max():.3e} "
              f"mean {err.mean():.3e}; fused max {fused.max():.3e} mean {fused.mean():.3e}")
    assert floor.max() > 0, report  # bf16 did round
    assert err.max() <= 2 * floor.max() and err.mean() <= 2 * floor.mean(), report


def test_load_expert_bank_builds_the_module_route(tmp_path, monkeypatch):
    """Each expert is the eval module (unfused DenseBlocks) on the device:
    f32 on the CPU equals ``model(x)`` bit for bit, bf16 runs it under a bf16
    autocast (convolutions in bf16), and no DenseBlock kernel is reached."""
    from multi_degradation_image_enhancement_tpu_torch.models import cdan as cdan_mod

    paths = write_tiny_pipeline(tmp_path)
    x = torch.from_numpy(np.random.RandomState(2).rand(2, *HW, 3).astype(np.float32))
    n0 = dense_block.launches
    names, forwards = load_expert_bank(_bank_paths(paths), "cpu", torch.float32)
    for name, forward in zip(names, forwards):
        model = paths["experts"][name]
        assert not model.fused_dense
        with torch.no_grad():
            assert torch.equal(forward(x), model(x))

    seen = []
    conv_forward = cdan_mod.nn.Conv2d._conv_forward

    def spy(self, t, w, b):
        y = conv_forward(self, t, w, b)
        seen.append(y.dtype)
        return y

    monkeypatch.setattr(cdan_mod.nn.Conv2d, "_conv_forward", spy)
    _, forwards = load_expert_bank(_bank_paths(paths), "cpu", torch.bfloat16)
    out = forwards[0](x)
    assert out.dtype == torch.float32 and out.shape == x.shape
    assert seen and set(seen) == {torch.bfloat16}
    assert dense_block.launches == n0


def test_stream_restore_raises_a_decode_error(tmp_path):
    """A file that does not decode reaches the caller as its error (the
    producer's sentinel), instead of leaving the loop waiting for ever."""
    import threading

    from multi_degradation_image_enhancement_tpu_torch.data.streaming import stream_restore

    Image.fromarray(np.zeros((*HW, 3), np.uint8)).save(tmp_path / "a.png")
    (tmp_path / "b.png").write_bytes(b"not a png")
    caught = []

    def run():
        try:
            stream_restore(["a.png", "b.png"], str(tmp_path), str(tmp_path / "out"), hw=HW,
                           batch=1, run_batch=lambda u8: (u8, None), io_threads=1)
        except Exception as exc:  # the test inspects it below
            caught.append(exc)

    worker = threading.Thread(target=run, daemon=True)
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive()
    assert len(caught) == 1 and "b.png" in str(caught[0])
    assert (tmp_path / "out" / "a.png").is_file()  # the batch before it was written


def test_resolve_thresholds_merges_per_class(tmp_path):
    """A run thresholds file lacking some classes falls back to the packaged
    defaults for those classes, not to flat 0.5; the reported source is the
    last file that contributed."""
    from multi_degradation_image_enhancement_tpu_torch.run_pipeline import resolve_thresholds

    classes = ["noise", "blur", "jpeg"]
    packaged = tmp_path / "packaged.json"
    packaged.write_text(json.dumps({"thresholds": {"noise": 0.3, "blur": 0.4, "jpeg": 0.6}}))
    run = tmp_path / "thresholds_val.json"
    run.write_text(json.dumps({"thresholds": {"noise": 0.7}}))

    thr, source = resolve_thresholds(classes, str(packaged), str(run))
    assert thr == [0.7, 0.4, 0.6]
    assert source == str(run)
    thr, source = resolve_thresholds(classes, str(packaged), str(tmp_path / "missing.json"))
    assert thr == [0.3, 0.4, 0.6]
    assert source == str(packaged)
    thr, source = resolve_thresholds(classes, str(tmp_path / "a.json"), str(tmp_path / "b.json"))
    assert thr == [0.5, 0.5, 0.5]
    assert source == "flat 0.5"


def test_u8_output_truncates():
    """The CLI writes ``clip(x·255, 0, 255)`` truncated, as the JAX CLI
    (``run_pipeline.py:184``): 0.9999 → 254, never rounded up; u8 → [0, 1]
    → u8 gives back 0 and 255 at the ends."""
    x = torch.tensor([0.0, 0.9999, 1.0, 1.5, -0.2, 0.5 / 255.0, 1.0 / 255.0])
    assert run_pipeline.to_u8(x).tolist() == [0, 254, 255, 255, 0, 0, 1]
    u8 = np.arange(256, dtype=np.uint8)
    back = run_pipeline.to_u8(run_pipeline.to_01(u8, "cpu"))
    assert back[0] == 0 and back[-1] == 255


def test_expert_mesh_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        run_pipeline.main(["--images", str(tmp_path), "--out", str(tmp_path), "--classifier",
                           "c.pt", "--weights-dir", str(tmp_path), "--expert-mesh", "3"])
