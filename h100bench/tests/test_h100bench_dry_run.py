"""A whole run on the CPU at the mixes' ``cpu_dry_run`` sizes: the result
line keeps its shape, and with the timed path broken underneath
``correct`` comes out false, once for each fault the cell can have (every
answer, or one image of each, altered where it is produced; a step that
returns its state unchanged; half of the batch left out, the mean taken
over the rest).  The
look for a card is skipped by ``--device cpu``; nothing else is."""

import json

import pytest

from h100bench import run

SERVE, TRAIN = "cdan_noise.serve_b128", "cdan_jpeg.train_b32"


def _result(capsys, cell, seed=2**31 + 7, trace=0):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                   "--trace", str(trace), "--device", "cpu"])
    out, err = capsys.readouterr()
    assert rc == 0, err[-2000:]
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("cell", [SERVE, TRAIN])
def test_last_line_shape(cell, capsys):
    res, err = _result(capsys, cell)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "compared"
    assert isinstance(res["correct"], bool) and res["attempted"] > 0 and res["failed"] == 0
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert res["device"]["platform"] == "cpu"  # a CPU run never claims the card
    assert set(res["device"]) >= {"kind", "count", "memory_peak_bytes"}
    tail = err.strip().splitlines()[-len(res["compared"]):]
    assert all(line.startswith("[h100bench] compared ") for line in tail)
    for spec in res["compared"].values():
        assert set(spec) == {"value", "limit"}


def test_traced_line_reports_per_layer_metrics(capsys):
    res, _ = _result(capsys, SERVE, trace=1)
    assert "serve_mfu.batch" in res["metrics"]
    assert "setup_s" not in res["metrics"]


def test_an_answer_altered_where_it_is_produced_is_caught(capsys, monkeypatch):
    from multi_degradation_image_enhancement_tpu_torch.models import cdan_fast

    build = cdan_fast.build_serving_apply

    def broken(*args, **kwargs):
        apply = build(*args, **kwargs)

        def altered(x):
            apply(x)
            return x.float()  # every request's answer served unrestored

        return altered

    monkeypatch.setattr(cdan_fast, "build_serving_apply", broken)
    res, _ = _result(capsys, SERVE)
    assert res["correct"] is False
    assert res["compared"]["mean_gap"]["value"] > res["compared"]["mean_gap"]["limit"]


def test_one_image_of_an_answer_altered_is_caught(capsys, monkeypatch):
    from multi_degradation_image_enhancement_tpu_torch.models import cdan_fast

    build = cdan_fast.build_serving_apply

    def broken(*args, **kwargs):
        apply = build(*args, **kwargs)

        def altered(x):
            out = apply(x).clone()
            out[-1] = x[-1].to(out.dtype)  # the last image of each answer served unrestored
            return out

        return altered

    monkeypatch.setattr(cdan_fast, "build_serving_apply", broken)
    res, _ = _result(capsys, SERVE)
    assert res["correct"] is False
    worst = res["compared"]["image_gap.vs_bf16"]
    assert worst["value"] > worst["limit"]


def test_a_step_that_leaves_its_state_unchanged_is_caught(capsys, monkeypatch):
    from multi_degradation_image_enhancement_tpu_torch.engine import state

    monkeypatch.setattr(state.TrainState, "apply_gradients", lambda self: None)
    res, _ = _result(capsys, TRAIN)
    assert res["correct"] is False and res["compared"]["update_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_is_caught(capsys, monkeypatch):
    from multi_degradation_image_enhancement_tpu_torch.engine import model

    make = model.make_train_step

    def broken(loss_pipe, precision="fp32"):
        step = make(loss_pipe, precision)

        def half(state, inputs, targets, dropout=None, mask=None):
            n = inputs.shape[0] // 2
            return step(state, inputs[:n], targets[:n], [k[:n] for k in dropout], mask)

        return half

    monkeypatch.setattr(model, "make_train_step", broken)
    res, _ = _result(capsys, TRAIN)
    assert res["correct"] is False


@pytest.mark.h100bench_card
def test_a_short_run_on_the_card_is_correct(card, capsys):
    rc = run.main(["--workload", SERVE, "--seed", "2147483659", "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc == 0, err[-2000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
