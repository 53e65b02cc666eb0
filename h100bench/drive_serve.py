"""The serving cells: a closed loop of one client over the program's serving
forward (``models.cdan_fast.build_serving_apply``), each batch timed from its
submission to its restored output being ready on the device.

Set-up: the degraded pool and the weights from the seed on the device, the
running statistics calibrated by the reference on the pool's first rows,
the program's forward built, every pool batch served once.  The window then
cycles the pool until ``--seconds`` have passed, keeping the outputs of the
requests drawn for the check.  After it: the memory peak, the traced window
(``--trace 1``), the program freed, then the reference over the kept
requests.
"""

from __future__ import annotations

import gc
import json
import statistics
import time
from typing import Dict

import numpy as np
import torch

from h100bench import checks, traffic, weights
from h100bench.outcome import Outcome, event_sync, setup_marks
from h100bench.reference import exact_f32
from h100bench.reference.cdan import RefCDAN, split_state


NET_SHARE_FLOOR = 0.5  # of the output's variance that the network must carry
NET_SHARE_DRAWS = 8


def calibrated_state(gen, x, device) -> Dict[str, torch.Tensor]:
    """CDAN weights from ``gen`` with running statistics calibrated on
    ``x`` by the reference (see ``weights``), drawn again from ``gen``
    until the network, not the global residual, carries at least
    ``NET_SHARE_FLOOR`` of the output's variance on ``x``: on weights where
    it does not, a wrong DenseBlock could hide behind the residual."""
    shares = []
    for _ in range(NET_SHARE_DRAWS):
        state = weights.cdan_state(gen, device)
        params, buffers = split_state(state)
        ref = RefCDAN(params, buffers)
        with exact_f32():
            ref.calibrate(x)
            shares.append(ref.network_share(x))
        if shares[-1] >= NET_SHARE_FLOOR:
            return state
    raise SystemExit(f"no draw of the weights lets the network carry {NET_SHARE_FLOOR} of the "
                     f"output's variance: {shares}")


def kernel_launches():
    """The program's launch counters of #2 (all, and those activating in
    bf16), #8 and #9: a sanity line on standard error, not a metric."""
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.conv_cm import (
        conv3x3,
        conv3x3_pool,
    )
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import dense_block

    return (dense_block.launches, dense_block.bf16_act_launches, conv3x3.launches,
            conv3x3_pool.launches)


def prepare(cell, seed: int, device):
    """(pool of degraded batches, CDAN weights) from the seed, as every run
    and the control make them."""
    mix = cell.mix
    gen = torch.Generator(device).manual_seed(seed)
    pool = traffic.serve_pool(gen, mix, cell.config["degradation"], device)
    return pool, calibrated_state(gen, calibration_rows(pool, mix), device)


def calibration_rows(pool, mix) -> torch.Tensor:
    n = int(mix["calibration_rows"])
    return torch.cat([x[:n] for x in pool])[:n]


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float, log) -> Outcome:
    from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN
    from multi_degradation_image_enhancement_tpu_torch.models.cdan_fast import build_serving_apply

    mix, cfg = cell.mix, cell.config
    if (mix["loop"], mix["clients"]) != ("closed", 1):
        raise SystemExit(f"{cell.name}: the generator drives a closed loop of one client only")
    b, h, w = mix["batch"], mix["height"], mix["width"]
    mark = setup_marks(log, t_start)
    pool, state = prepare(cell, seed, device)
    event_sync(device)
    mark("inputs and calibrated weights on the device")
    with torch.device(device):
        model = CDAN()
    model.load_state_dict(state)
    model.eval()
    apply = build_serving_apply(model, getattr(torch, cfg["serve"]["dtype"]), device)
    event_sync(device)
    mark("the program's serving forward built")
    for x in pool:  # warm every shape the window serves
        apply(x)
    event_sync(device)
    mark("every pool batch served once")

    keep_at = set(traffic.sample_steps(seed, mix["sample"]))
    launches0 = kernel_launches()
    kept, lat, enq = {}, [], []
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    i = 0
    while True:
        k = i % len(pool)
        ts = time.perf_counter()
        out = apply(pool[k])
        te = time.perf_counter()
        event_sync(device)
        td = time.perf_counter()
        lat.append(td - ts)
        enq.append(te - ts)
        if i in keep_at:
            kept[i] = (k, out)
        i += 1
        if td - t0 >= seconds:
            break
    kept[i - 1] = (k, out)
    window = td - t0
    del out

    o = Outcome(attempted=i, failed=0)
    o.memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    o.e2e = {"serve_img_per_s": i * b / window,
             "serve_p95_ms": float(np.percentile(np.array(lat), 95)) * 1e3,
             "setup_s": setup_s}
    log(f"window {window:.3f} s, {i} batches of {b} ({i * b} images); batch latency median "
        f"{statistics.median(lat) * 1e3:.4f} ms, p95 {o.e2e['serve_p95_ms']:.4f} ms over "
        f"{len(lat)} samples ({int(len(lat) * 0.05)} beyond it); enqueue median "
        f"{statistics.median(enq) * 1e3:.4f} ms; hand-kernel launches a batch (DenseBlock, "
        f"bf16-activation, conv3x3, conv3x3_pool) "
        f"{[(a - z) / i for a, z in zip(kernel_launches(), launches0)]}")
    o.ctx.update(kind="serve", batch=b, height=h, width=w, images_per_s=o.e2e["serve_img_per_s"])
    if trace:
        from h100bench import traces

        def step(j):
            apply(pool[j % len(pool)])
            event_sync(device)

        for key, host in (("trace", False), ("host_trace", True)):
            o.ctx[key] = traces.profile(step, int(mix["trace_steps"]), lambda: event_sync(device),
                                        host)
    del apply, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    got = {step_i: (k, out[traffic.sample_rows(seed, b, int(mix["sample"]["rows"]))])
           for step_i, (k, out) in kept.items()}
    del kept
    log(f"compared {len(got)} requests against the reference (requests {sorted(got)})")
    values = serve_numbers(cell, seed, pool, state, got)
    log("readings " + json.dumps(values))
    o.readings, o.checks = values, checks.judge(values, cell.limits)
    return o


def control_readings(cell, seed: int, device, witness: bool = False) -> Dict:
    """``control``: the reference in FP8 (e4m3 operands, per-tensor scales)
    in the program's place, over the requests and rows a run keeps for the
    check.  Serving has no witness reading: ``witness`` is ignored."""
    pool, state = prepare(cell, seed, device)
    steps = traffic.sample_steps(seed, cell.mix["sample"])
    got = {k: (k % len(pool), None) for k in steps}
    return {"control": serve_numbers(cell, seed, pool, state, got, quant="fp8")}


def program_readings(cell, seed: int, device, seconds: float) -> Dict:
    """The program's own numbers: a whole run with a window of ``seconds``
    (long enough to serve the requests the check samples)."""
    out = run(cell, seed, seconds, False, device, time.perf_counter(), lambda msg: None)
    return {"program": out.readings}


def serve_numbers(cell, seed, pool, state, got, quant=None) -> Dict[str, float]:
    """The outputs ``got`` ({request: (pool index, the sampled rows'
    output)}) against the reference's: ``mean_gap``, the mean absolute
    difference of a pixel; per image (an answer altered where it is
    produced shows here) the worst image's mean gap, ``image_gap``, and
    the same over the gap that rounding to bf16 alone opens on that image
    (the reference with every conv's operands in bf16, the program's
    precision; at least the run's median image's), ``image_gap.vs_bf16``;
    reported beside them: ``bf16_gap.mean``, that rounding's mean gap over
    the images, ``max_gap``, the largest of one pixel (its tail swings from
    seed to seed as far as the control's), and ``net_share``, the share of
    the output's variance that the network, not the global residual,
    carries under these weights (gated at set-up, see
    :func:`calibrated_state`).  ``quant``: the
    reference itself in a lower precision stands in for the program's
    outputs (the control)."""
    mix = cell.mix
    rows = traffic.sample_rows(seed, mix["batch"], int(mix["sample"]["rows"]))
    chunk = int(mix["sample"]["chunk"])
    params, buffers = split_state(state)
    ref, wit = RefCDAN(params, buffers), RefCDAN(params, buffers, "bf16")
    low = RefCDAN(params, buffers, quant) if quant is not None else None
    gaps, wgaps, widest = [], [], 0.0
    with exact_f32(), torch.no_grad():
        share = ref.network_share(calibration_rows(pool, mix))
        for _, (k, out) in sorted(got.items()):
            x = pool[k][rows]
            for i in range(0, x.shape[0], chunk):
                want = ref(x[i:i + chunk])
                have = low(x[i:i + chunk]) if low is not None else out[i:i + chunk].float()
                d = (have - want).abs()
                widest = max(widest, float(d.max()))
                gaps.append(d.mean(dim=(1, 2, 3)))
                wgaps.append((wit(x[i:i + chunk]) - want).abs().mean(dim=(1, 2, 3)))
    gap, wgap = torch.cat(gaps), torch.cat(wgaps)
    by_bf16 = gap / torch.maximum(wgap, wgap.median())
    return {"mean_gap": float(gap.mean()), "image_gap": float(gap.max()),
            "image_gap.vs_bf16": float(by_bf16.max()), "bf16_gap.mean": float(wgap.mean()),
            "net_share": share, "max_gap": widest}
