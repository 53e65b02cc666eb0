"""The Restormer serving cells: a closed loop of one client over the
program's served forward (``models.restormer.serving_forward`` on the
network the port's registry builds from the configuration's ``network``),
each batch timed from its submission to its restored output being ready on
the device.

Set-up: the port's module imported first (a tree without it stops here, in
seconds), the degraded pool (``traffic.serve_pool``) and the weights from
the seed on the device, redrawn until the reference's gates hold on the
pool's first rows (:func:`calibrated_state`); the program built, every pool
batch served once.  The window then cycles the pool until ``--seconds``
have passed and the requests drawn for the check have been served, keeping
their outputs.  After it: the memory peak (from the program's build on),
the counters a batch, the traced windows (``--trace 1``), the program freed,
then the reference over every row of the kept requests, one image at a time.

The check (:func:`restormer_numbers`), as the CDAN serving cells read it:
``mean_gap``, the mean absolute difference of a pixel, and
``mean_gap.vs_bf16``, that over the mean gap the reference in bf16 (the
program's precision: every conv's and both attention products' operands
rounded) opens; ``image_gap.vs_bf16``, the worst image's mean gap over the
gap bf16 opens on it, at least the median image's; ``image_gap``,
``bf16_gap.mean``, ``max_gap``, and the set-up gates ``net_share`` and
``attn_entropy.max``.  The cell's file limits the two ratios: each seed's
weights set the output's scale, which the absolute gaps follow.
"""

from __future__ import annotations

import gc
import json
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from h100bench import checks, traffic, weights_restormer
from h100bench.drive_serve import calibration_rows
from h100bench.outcome import Outcome, event_sync, setup_marks
from h100bench.reference import exact_f32
from h100bench.reference.restormer import RefRestormer

NET_SHARE_FLOOR = 0.5  # of the output's variance that the network must carry
ENTROPY_CEILING = 0.7  # each MDTA's mean row entropy, over ln c
DRAWS = 8
FAULTS = ("unchanged", "attention_transposed", "gate_swapped")
COUNTERS = ("mdta_calls", "gdfn_calls")


def calibrated_state(gen, config: Dict, x, device, log=None) -> Dict[str, torch.Tensor]:
    """Restormer weights from ``gen`` (``weights_restormer``), drawn again
    until, on ``x``, the network, not the global residual, carries at least
    ``NET_SHARE_FLOOR`` of the output's variance (a wrong block could hide
    behind the residual otherwise) and every MDTA's mean row entropy is at
    most ``ENTROPY_CEILING`` · ln c (a nearly uniform attention would let a
    transposed or missing one pass)."""
    tried = []
    for _ in range(DRAWS):
        state = weights_restormer.restormer_state(gen, config, device)
        with exact_f32():
            share, entropy = RefRestormer(state).probe(x)
        tried.append((round(share, 4), round(max(entropy), 4)))
        if share >= NET_SHARE_FLOOR and max(entropy) <= ENTROPY_CEILING:
            if log is not None:
                log(f"weights drawn {len(tried)} times: (net_share, attn_entropy.max) {tried}")
            return state
    raise SystemExit(f"no draw of the weights holds net_share >= {NET_SHARE_FLOOR} and "
                     f"attn_entropy.max <= {ENTROPY_CEILING}: {tried}")


def prepare(cell, seed: int, device, log=None):
    """(pool of degraded batches, weights) from the seed, as every run and
    the control make them."""
    gen = torch.Generator(device).manual_seed(seed)
    pool = traffic.serve_pool(gen, cell.mix, cell.config["degradation"], device)
    return pool, calibrated_state(gen, cell.config, calibration_rows(pool, cell.mix), device, log)


def counters(apply) -> List[int]:
    return [getattr(apply, k) for k in COUNTERS]


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float, log) -> Outcome:
    from multi_degradation_image_enhancement_tpu_torch.models.restormer import serving_forward
    from multi_degradation_image_enhancement_tpu_torch.utils.registry import define_network

    mix, cfg = cell.mix, cell.config
    if (mix["loop"], mix["clients"]) != ("closed", 1):
        raise SystemExit(f"{cell.name}: the generator drives a closed loop of one client only")
    b, h, w = mix["batch"], mix["height"], mix["width"]
    mark = setup_marks(log, t_start)
    pool, state = prepare(cell, seed, device, log)
    event_sync(device)
    mark("inputs and gated weights on the device")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = define_network(cfg["network"])
    model.load_state_dict(state)
    model.eval()
    apply = serving_forward(model.to(device), getattr(torch, cfg["serve"]["dtype"]), device)
    del model
    event_sync(device)
    mark("the program's served forward built")
    for x in pool:  # warm every shape the window serves
        apply(x)
    event_sync(device)
    mark("every pool batch served once")

    keep_at = set(traffic.sample_steps(seed, mix["sample"]))
    c0 = counters(apply)
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
        if td - t0 >= seconds and i > max(keep_at):
            break
    kept[i - 1] = (k, out)
    window = td - t0
    del out
    per_batch = {n: (v - z) / i for n, v, z in zip(COUNTERS, counters(apply), c0)}

    o = Outcome(attempted=i, failed=0)
    o.memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    o.e2e = {"serve_img_per_s": i * b / window,
             "serve_p95_ms": float(np.percentile(np.array(lat), 95)) * 1e3,
             "setup_s": setup_s}
    log(f"window {window:.3f} s, {i} batches of {b} ({i * b} images); batch latency median "
        f"{statistics.median(lat) * 1e3:.4f} ms, p95 {o.e2e['serve_p95_ms']:.4f} ms over "
        f"{len(lat)} samples ({int(len(lat) * 0.05)} beyond it); enqueue median "
        f"{statistics.median(enq) * 1e3:.4f} ms; medians a 5 s {chunk_medians(lat)} ms; "
        f"the served forward's counters a batch {per_batch}")
    o.ctx.update(kind="restormer_serve", batch=b, height=h, width=w,
                 images_per_s=o.e2e["serve_img_per_s"], network=cfg["network"]["args"])
    if trace:
        from h100bench import traces

        def step(j):
            apply(pool[j % len(pool)])
            event_sync(device)

        for key, host in (("trace", False), ("host_trace", True)):
            o.ctx[key] = traces.profile(step, int(mix["trace_steps"]), lambda: event_sync(device),
                                        host)
    del apply
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    rows = traffic.sample_rows(seed, b, int(mix["sample"]["rows"]))
    got = {s: (k, out[rows]) for s, (k, out) in kept.items()}
    del kept
    log(f"compared {len(got)} requests, rows {rows}, against the reference one image at a time "
        f"(requests {sorted(got)})")
    values = restormer_numbers(cell, seed, pool, state, got)["program"]
    log("readings " + json.dumps(values))
    o.readings, o.checks = values, checks.judge(values, cell.limits)
    return o


def chunk_medians(lat: List[float], span_s: float = 5.0) -> List[float]:
    """The batch times' medians over each ``span_s`` of the window, in ms:
    a card that changes state under the load shows as a step between them."""
    out, chunk = [], []
    for t in lat:
        chunk.append(t)
        if sum(chunk) >= span_s:
            out.append(round(statistics.median(chunk) * 1e3, 3))
            chunk = []
    return out + ([round(statistics.median(chunk) * 1e3, 3)] if chunk else [])


def stand_in(kind: str, state, x) -> torch.Tensor:
    """The reference in the program's place: ``control`` in FP8; the planted
    faults ``unchanged`` (the input served), ``attention_transposed`` and
    ``gate_swapped`` (see ``reference/restormer.py``)."""
    if kind == "control":
        return RefRestormer(state, "fp8")(x)
    if kind == "unchanged":
        return x
    return RefRestormer(state, fault=kind)(x)


def restormer_numbers(cell, seed, pool, state, got, stand_ins=()) -> Dict[str, Dict[str, float]]:
    """The readings of the outputs ``got`` ({request: (pool index, the
    sampled rows' outputs)}) against the reference's, ``{"program": ...}``;
    with ``stand_ins``, each stand-in's (:func:`stand_in`) instead, the same
    requests and rows answered by the reference in the program's place."""
    mix = cell.mix
    rows = traffic.sample_rows(seed, mix["batch"], int(mix["sample"]["rows"]))
    ref, wit = RefRestormer(state), RefRestormer(state, "bf16")
    kinds = stand_ins or ("program",)
    gaps = {kind: [] for kind in kinds}
    widest = dict.fromkeys(kinds, 0.0)
    wgaps = []
    with exact_f32(), torch.no_grad():
        share, entropy = ref.probe(calibration_rows(pool, mix))
        for _, (k, out) in sorted(got.items()):
            x = pool[k][rows]
            for i in range(x.shape[0]):
                xi = x[i:i + 1]
                want = ref(xi)
                wgaps.append(float((wit(xi) - want).abs().mean()))
                for kind in kinds:
                    have = out[i:i + 1].float() if kind == "program" else stand_in(kind, state, xi)
                    d = (have - want).abs()
                    widest[kind] = max(widest[kind], float(d.max()))
                    gaps[kind].append(float(d.mean()))
    wgap = torch.tensor(wgaps, dtype=torch.float64)
    floor = torch.maximum(wgap, wgap.median())
    result = {}
    for kind in kinds:
        gap = torch.tensor(gaps[kind], dtype=torch.float64)
        result[kind] = {"mean_gap": float(gap.mean()),
                        "image_gap.vs_bf16": float((gap / floor).max()),
                        "image_gap": float(gap.max()),
                        "mean_gap.vs_bf16": float(gap.mean() / wgap.mean()),
                        "bf16_gap.mean": float(wgap.mean()), "max_gap": widest[kind],
                        "net_share": share, "attn_entropy.max": max(entropy)}
    return result


def control_readings(cell, seed: int, device, witness: bool = False) -> Dict:
    """``control`` (the reference in FP8) and each planted fault in the
    program's place, over the requests and rows a run keeps for the check.
    No witness reading: ``witness`` is ignored."""
    pool, state = prepare(cell, seed, device)
    steps = traffic.sample_steps(seed, cell.mix["sample"])
    got = {s: (s % len(pool), None) for s in steps}
    return restormer_numbers(cell, seed, pool, state, got, ("control",) + FAULTS)


def program_readings(cell, seed: int, device, seconds: float) -> Dict:
    """The program's own numbers: a whole run with a window of ``seconds``
    (extended until the requests the check samples are served)."""
    out = run(cell, seed, seconds, False, device, time.perf_counter(), lambda msg: None)
    return {"program": out.readings}
