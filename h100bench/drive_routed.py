"""The routed cells: a closed loop of one client over the program's
classify → route → restore pipeline as its CLI builds it
(``run_pipeline.build_full_pipeline`` on files written at set-up, then
``FullPipeline.__call__``), each batch timed from its submission to its
restored output being ready on the device.  The classifier's own
probabilities route every batch.

Set-up: the mixed pool (row i of the pool degraded by family i mod 9
through the program's ``ops/degradations`` at each family's published
range), the classifier (its head fitted on the pool) and nine CDAN experts,
each calibrated by the reference on its own family's rows
(``weights_routed``), all from the seed on the device; the CLI's files
written under ``$TMPDIR/h100bench/<configuration>/`` by the program's own writers;
the program built from them and every pool batch served once (which
captures the program's CUDA graphs of each shape the window serves), its
router's counters held to the reference's routes of the pool; then the pool
served for the mix's ``settle_seconds``, so that the card has reached the
state it keeps under sustained load (:func:`settle`).  The window then
cycles the pool until ``--seconds`` have passed and the requests drawn for
the check have been served, keeping their outputs and probabilities.  After
it: the memory peak (of the program, from its build on), the router's
counters a batch, the traced windows (``--trace 1``), the program's routes
of the kept requests (its router on its own probabilities), the program
freed, then the reference over every row of the kept requests.

The check (:func:`routed_numbers`): ``route_miss``, the share of rows whose
route (expert, clean or dropped) differs from the reference's; on the rows
the reference routes to an expert, ``mean_gap`` and ``image_gap.vs_bf16``
against that expert, as the serving cells read them; reported beside them:
``prob_gap``, the largest probability gap, ``image_gap``, ``bf16_gap.mean``,
``max_gap`` and ``rows``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from h100bench import checks, traffic, weights_routed
from h100bench.outcome import Outcome, event_sync, setup_marks
from h100bench.reference import exact_f32, routed
from h100bench.reference.cdan import RefCDAN, split_state
from h100bench.reference.resnet import RefResNet18

COUNTERS = ("expert_calls", "routed_rows", "dropped_rows", "clean_rows")
FAULTS = ("wrong_expert", "one_unrestored")


@dataclass
class Setup:
    names: List[str]  # the bank's order: the classes of the configuration
    pool: List[torch.Tensor]  # f32 NHWC in [0, 1]
    family: torch.Tensor  # each pool row's family, [pool · batch]
    classifier: Dict[str, torch.Tensor]
    experts: List[Dict[str, torch.Tensor]]  # CDAN states, in ``names`` order
    thresholds: torch.Tensor  # [E], ``names`` order
    capacity_factor: float
    routes: List[List[int]]  # the reference's routes of each pool batch


@torch.no_grad()
def routed_pool(gen: torch.Generator, mix: Dict, names: List[str], device):
    """``pool`` batches of procedural images, f32 NHWC in [0, 1], row i of the
    pool degraded by family ``names[i mod 9]`` through the program's
    ``ops.degradations.apply_degradation`` (each image its own severity at
    the family's published range), and each row's family."""
    from multi_degradation_image_enhancement_tpu_torch.ops.degradations import apply_degradation

    b, n = mix["batch"], mix["batch"] * mix["pool"]
    clean = traffic.clean_images(gen, n, mix["height"], mix["width"], device).float()
    family = torch.arange(n, device=device) % len(names)
    out = torch.empty_like(clean)
    for e, name in enumerate(names):
        rows = family == e
        out[rows] = apply_degradation(name, clean[rows], gen)
    return list((out / 255.0).split(b)), family


def prepare(cell, seed: int, device, log=None) -> Setup:
    """Everything a run, the control and the faults make from the seed."""
    routing, mix = cell.config["routing"], cell.mix
    if routing["mode"] != "top1":
        raise SystemExit(f"{cell.name}: drive_routed runs top1 routing only")
    names = list(routing["classes"])
    gen = torch.Generator(device).manual_seed(seed)
    pool, family = routed_pool(gen, mix, names, device)
    x = torch.cat(pool)
    thr = torch.tensor([routing["thresholds"][n] for n in names], device=device)
    clf, logits = weights_routed.classifier_state(gen, x, family, thr, device, log)
    experts = weights_routed.expert_states(gen, x, family, int(mix["calibration_rows"]),
                                           len(names), device)
    cf = float(routing["capacity_factor"])
    probs = torch.sigmoid(logits).split(mix["batch"])
    return Setup(names, pool, family, clf, experts, thr, cf,
                 [routed.route(p, thr, cf) for p in probs])


def counters(router) -> Dict[str, int]:
    return {k: getattr(router, k) for k in COUNTERS}


def expected_counts(routes: List[int]) -> Dict[str, int]:
    """The counters one top1 call should add for ``routes``."""
    experts = {r for r in routes if r >= 0}
    return {"expert_calls": len(experts), "routed_rows": sum(r >= 0 for r in routes),
            "dropped_rows": routes.count(routed.DROPPED),
            "clean_rows": routes.count(routed.CLEAN)}


def captures(pipe) -> int:
    """The CUDA graphs the program's pipeline has captured (0 where it keeps
    no count of them)."""
    forwards = [getattr(pipe, "classifier_forward", None), *pipe.router.expert_forwards]
    return sum(getattr(f, "captures", 0) for f in forwards)


def settle(pipe, pool, seconds: float, device) -> List[float]:
    """Serve ``pool`` in turn for ``seconds``; the medians of each 5 s of
    batch times, in ms.  Under the sustained load of this cell an H100 steps,
    after 1 to 26 s of it, from a state in which every kernel takes some 3%
    longer into one it keeps while the load lasts (``PERF.md`` section 6);
    the window is measured in the second, as a backlog that keeps the card
    busy is served."""
    medians, chunk = [], []
    t0 = t = time.perf_counter()
    i = 0
    while t - t0 < seconds:
        pipe(pool[i % len(pool)])
        event_sync(device)
        now = time.perf_counter()
        chunk.append(now - t)
        t, i = now, i + 1
        if sum(chunk) >= 5.0 or t - t0 >= seconds:
            medians.append(round(statistics.median(chunk) * 1e3, 3))
            chunk = []
    return medians


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float, log) -> Outcome:
    from multi_degradation_image_enhancement_tpu_torch.run_pipeline import build_full_pipeline

    mix = cell.mix
    if (mix["loop"], mix["clients"]) != ("closed", 1):
        raise SystemExit(f"{cell.name}: the generator drives a closed loop of one client only")
    b, h, w = mix["batch"], mix["height"], mix["width"]
    mark = setup_marks(log, t_start)
    setup = prepare(cell, seed, device, log)
    event_sync(device)
    mark("inputs, the fitted classifier and nine calibrated experts on the device")
    base = os.path.join(tempfile.gettempdir(), "h100bench", cell.config["name"])
    os.makedirs(base, exist_ok=True)
    files = tempfile.TemporaryDirectory(dir=base)
    clf_path = weights_routed.write_files(files.name, setup.experts, setup.names,
                                          setup.classifier)
    mark("the CLI's files written")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with contextlib.redirect_stdout(sys.stderr):
        pipe = build_full_pipeline(clf_path, files.name, "top1", device=str(device))
    files.cleanup()
    got_cfg = (pipe.router.expert_names, pipe.router.capacity_factor, pipe.thresholds.tolist())
    want_cfg = (setup.names, setup.capacity_factor, setup.thresholds.tolist())
    if got_cfg != want_cfg:
        raise SystemExit(f"the program's pipeline (experts, capacity factor, thresholds) "
                         f"{got_cfg} is not the configuration's {want_cfg}")
    event_sync(device)
    mark("the program's pipeline built from its files")
    c0 = counters(pipe.router)
    for x in setup.pool:  # warm every shape the window serves
        pipe(x)
    event_sync(device)
    warm = {k: v - c0[k] for k, v in counters(pipe.router).items()}
    want = {k: sum(expected_counts(r)[k] for r in setup.routes) for k in COUNTERS}
    if warm != want:
        raise SystemExit(f"the router's counters over the pool {warm} are not what the "
                         f"reference's routes of it give {want}")
    mark(f"every pool batch served once; the router's counters over the pool {warm}; "
         f"{captures(pipe)} CUDA graphs captured")
    captured = captures(pipe)
    settled = settle(pipe, setup.pool, float(mix["settle_seconds"]), device)
    mark(f"the pool served for {mix['settle_seconds']} s more, batch time medians a "
         f"5 s {settled} ms")

    keep_at = set(traffic.sample_steps(seed, mix["sample"]))
    c0 = counters(pipe.router)
    kept, lat, enq = {}, [], []
    gc.collect()
    gc.freeze()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    i = 0
    while True:
        k = i % len(setup.pool)
        ts = time.perf_counter()
        out, probs = pipe(setup.pool[k])
        te = time.perf_counter()
        event_sync(device)
        td = time.perf_counter()
        lat.append(td - ts)
        enq.append(te - ts)
        if i in keep_at:
            kept[i] = (k, out, probs)
        i += 1
        if td - t0 >= seconds and i > max(keep_at):
            break
    gc.unfreeze()
    if captures(pipe) != captured:
        raise SystemExit(f"the program captured {captures(pipe) - captured} CUDA graphs inside "
                         f"the window: the warm-up missed a shape")
    kept[i - 1] = (k, out, probs)
    window = td - t0
    del out, probs
    per_batch = {k: (v - c0[k]) / i for k, v in counters(pipe.router).items()}

    o = Outcome(attempted=i, failed=0)
    o.memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    o.e2e = {"serve_img_per_s": i * b / window,
             "serve_p95_ms": float(np.percentile(np.array(lat), 95)) * 1e3,
             "setup_s": setup_s}
    rows_a_batch = sum(expected_counts(setup.routes[j % len(setup.pool)])["routed_rows"]
                       for j in range(i)) / i
    log(f"window {window:.3f} s, {i} batches of {b} ({i * b} images); batch latency median "
        f"{statistics.median(lat) * 1e3:.4f} ms, p95 {o.e2e['serve_p95_ms']:.4f} ms over "
        f"{len(lat)} samples ({int(len(lat) * 0.05)} beyond it); enqueue median "
        f"{statistics.median(enq) * 1e3:.4f} ms; the router's counters a batch {per_batch}")
    o.ctx.update(kind="routed", batch=b, height=h, width=w, batches_per_s=i / window,
                 routed_rows_a_batch=rows_a_batch)
    if trace:
        from h100bench import traces

        def step(j):
            pipe(setup.pool[j % len(setup.pool)])
            event_sync(device)

        for key, host in (("trace", False), ("host_trace", True)):
            o.ctx[key] = traces.profile(step, int(mix["trace_steps"]), lambda: event_sync(device),
                                        host)
    got = {s: (k, out, probs, pipe.router.route(probs, pipe.thresholds).tolist())
           for s, (k, out, probs) in kept.items()}
    del kept, pipe
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    log(f"compared {len(got)} requests, every row, against the reference (requests {sorted(got)})")
    values = routed_numbers(setup, got)["program"]
    log("readings " + json.dumps(values))
    o.readings, o.checks = values, checks.judge(values, cell.limits)
    return o


class _Tally:
    """One side's readings over the compared requests."""

    def __init__(self):
        self.miss, self.rows, self.prob_gap, self.widest = 0, 0, 0.0, 0.0
        self.gaps: List[torch.Tensor] = []
        self.wgaps: List[torch.Tensor] = []

    def add(self, want, bf16, p_ref, r_ref, out, probs, routes) -> None:
        self.rows += len(r_ref)
        self.miss += sum(a != b for a, b in zip(routes, r_ref))
        self.prob_gap = max(self.prob_gap, float((probs.float() - p_ref).abs().max()))
        rows = [r for r, to in enumerate(r_ref) if to >= 0]
        if rows:
            d = (out.float()[rows] - want[rows]).abs()
            self.widest = max(self.widest, float(d.max()))
            self.gaps.append(d.mean(dim=(1, 2, 3)))
            self.wgaps.append((bf16[rows] - want[rows]).abs().mean(dim=(1, 2, 3)))

    def values(self) -> Dict[str, float]:
        gap, wgap = torch.cat(self.gaps), torch.cat(self.wgaps)
        by_bf16 = gap / torch.maximum(wgap, wgap.median())
        return {"route_miss": self.miss / self.rows, "mean_gap": float(gap.mean()),
                "image_gap.vs_bf16": float(by_bf16.max()), "prob_gap": self.prob_gap,
                "image_gap": float(gap.max()), "bf16_gap.mean": float(wgap.mean()),
                "max_gap": self.widest, "rows": self.rows}


def _reference(setup: Setup, quant: Optional[str] = None):
    clf = RefResNet18(*split_state(setup.classifier), quant)
    return clf, [RefCDAN(*split_state(s), quant) for s in setup.experts]


def routed_numbers(setup: Setup, got: Dict, stand_ins=()) -> Dict[str, Dict[str, float]]:
    """The readings of the outputs ``got`` ({request: (pool index, restored
    images, probabilities, routes)}) against the reference's,
    ``{"program": ...}``; with ``stand_ins``, each stand-in's instead, the
    same requests answered by the reference in the program's place (see
    :func:`stand_in`; ``got``'s outputs are then not read)."""
    clf, experts = _reference(setup)
    wit = [RefCDAN(*split_state(s), "bf16") for s in setup.experts]
    low = _reference(setup, "fp8") if "control" in stand_ins else None
    tallies = {kind: _Tally() for kind in (stand_ins or ("program",))}
    thr, cf = setup.thresholds, setup.capacity_factor
    with exact_f32(), torch.no_grad():
        for _, (k, out, probs, routes) in sorted(got.items()):
            x = setup.pool[k]
            want, p_ref, r_ref = routed.pipeline(clf, experts, thr, cf, x)
            bf16 = routed.restore(wit, x, r_ref)
            for kind, tally in tallies.items():
                if kind != "program":
                    out, probs, routes = stand_in(kind, setup, x, want, p_ref, r_ref, experts, low)
                tally.add(want, bf16, p_ref, r_ref, out, probs, routes)
    return {kind: t.values() for kind, t in tallies.items()}


def stand_in(kind, setup, x, want, p_ref, r_ref, experts, low):
    """(restored, probabilities, routes) of the reference in the program's
    place: ``control``, in FP8 (the classifier's and every expert's conv and
    linear operands in e4m3, per-tensor scales); ``wrong_expert``, each row
    routed to expert e restored by expert (e + 1) mod E; ``one_unrestored``,
    the last row of each answer passed through."""
    if kind == "control":
        return routed.pipeline(low[0], low[1], setup.thresholds, setup.capacity_factor, x)
    if kind == "wrong_expert":
        return routed.restore(experts[1:] + experts[:1], x, r_ref), p_ref, r_ref
    if kind == "one_unrestored":
        out = want.clone()
        out[-1] = x[-1]
        return out, p_ref, r_ref
    raise ValueError(kind)


def control_readings(cell, seed: int, device, witness: bool = False) -> Dict:
    """``control`` (the reference in FP8) and each planted fault in the
    program's place, over the requests a run keeps for the check.  No
    witness reading: ``witness`` is ignored."""
    setup = prepare(cell, seed, device)
    steps = traffic.sample_steps(seed, cell.mix["sample"])
    got = {s: (s % len(setup.pool), None, None, None) for s in steps}
    return routed_numbers(setup, got, ("control",) + FAULTS)


def program_readings(cell, seed: int, device, seconds: float) -> Dict:
    """The program's own numbers: a whole run with a window of ``seconds``
    (extended until the requests the check samples are served)."""
    out = run(cell, seed, seconds, False, device, time.perf_counter(), lambda msg: None)
    return {"program": out.readings}
