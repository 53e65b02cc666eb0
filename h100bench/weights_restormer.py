"""Restormer weights made from ``--seed`` on the run's device, in a few large
draws (no trained checkpoint ships):

* conv kernels: LeCun normal truncated at ±2σ (Flax's ``lecun_normal``;
  fan_in = kh·kw·c_in per group, 9 for a depthwise 3×3), drawn as one buffer;
* the last conv of each residual branch (MDTA's and GDFN's ``project_out``)
  at :data:`BRANCH_GAIN` × that: at 1× each of the 44 blocks adds as much
  as its input holds, and the random network turns chaotic (rounding its
  operands to bf16 moved its output by as much as the network adds to the
  input, in a CPU experiment at 64×96); at 0.05× the bf16 reference stays
  within ~2% of the float32 one while a planted fault moves it 20–50 times
  as far, as a trained network's branches are small beside the stream;
* conv biases, where the configuration has them: uniform, standard deviation 0.02;
* LayerNorm weights 1 ± 0.1 and, with-bias, shifts ± 0.1 (uniform), so a
  kernel that dropped the scale or the shift would show;
* each head's temperature τ log-uniform in :data:`TEMPERATURE` (the published
  init is 1): with cosine logits in [−1, 1] and τ near 1 the c×c attention
  is nearly uniform, and a transposed or missing attention would pass
  unseen.  ``drive_restormer_serve.calibrated_state`` redraws the whole
  state until the attention is sharp and the network carries the output.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from h100bench.reference.restormer import restormer_shapes
from h100bench.weights import TRUNCATED_STD, _split

TEMPERATURE = (16.0, 64.0)
BRANCH_GAIN = 0.05
BRANCH_ENDS = ("attn.project_out.weight", "ffn.project_out.weight")


@torch.no_grad()
def restormer_state(generator: torch.Generator, config: Dict, device) -> Dict[str, torch.Tensor]:
    """The weights of the configuration's network (its ``network.args``) by
    published name, float32."""
    shapes = restormer_shapes(**config["network"]["args"])
    kernels = {k: s for k, s in shapes.items() if len(s) == 4}
    temps = {k: s for k, s in shapes.items() if k.endswith("temperature")}
    rest = {k: s for k, s in shapes.items() if k not in kernels and k not in temps}

    def draw(group, fill):
        flat = torch.empty(sum(math.prod(s) for s in group.values()), device=device)
        fill(flat)
        return _split(flat, group)

    state = draw(kernels, lambda t: torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                                                generator=generator))
    for k, s in kernels.items():
        gain = BRANCH_GAIN if k.endswith(BRANCH_ENDS) else 1.0
        state[k].mul_(gain * math.sqrt(1.0 / math.prod(s[1:])) / TRUNCATED_STD)
    lo, hi = TEMPERATURE
    for k, t in draw(temps, lambda t: t.uniform_(math.log(lo), math.log(hi),
                                                 generator=generator)).items():
        state[k] = t.exp_()
    for k, t in draw(rest, lambda t: t.uniform_(-1.0, 1.0, generator=generator)).items():
        if k.endswith("body.weight"):
            state[k] = t.mul_(0.1).add_(1.0)
        elif k.endswith("body.bias"):
            state[k] = t.mul_(0.1)
        else:  # a conv's bias
            state[k] = t.mul_(0.02 * math.sqrt(3.0))
    return {k: state[k] for k in shapes}
