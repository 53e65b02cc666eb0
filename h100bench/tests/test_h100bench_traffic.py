"""The traffic generator is determined by the seed: the same seed gives the
same inputs, another seed other pixels at the same sizes."""

import pytest
import torch

from h100bench import traffic


def _serve(seed, mix):
    gen = torch.Generator().manual_seed(seed)
    return traffic.serve_pool(gen, mix, {"name": "noise", "sigma": [10, 50]}, "cpu")


@pytest.mark.parametrize("name", ["serve_b128"])
def test_serve_pool_by_seed(name):
    mix = traffic.load(name, cpu_dry_run=True)
    a, b, c = _serve(2**31 + 11, mix), _serve(2**31 + 11, mix), _serve(12, mix)
    assert len(a) == mix["pool"]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(x.shape == z.shape for x, z in zip(a, c))
    assert not all(torch.equal(x, z) for x, z in zip(a, c))
    assert all(float(x.min()) >= 0.0 and float(x.max()) <= 1.0 for x in a)
    assert all(x.shape == (mix["batch"], mix["height"], mix["width"], 3) for x in a)


@pytest.mark.parametrize("degradation", [{"name": "noise", "sigma": [10, 50]},
                                         {"name": "jpeg", "quality": [10, 50]}])
def test_train_pool_by_seed(degradation):
    mix = traffic.load("train_b32", cpu_dry_run=True)

    def pool(seed):
        return traffic.train_pool(torch.Generator().manual_seed(seed), mix, degradation, "cpu")

    (d1, c1), (d2, c2), (d3, _) = pool(5), pool(5), pool(6)
    assert torch.equal(d1, d2) and torch.equal(c1, c2)
    assert d1.shape == d3.shape and not torch.equal(d1, d3)
    assert d1.dtype == torch.uint8 and not torch.equal(d1, c1)


def test_batch_order_and_masks_by_seed():
    order = traffic.BatchOrder(2**31 + 3, 512, 16)
    rows = [order.take(i) for i in range(32)]
    assert len({r for step in rows for r in step}) == 512  # one epoch: every row once
    assert rows == [traffic.BatchOrder(2**31 + 3, 512, 16).take(i) for i in range(32)]
    assert rows[0] != traffic.BatchOrder(4, 512, 16).take(0)
    m1 = traffic.dropout_masks(torch.Generator().manual_seed(1), 2, 32, 64, "cpu")
    m2 = traffic.dropout_masks(torch.Generator().manual_seed(1), 2, 32, 64, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(m1, m2))
    assert [tuple(m.shape) for m in m1] == [(2, 64, 16, 32), (2, 128, 8, 16), (2, 256, 4, 8),
                                            (2, 512, 4, 8)]
    keep = torch.cat([m.flatten() for m in m1]).float().mean()
    assert 0.75 < float(keep) < 0.85


def test_samples_by_seed():
    sample = {"batches": 3, "within": 200}
    assert traffic.sample_steps(9, sample) == traffic.sample_steps(9, sample)
    assert len(set(traffic.sample_steps(9, sample))) == 3
    assert traffic.sample_rows(9, 128, 32) == traffic.sample_rows(9, 128, 32)
