"""The benchmark's inputs: device generators and the traffic generator,
on the CPU at tiny shapes."""
import pytest
import torch

from perfbench.harness import fields, spec, traffic

BIG = 2**31 + 12345  # the driver's seeds exceed 32 signed bits


@pytest.mark.parametrize("gen,dtype", [("turbulence", "float32"),
                                       ("gaussians", "float64")])
def test_fields_are_a_function_of_the_seed(gen, dtype):
    torch.set_num_threads(1)
    a = fields.make(gen, (6, 10, 12), dtype, BIG, "cpu")
    b = fields.make(gen, (6, 10, 12), dtype, BIG, "cpu")
    c = fields.make(gen, (6, 10, 12), dtype, BIG + 1, "cpu")
    assert a.dtype == fields.DTYPES[dtype] and a.shape == (6, 10, 12)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert bool(torch.isfinite(a).all()) and float(a.max() - a.min()) > 0


def test_pool_seeds_are_distinct():
    seeds = {fields.field_seed(s, cfg, i) for s in (0, 1, BIG, 2**40)
             for cfg in ("isabel-f32", "miranda-f64") for i in range(4)}
    assert len(seeds) == 32 and all(0 <= s < 2**63 for s in seeds)


def test_pool_sizes_follow_the_mix():
    bench = spec.load_benchmark()
    sizes = {w: traffic.pool_size(spec.resolve(bench, w).config, spec.resolve(bench, w).traffic)
             for w in ("isabel-f32.write", "miranda-f64.write", "isabel-f32.read",
                       "miranda-f64.read")}
    assert sizes == {"isabel-f32.write": 4, "miranda-f64.write": 4,
                     "isabel-f32.read": 4, "miranda-f64.read": 2}


@pytest.mark.parametrize("n", [2, 4, 7])
def test_requests_visit_the_pool_round_robin(n):
    order = traffic.order(n, BIG)
    ks = [next(order) for _ in range(3 * n)]
    assert ks[0] == BIG % n
    assert all(a != b for a, b in zip(ks, ks[1:]))
    assert all(ks.count(k) == 3 for k in range(n))


def test_pool_is_made_from_the_seed():
    cfg = {"name": "tiny", "shape": [4, 6, 8], "dtype": "float32",
           "generator": "turbulence"}
    mix = {"op": "compress", "pool": {"min_fields": 3, "min_bytes": 0}}
    a = traffic.make_pool(cfg, mix, 7, "cpu")
    b = traffic.make_pool(cfg, mix, 7, "cpu")
    assert len(a) == 3 and all((x == y).all() for x, y in zip(a, b))
    assert not (a[0] == a[1]).all()
