"""The plain reference against the program on the CPU at small sizes:
the reconstruction and the container reader give the program's decoded
values bit for bit, and a damaged container does not read."""
import numpy as np
import pytest
import torch

from perfbench.harness import fields
from perfbench.harness.program import Program
from perfbench.reference import container, judge, lopc

CASES = [("turbulence", (12, 20, 70), "float32", True),
         ("gaussians", (10, 24, 70), "float64", True),
         ("gaussians", (9, 17, 30), "float32", True)]


def _prog(order):
    return Program({"eb": 1e-2, "mode": "noa", "preserve_order": order}, {}, "cpu")


@pytest.mark.parametrize("gen,shape,dtype,order", CASES)
def test_reference_equals_the_program(gen, shape, dtype, order):
    torch.set_num_threads(1)
    x = fields.make(gen, shape, dtype, 11, "cpu")
    prog = _prog(order)
    blob = prog.compress(x.numpy())
    y = torch.from_numpy(prog.decompress(blob))
    cfg = {"eb": 1e-2, "mode": "noa", "preserve_order": order}
    ref, eps_abs, _ = judge.expected(x, cfg)
    assert judge.differing(y, ref) == 0
    assert judge.differing(container.values(container.read(blob)), ref) == 0
    if order:
        assert judge.order_violations(x, y) == 0
    assert judge.max_error(x, y, eps_abs) < 1.0


def test_a_damaged_container_does_not_read():
    x = fields.make("turbulence", (8, 16, 64), "float32", 3, "cpu")
    blob = bytearray(_prog(True).compress(x.numpy()))
    container.read(bytes(blob))
    blob[len(blob) // 2] ^= 0x10
    with pytest.raises(ValueError):
        container.read(bytes(blob))


def test_two_dimensional_fields_have_six_neighbours():
    x = fields.make("gaussians", (30, 40), "float32", 5, "cpu")
    y = torch.from_numpy(_prog(True).decompress(_prog(True).compress(x.numpy())))
    assert judge.differing(y, lopc.reconstruct(x, 1e-2)[0]) == 0


@pytest.mark.cuda
def test_reference_on_the_card_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = fields.make("gaussians", (16, 48, 64), "float64", 2, "cuda")
    a = lopc.reconstruct(x, 1e-2)[0].cpu()
    b = lopc.reconstruct(x.cpu(), 1e-2)[0]
    assert np.array_equal(a.numpy().view(np.int64), b.numpy().view(np.int64))
