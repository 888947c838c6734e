"""The comparison fails what it must fail: the reference one precision
below the configuration's, and a run whose timed path is broken
underneath (its state returned unchanged, half of its work left out, an
answer altered where it is produced).  The runs skip the look for a chip
and drive the rest of the harness on the CPU at a small size."""
import numpy as np
import pytest
import torch

from perfbench.harness import fields, run, spec
from perfbench.harness.program import Program
from perfbench.reference import judge


@pytest.mark.parametrize("gen,dtype", [("turbulence", "float32"), ("gaussians", "float64")])
def test_the_control_is_not_correct(gen, dtype):
    torch.set_num_threads(1)
    cfg = {"eb": 1e-2, "mode": "noa", "preserve_order": True}
    x = fields.make(gen, (12, 24, 64), dtype, 9, "cpu")
    low = judge.control_values(x, cfg)
    ref = judge.expected(x, cfg)[0]
    assert judge.differing(low, ref) > 0


def _cell(workload):
    cell = spec.resolve(spec.load_benchmark(), workload)
    cell.config["shape"] = [10, 20, 64]
    cell.traffic["pool"] = {"min_fields": 2, "min_bytes": 0}
    return cell


class Broken(Program):
    """The program with one fault planted under the harness."""

    def __init__(self, cell, fault):
        super().__init__(cell.config, cell.traffic, "cpu")
        self.fault, self.last = fault, None
        self.op = cell.traffic["op"]

    def compress(self, field):
        if self.op != "compress":
            return super().compress(field)
        if self.fault == "half":
            field = field.copy()
            field[field.shape[0] // 2:] = 0
        blob = super().compress(field)
        if self.fault == "unchanged" and self.last is not None:
            blob, self.last = self.last, blob
            return blob
        self.last = blob
        if self.fault == "altered":
            b = bytearray(blob)
            b[-len(b) // 3] ^= 1
            return bytes(b)
        return blob

    def decompress(self, blob):
        y = super().decompress(blob)
        if self.fault == "unchanged":
            return np.zeros_like(y)
        if self.fault == "half":
            y[y.shape[0] // 2:] = 0
        if self.fault == "altered":
            y.reshape(-1)[y.size // 2] = np.nextafter(y.reshape(-1)[y.size // 2], np.inf)
        return y


@pytest.mark.parametrize("workload", ["isabel-f32.write", "miranda-f64.read"])
@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
def test_a_broken_timed_path_is_not_correct(workload, fault):
    torch.set_num_threads(1)
    cell = _cell(workload)
    got = run.run_cell(cell, 2**31 + 5, 0.3, False, "cpu", prog=Broken(cell, fault))
    res = got["result"]
    assert res["correct"] is (fault is None), res["compared"]
    assert list(res)[-1] == "compared" and res["attempted"] >= 2
    assert set(res["metrics"]) == {"setup_s", cell.end_to_end[0]["name"]}
