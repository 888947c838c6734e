"""The system under test, as the harness drives it: the PyTorch and CUDA
port's engine entry (``repro_torch.engine.compress`` / ``decompress``),
its spans (``repro_torch.obs``), its transfer counters and its kernel
libraries.  This is the only module of the benchmark that imports the
program; it takes nothing else from it.
"""
from __future__ import annotations

import sys

from .spans import ROOT as REQUEST_SPAN
from .spec import ROOT

# keys of a configuration that become arguments of a compress request
COMPRESS_KEYS = ("mode", "preserve_order")


class Program:
    def __init__(self, config: dict, traffic: dict, device: str):
        src = str(ROOT / "src")
        if src not in sys.path:
            sys.path.insert(0, src)
        from repro_torch import engine, obs
        from repro_torch.engine import executor
        from repro_torch.kernels import _lib

        self.engine, self.obs, self.executor, self.lib = engine, obs, executor, _lib
        self.device = device
        self.eb = float(config["eb"])
        self.kw = {k: config[k] for k in COMPRESS_KEYS if k in config}
        self.kw.update(traffic.get("options", {}))

    def build(self) -> float:
        """Build the kernel libraries that are not built yet (the first
        run in a checkout compiles; later runs find them)."""
        return self.lib.build() if self.device == "cuda" else 0.0

    def compress(self, field) -> bytes:
        return self.engine.compress(field, self.eb, device=self.device, **self.kw)

    def decompress(self, blob: bytes):
        return self.engine.decompress(blob, device=self.device)

    # -- tracing -------------------------------------------------------

    def trace_on(self) -> None:
        self.obs.enable(max_spans=1 << 20)

    def request_span(self, op: str):
        return self.obs.span(REQUEST_SPAN, op=op)

    def trace_off(self) -> list[dict]:
        spans = [s.as_dict() for s in self.obs.tracer().drain()]
        self.obs.disable()
        return spans

    def counters(self) -> dict:
        return dict(self.executor.TRANSFER_COUNTS)
