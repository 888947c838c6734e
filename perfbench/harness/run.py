"""One run of one cell: set-up, the measured window, the judgement.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the kernel libraries that are missing, makes the cell's
pool of fields on the device from the seed, and (reader cells)
compresses them, then sends one warm request of the cell's own kind
for each slot of the pool, so every field's first use falls in set-up.
The window is a closed loop of one client for ``--seconds``; every
request started in it counts, and the window ends at the last
completion.  With ``--trace 1`` the program's spans are on for the whole
window and ``torch.profiler`` traces the device over two steady
requests; the result then holds the per-layer metrics instead of the
end-to-end ones.  After the window the device's peak memory since the
window's start is read, the program's cached
memory is released, and every answer is judged against the plain
reference on the device.  The last line of standard output is the
result; the numbers compared, each with its limit, close standard error
and the result.
"""
from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field

import torch

from ..reference import judge
from . import imports, profile, spec, traffic
from .program import Program

PROFILED = 2  # requests under torch.profiler in a traced run


@dataclass
class Window:
    op: str
    t0: float = 0.0
    t_last: float = 0.0
    requests: list = field(default_factory=list)  # dicts, one a request
    answers: list = field(default_factory=list)  # (pool index, answer)
    failures: list = field(default_factory=list)


@dataclass
class RunRecord:
    """What a metric reader reads."""

    cell: spec.Cell
    setup_s: float
    window: Window
    spans: list = field(default_factory=list)
    profile: dict | None = None
    counters: dict = field(default_factory=dict)


def _send(prog: Program, call, ks, trace: bool, op: str, failures: list):
    """Send requests for pool slots ``ks`` one after another ->
    [(slot, answer or None, start, end, process CPU seconds)]."""
    out = []
    for k in ks:
        cpu = time.process_time()
        t = time.perf_counter()
        try:
            if trace:
                with prog.request_span(op):
                    a = call(k)
            else:
                a = call(k)
        except Exception as e:  # a failed request is counted, not fatal
            failures.append(f"{type(e).__name__}: {e}")
            a = None
        out.append((k, a, t, time.perf_counter(), time.process_time() - cpu))
    return out


def kept(i: int, op: str, n_pool: int, seed: int) -> bool:
    """Is the answer of request ``i`` kept for the judgement?  Every
    container is; of the decoded fields (hundreds of MB each, which would
    pile up in host memory and slow the requests after them) the first of
    each pool slot and every eighth from a seed-drawn start."""
    return op == "compress" or i < n_pool or i % 8 == seed % 8


def measure(prog: Program, call, order, seconds: float, op: str,
            trace: bool, raw_bytes: int, containers=None, n_pool: int = 1,
            seed: int = 0):
    """The closed loop.  In a traced run on the card the second request
    starts a profile of ``PROFILED`` requests.  Returns (window, the
    profile's (events, start_us, end_us) or None)."""
    win = Window(op)
    prof = None
    if prog.device == "cuda":
        torch.cuda.synchronize()
    win.t0 = time.perf_counter()
    t_end = win.t0 + seconds
    i = 0
    while time.perf_counter() < t_end:
        profiled = trace and i == 1 and prog.device == "cuda"
        ks = [next(order) for _ in range(PROFILED if profiled else 1)]
        if profiled:
            done = []
            prof = profile.capture(lambda: done.extend(
                _send(prog, call, ks, trace, op, win.failures)))
        else:
            done = _send(prog, call, ks, trace, op, win.failures)
        for k, a, t, t_done, cpu in done:
            if a is None or kept(len(win.requests), op, n_pool, seed):
                win.answers.append((k, a))
            win.requests.append({
                "pool": k, "start": t, "end": t_done, "raw_bytes": raw_bytes,
                "container_bytes": (len(containers[k]) if containers is not None
                                    else len(a) if a is not None else 0),
                "cpu_s": cpu, "profiled": profiled})
            del a
        del done  # an answer not kept is freed before the next request
        win.t_last = time.perf_counter()
        i += 1
    return win, prof


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_process: float | None = None,
             prog: Program | None = None) -> dict:
    """Everything after the harness's look for a chip; returns the result
    object (``correct``, ``attempted``, ``failed``, ``metrics``,
    ``device``[, ``breakdown``], ``compared``) and set-up parts."""
    t_process = time.perf_counter() if t_process is None else t_process
    parts = {}
    traffic.check(cell.traffic)
    op = cell.traffic["op"]
    t = time.perf_counter()
    prog = prog or Program(cell.config, cell.traffic, device)
    parts["import_program_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if device == "cuda":
        torch.cuda.init()
    parts["device_init_s"] = time.perf_counter() - t
    parts["kernel_build_s"] = prog.build()
    t = time.perf_counter()
    pool = traffic.make_pool(cell.config, cell.traffic, seed, device)
    parts["fields_s"] = time.perf_counter() - t
    raw_bytes = pool[0].nbytes
    containers = None
    t = time.perf_counter()
    if op == "decompress":
        containers = [prog.compress(x) for x in pool]
        parts["containers_s"] = time.perf_counter() - t

        def call(k):
            return prog.decompress(containers[k])
    else:
        def call(k):
            return prog.compress(pool[k])
    t = time.perf_counter()
    for k in range(len(pool)):  # warm requests of the cell's own shape and kind
        call(k)
    if device == "cuda":
        torch.cuda.synchronize()
        # the peak is the window's: set-up's work and scratch go first
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    parts["warm_requests_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_process

    before = prog.counters()
    if trace:
        prog.trace_on()
    win, prof = measure(prog, call, traffic.order(len(pool), seed), seconds,
                        op, trace, raw_bytes, containers, len(pool), seed)
    spans = prog.trace_off() if trace else []
    after = prog.counters()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if device == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    numbers = judge.judge(cell.config, op, pool, win.answers, device)
    parts["reference_s"] = time.perf_counter() - t
    numbers["unanswered"] = max(numbers["unanswered"], len(win.failures))

    rec = RunRecord(cell, setup_s, win, spans, None,
                    {k: after.get(k, 0) - before.get(k, 0) for k in after})
    if prof is not None:
        rec.profile = profile.reduce(*prof, spans)
        rec.profile["requests"] = sum(r["profiled"] for r in win.requests)
        rec.profile["container_bytes"] = sum(r["container_bytes"] for r in win.requests
                                             if r["profiled"])
        rec.profile["raw_bytes"] = raw_bytes * rec.profile["requests"]
        rec.profile["device_name"] = torch.cuda.get_device_name()
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name() if device == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": judge.passed(numbers) and not win.failures,
           "attempted": len(win.requests), "failed": len(win.failures),
           "metrics": metrics, "device": dev}
    if rec.profile is not None:
        dev["busy_s"] = rec.profile["busy_us"] / 1e6
        dev["window_s"] = rec.profile["window_us"] / 1e6
        out["breakdown"] = {"device_ops": rec.profile["device_ops"],
                            "idle_gaps": rec.profile["idle_gaps"]}
    out["compared"] = {k: {"value": numbers[k], "limit": lim}
                       for k, lim in judge.LIMITS.items()}
    return {"result": out, "setup_parts": parts, "judged": numbers["judged"],
            "failures": win.failures[:5], "sweeps": numbers.get("sweeps"),
            "request_s": [[r["pool"], round(r["end"] - r["start"], 4),
                           round(r["cpu_s"], 4)] for r in win.requests]}


def main(argv=None, t_process: float | None = None) -> int:
    import argparse

    t_main = time.perf_counter()
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.resolve(spec.load_benchmark(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        got = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda", t_process)
    except ImportError as e:
        print(f"perfbench: the program cannot be imported: {e}", file=sys.stderr)
        return 2
    bad = imports.forbidden(sys.modules)
    if bad:
        print(f"perfbench: forbidden modules were loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    res = got["result"]
    got["setup_parts"]["before_harness_s"] = t_main - (t_process or t_main)
    print(json.dumps({k: got[k] for k in ("setup_parts", "judged", "sweeps",
                                          "failures", "request_s")}), file=sys.stderr)
    for k, v in res["compared"].items():
        print(f"compared {k} = {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stdout.write(json.dumps(res) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
