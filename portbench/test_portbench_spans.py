"""The readers of the program's spans and counters (``portbench/spans.py``,
``layers/{model,exchange,control}_idle_ms.py``, ``layers/moe_slot_fill.py``)
on small synthetic Chrome traces: one of MLfabric-A, one of the step.
Each trace also runs with its ``mlfabric.*`` events left out, as a
program without them exports it: the new readers then read nothing, and
the benchmark's own readers read what they read with them.

    python -m pytest -q portbench/test_portbench_spans.py
"""

import json
from types import SimpleNamespace

import pytest
import torch

from portbench import harness, spans
from portbench.trace import read_chrome

NEW = ("model_idle_ms", "exchange_idle_ms", "control_idle_ms")
OLD = ("mfu", "device_idle_share", "fwd_bwd_ms", "reduce_ms",
       "wire_kernel_roofline", "update_ms", "control_plane_ms")

# (name, start, end, thread) in microseconds; the window is [0, 1000]
ASYNC_SPANS = [
    ("mlfabric.run", 0, 950, 1),
    ("mlfabric.compute worker=worker0 version=0 t=0", 10, 700, 1),
    ("mlfabric.data", 10, 50, 1),
    ("mlfabric.fwd_bwd", 50, 500, 1),
    ("mlfabric.forward", 50, 250, 1),
    ("mlfabric.attention layer=0", 60, 150, 1),
    ("mlfabric.moe layer=0", 150, 240, 1),
    ("mlfabric.backward", 250, 500, 1),
    ("mlfabric.attention layer=0", 300, 350, 2),     # autograd's thread
    ("mlfabric.moe layer=0", 350, 400, 2),
    ("mlfabric.sync read=update_norm", 500, 520, 1),
    ("mlfabric.wire floats=100", 520, 680, 1),
    ("mlfabric.sync read=wire_norm", 660, 680, 1),
    ("mlfabric.plan batch=0 updates=1", 720, 740, 1),
    ("mlfabric.commit uid=0 worker=worker0 version=0", 800, 900, 1),
    ("mlfabric.update", 810, 890, 1),
]
# (kernel, device start, device end, launched at)
ASYNC_OPS = [
    ("k_data", 0, 40, 5),
    ("k_attn", 100, 200, 70),
    ("k_bwd", 260, 320, 260),
    ("k_recompute", 330, 480, 310),
    ("void quantize_kernel<256>", 560, 600, 530),
    ("void dequant_aggregate_kernel<256>", 610, 650, 600),
    ("k_update", 820, 880, 815),
]
ASYNC_RANGES = [("portbench.fwd_bwd", 50, 500),
                ("portbench.reduce", 520, 680),
                ("portbench.update", 800, 900)]
# idle microseconds by layer, counted by hand from the lists above
ASYNC_IDLE = {"model": 140, "exchange": 120, "control": 200, "step": 0,
              "unnamed": 50}

STEP_SPANS = [
    ("mlfabric.step step=0", 0, 900, 1),
    ("mlfabric.fwd_bwd", 10, 400, 1),
    ("mlfabric.forward", 10, 200, 1),
    ("mlfabric.backward", 200, 400, 1),
    ("mlfabric.pack", 400, 450, 1),
    ("mlfabric.reduce", 450, 600, 1),
    ("mlfabric.bucket bucket=0 bytes=4096", 460, 590, 1),
    ("mlfabric.unpack", 600, 650, 1),
    ("mlfabric.update", 660, 800, 1),
]
STEP_OPS = [
    ("k_fwd", 20, 190, 15),
    ("k_bwd", 210, 420, 205),
    ("void quantize_kernel<256>", 470, 500, 465),
    ("void dequant_aggregate_kernel<256>", 510, 580, 505),
    ("k_update", 670, 790, 665),
]
STEP_RANGES = [("portbench.fwd_bwd", 10, 400),
               ("portbench.reduce", 400, 650),
               ("portbench.update", 660, 800)]
STEP_IDLE = {"model": 30, "exchange": 150, "control": 0, "step": 120,
             "unnamed": 100}

CASES = {"async": (ASYNC_SPANS, ASYNC_OPS, ASYNC_RANGES, ASYNC_IDLE),
         "step": (STEP_SPANS, STEP_OPS, STEP_RANGES, STEP_IDLE)}


def _event(cat, name, a, b, tid, **args):
    """One complete event, its keys in the profiler's export order."""
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": a, "dur": b - a, "args": args}


def _trace(spans_, ops, ranges, program=True):
    ev = [_event("user_annotation", "portbench.window", 0, 1000, 1)]
    ev += [_event("user_annotation", n, a, b, 1) for n, a, b in ranges]
    if program:
        ev += [_event("user_annotation", n, a, b, t)
               for n, a, b, t in spans_]
    for c, (n, a, b, launch) in enumerate(ops):
        ev.append(_event("cuda_runtime", "cudaLaunchKernel", launch,
                         launch + 1, 1, correlation=c))
        ev.append(_event("kernel", n, a, b, 7, correlation=c))
    return {"traceEvents": ev}


def _ctx(tmp_path, monkeypatch, case, program=True, name="cell"):
    spans_, ops, ranges, _ = CASES[case]
    monkeypatch.setattr(spans, "OUT", tmp_path)
    path = tmp_path / f"{name}.trace.json"
    path.write_text(json.dumps(_trace(spans_, ops, ranges, program)))
    summary = read_chrome(path)
    summary.wire = [{"kernel": "quantize", "bytes": 4000},
                    {"kernel": "dequant_aggregate", "bytes": 4000}]
    return harness.LayerContext(
        trace=summary, tokens=8, computed=1, updates=1,
        window_s=summary.window_s, flops_per_token=1e9,
        host={"control_plane_s": 1e-4} if case == "async" else {})


def _reads(ctx, names):
    return {m: harness._layer_reader(m)(ctx) for m in names}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("metric", NEW)
def test_idle_readers_read_the_hand_count(tmp_path, monkeypatch, case,
                                          metric):
    ctx = _ctx(tmp_path, monkeypatch, case)
    want = CASES[case][3][metric.split("_")[0]]
    assert harness._layer_reader(metric)(ctx) == pytest.approx(
        want * 1e-3, abs=1e-9)


@pytest.mark.parametrize("case", sorted(CASES))
def test_idle_split_adds_up_to_the_idle_share(tmp_path, monkeypatch, case):
    ctx = _ctx(tmp_path, monkeypatch, case)
    split = spans.idle_split(ctx.trace, spans.of(ctx))
    parts = {k: split[k] * 1e6 for k in CASES[case][3]}
    assert parts == pytest.approx(CASES[case][3], abs=1e-6)
    share = harness._layer_reader("device_idle_share")(ctx)
    assert sum(parts.values()) * 1e-6 == pytest.approx(
        share / 100 * ctx.trace.window_s, rel=1e-9)


@pytest.mark.parametrize("case", sorted(CASES))
def test_benchmark_readers_read_the_same_without_program_spans(
        tmp_path, monkeypatch, case):
    with_ = _ctx(tmp_path, monkeypatch, case, name="with")
    got = _reads(with_, OLD)
    assert got["fwd_bwd_ms"] is not None
    without = _ctx(tmp_path, monkeypatch, case, program=False,
                   name="without")
    assert _reads(without, OLD) == got
    assert without.trace.idle_gaps() == with_.trace.idle_gaps()
    assert without.trace.ranges == with_.trace.ranges
    assert _reads(without, NEW) == dict.fromkeys(NEW)


def test_spans_of_picks_the_trace_of_its_window(tmp_path, monkeypatch):
    ctx = _ctx(tmp_path, monkeypatch, "async")
    other = _trace(*CASES["step"][:3])
    other["traceEvents"][0]["dur"] = 999
    (tmp_path / "newer.trace.json").write_text(json.dumps(other))
    assert [s.kind for s in spans.of(ctx)][:2] == ["run", "compute"]
    ctx.trace.window = (0.0, 2.0)
    assert spans.of(ctx) is None


@pytest.mark.parametrize("case", sorted(CASES))
def test_launches_inside_the_program_spans(tmp_path, monkeypatch, case):
    ctx = _ctx(tmp_path, monkeypatch, case)
    got = spans.of(ctx)
    assert spans.launched_s(ctx.trace, got, ("fwd_bwd",)) == \
        ctx.trace.range_device_s("portbench.fwd_bwd")
    assert spans.wire_outside(ctx.trace, got) == (2, 0)


def test_innermost_span_is_the_latest_started():
    s = [spans.Span("backward", "b", 0.0, 10.0, 1),
         spans.Span("attention", "a", 2.0, 5.0, 2),
         spans.Span("fwd_bwd", "f", 0.0, 12.0, 1)]
    assert [(a, b, p.kind if p else None)
            for a, b, p in spans._innermost(s)] == [
        (0.0, 2.0, "backward"), (2.0, 5.0, "attention"),
        (5.0, 10.0, "backward"), (10.0, 12.0, "fwd_bwd")]


def test_slot_fill_reads_the_program_counters(tmp_path, monkeypatch):
    from repro_torch.obs import RUNTIME
    ctx = _ctx(tmp_path, monkeypatch, "step")
    read = harness._layer_reader("moe_slot_fill")
    RUNTIME.clear()
    try:
        assert read(ctx) is None
        RUNTIME.counter("moe/kept").inc(torch.tensor(30))
        RUNTIME.counter("moe/slots").inc(40)
        RUNTIME.counter("moe/kept").inc(torch.tensor(6))
        RUNTIME.counter("moe/slots").inc(8)
        assert read(ctx) == pytest.approx(75.0)
    finally:
        RUNTIME.clear()


@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_reads_what_json_reads(tmp_path, monkeypatch, case):
    _ctx(tmp_path, monkeypatch, case)
    path = tmp_path / "cell.trace.json"
    got = spans.scan(path)
    assert got is not None and got == spans.read(path)[:2]
    # another layout: no scan, and the readers parse the file instead
    other = tmp_path / "other"
    other.mkdir()
    (other / "x.trace.json").write_text(json.dumps(
        json.loads(path.read_text()), sort_keys=True))
    assert spans.scan(other / "x.trace.json") is None
    monkeypatch.setattr(spans, "OUT", other)
    ctx = SimpleNamespace(trace=SimpleNamespace(window=got[0]))
    assert spans.of(ctx) == got[1]


def test_scan_reads_a_profiler_export(tmp_path):
    from repro_torch.obs import region
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("portbench.window"):
            with region("mlfabric.step", step=4):
                with region("mlfabric.moe", layer=2):
                    torch.ones(8).sum()
    path = tmp_path / "t.trace.json"
    prof.export_chrome_trace(str(path))
    got = spans.scan(path)
    assert got == spans.read(path)[:2]
    assert [s.name for s in got[1]] == ["mlfabric.step step=4",
                                        "mlfabric.moe layer=2"]
