"""``metrics/layers.py`` on a synthetic Chrome trace: CUDA runtime calls and
kernels tied by ``correlation``, on threads, with the program's span rows
beside them. Each kernel's credit, the fallback for a march kernel whose
launch call the trace lacks, the backward thread's kernels, the readings,
the idle gaps' names, and the benchmark's own readings untouched."""
import copy
import json
from pathlib import Path

import pytest

from benchmark import trace as tracelib
from benchmark.metrics import layers

ROOT = Path(__file__).resolve().parents[1]
MAIN, BACKWARD = 7, 9
T0 = 1.0  # host seconds at the sub-window's start; the trace's clock is
OFF = 5e5  # host microseconds plus this offset

# the program's rows on the host clock: (name, parent, tid, start, end)
ROWS = [
    ("frame", -1, MAIN, 1.0001, 1.0090),   # 0
    ("step", 0, MAIN, 1.0002, 1.0080),     # 1
    ("rng", 1, MAIN, 1.0003, 1.0010),      # 2
    ("march", 1, MAIN, 1.0012, 1.0020),    # 3
    ("shade", 1, MAIN, 1.0021, 1.0040),    # 4
    ("sky", 1, MAIN, 1.0041, 1.0045),      # 5
    ("camera", 1, MAIN, 1.0046, 1.0050),   # 6
    ("post", 0, MAIN, 1.0082, 1.0088),     # 7
]


def us(t):
    return t * 1e6 + OFF


# (launch call's host time, duration us, thread, kernel name, kernel start
# on the trace's clock, kernel duration us); call None: no launch call
LAUNCHES = [
    (1.00035, 4, MAIN, "elementwise_kernel<rng>", us(1.0011), 100.0),
    (1.00060, 4, MAIN, "elementwise_kernel<rng2>", us(1.0013), 50.0),
    (None, 0, MAIN, "march_kernel<K1a>", us(1.0015), 400.0),
    (1.00150, 4, MAIN, "fill_kernel", us(1.0020), 10.0),
    (1.00250, 4, MAIN, "elementwise_kernel<shade>", us(1.0030), 300.0),
    (1.00300, 4, BACKWARD, "elementwise_kernel<normal>", us(1.0034), 20.0),
    (1.00420, 4, MAIN, "sky_kernel", us(1.0043), 30.0),
    (1.00470, 4, MAIN, "camera_kernel", us(1.0047), 15.0),
    (1.00700, 4, MAIN, "where_kernel<step>", us(1.0070), 25.0),
    (1.00850, 4, MAIN, "tonemap_kernel", us(1.0085), 35.0),
    (1.00950, 4, MAIN, "arange_kernel", us(1.0095), 5.0),
    (1.00960, 4, BACKWARD, "elementwise_kernel<bwd>", us(1.0096), 7.0),
]


def chrome_events(ids=True):
    """The trace's events: the bracketing synchronisations, the launch
    calls and their kernels, and a copy; ``ids`` False drops every
    ``correlation`` and thread."""
    ev = []
    for k, (t, d, tid, name, ks, kd) in enumerate(LAUNCHES):
        corr = 100 + k
        if t is not None:
            ev.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "ts": us(t), "dur": d,
                       "tid": str(tid) if k % 2 else tid,
                       "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ks,
                   "dur": kd, "tid": 7, "args": {"correlation": corr}})
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
               "ts": us(1.0088), "dur": 40.0, "tid": 7, "args": {}})
    for t in (T0 - 2e-6, 1.0100 - 2e-6):
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaDeviceSynchronize", "ts": us(t), "dur": 2.0,
                   "tid": MAIN, "args": {"correlation": 1}})
    ev.append({"ph": "s", "cat": "ac2g", "name": "ac2g", "ts": 0, "id": 1})
    if not ids:
        for e in ev:
            e.pop("tid", None)
            (e.get("args") or {}).pop("correlation", None)
    return {"traceEvents": ev}


def _write(tmp_path, data, name="t.json"):
    p = tmp_path / name
    p.write_text(json.dumps(data))
    return str(p)


def _trace(path):
    captured = {"t0": T0, "t1": 1.0100, "offset_us": OFF}
    captured["device"], captured["host"] = tracelib.read_chrome_trace(path)
    spans = tracelib.Spans()
    spans.rows = [("bench.frame", 1.00005, 1.0092),
                  ("bench.display", 1.0092, 1.0099)]
    return tracelib.build("frames", 1, captured, spans, [])


@pytest.fixture
def synthetic(tmp_path):
    path = _write(tmp_path, chrome_events())
    kernels, calls = layers.read_launches(path)
    rows = layers.on_trace_clock(ROWS, OFF)
    return _trace(path), kernels, calls, rows


def test_read_launches_keeps_correlation_and_thread(synthetic):
    _, kernels, calls, _ = synthetic
    assert len(kernels) == len(LAUNCHES)
    assert [k[3] for k in kernels] == [100 + k for k in range(len(LAUNCHES))]
    launch = [c for c in calls if c[0] == "cudaLaunchKernel"]
    assert len(launch) == len(LAUNCHES) - 1
    assert {c[4] for c in launch} == {MAIN, BACKWARD}  # str tids read too


def test_each_kernel_is_credited_to_its_launching_span(synthetic):
    """The innermost span open on the launch call's thread at its middle;
    the march kernel without a call by name; the engine thread's kernel
    while the shading waits in ``torch.autograd.grad``, the shading's; the
    one launched after every span, and the engine thread's then, none."""
    _, kernels, calls, rows = synthetic
    spans = layers.Spans(rows)
    got = [layers.layer(spans, i)
           for i in layers.credit(kernels, calls, spans)]
    assert got == ["rng", "rng", "march", "march", "shade", "shade", "sky",
                   "camera", "step", "post", None, None]


def test_backward_thread_credits_no_forward_span(synthetic):
    """The backward that the benchmark runs outside every program span
    credits none; the engine thread has no span of its own, and none is
    open on the forward thread then."""
    _, kernels, calls, rows = synthetic
    spans = layers.Spans(rows)
    credits = layers.credit(kernels, calls, spans)
    k = [i for i, k in enumerate(kernels) if "bwd" in k[0]][0]
    assert credits[k] is None
    assert spans.innermost(BACKWARD, us(1.00962)) is None
    assert spans.innermost_elsewhere(BACKWARD, us(1.00962)) is None


def test_frame_readings(synthetic):
    _, kernels, calls, rows = synthetic
    got = layers.frame_readings(kernels, calls, rows, units=1)
    assert got["rng_ms"] == pytest.approx(0.150)
    assert got["shade_ms"] == pytest.approx(0.320)  # the normal's too
    assert got["sky_ms"] == pytest.approx(0.030)
    # camera, the step's own where and the post's tonemap
    assert got["wavefront_ms"] == pytest.approx(0.075)
    assert got["march_ms"] == got["march_in_march_ms"] == pytest.approx(0.4)
    assert got["march_other_ms"] == pytest.approx(0.010)
    assert got["unattributed_ms"] == pytest.approx(0.012)
    assert got["other_ms"] == pytest.approx(
        got["rng_ms"] + got["shade_ms"] + got["sky_ms"] + got["wavefront_ms"]
        + got["march_other_ms"] + got["unattributed_ms"])
    # the frame span's 8.9 ms over the 10 kernels launched inside it (the
    # march kernel by name and the normal's included; the arange and the
    # backward's not)
    assert got["dispatch_us"] == pytest.approx(8900.0 / 10)
    assert layers.frame_readings(kernels, calls, [], 1) == {}
    half = layers.frame_readings(kernels, calls, rows, units=2)
    assert half["rng_ms"] == pytest.approx(0.075)


def test_other_device_ms_is_the_layers_sum_and_the_rest(synthetic):
    """The benchmark's ``other_device_ms.frame`` reads the same kernels:
    the four layers plus the march spans' other kernels and the
    unattributed."""
    tr, kernels, calls, rows = synthetic
    other = tracelib.read_metric(str(ROOT / "metrics"
                                     / "other_device_ms.frame.py"), tr)
    got = layers.frame_readings(kernels, calls, rows, units=1)
    assert other == pytest.approx(got["other_ms"])


def test_clock_offset_pairs_the_sections_synchronises():
    """The section's two synchronises are the pair whose ends lie the
    section's host length apart: not the profiler's own at its start, 3 ms
    early, nor the units' inside, nor one after the section."""
    off, t0, t1 = 5e5, 2.0, 2.5
    host = [("cudaDeviceSynchronize", us_at(t0, off) - 3000.0 - 9.0, 9.0),
            ("cudaDeviceSynchronize", us_at(t0, off) - 5.0, 5.0),
            ("cudaLaunchKernel", us_at(2.1, off), 4.0),
            ("cudaDeviceSynchronize", us_at(2.3, off) - 40.0, 40.0),
            ("cudaDeviceSynchronize", us_at(t1, off) - 7.0, 7.0),
            ("cudaDeviceSynchronize", us_at(t1, off) + 60.0, 4.0)]
    assert layers.clock_offset(host, t0, t1) == pytest.approx(off)
    assert layers.clock_offset(host[:1], t0, t1) is None


def us_at(t, off):
    return t * 1e6 + off


def test_step_readings():
    rows = [("bounce", -1, MAIN, 0.0, 1.0), ("sync", 0, MAIN, 0.5, 0.75),
            ("bounce", -1, MAIN, 1.0, 2.0), ("sync", 2, MAIN, 1.5, 1.5625)]
    got = layers.step_readings(layers.on_trace_clock(rows, OFF), units=2)
    assert got["syncs"] == 1.0
    assert got["sync_wait_ms"] == pytest.approx((0.25 + 0.0625) * 1e3 / 2)
    assert layers.step_readings([], 2) == {}


def test_idle_gaps_name_the_program_span(synthetic):
    """Inside a program span a gap's name carries its path between the
    benchmark's span and the runtime call; outside every one it is
    ``breakdown``'s name."""
    tr, _, _, rows = synthetic
    old = tracelib.breakdown(tr)["idle_gaps"]
    new = layers.idle_gaps(tr, rows, MAIN)
    assert [v for _, v in new] == [v for _, v in old]
    spans = layers.Spans(rows)
    gaps = sorted(tr.idle_gaps(), key=lambda g: g[0] - g[1])[:10]
    for (name, _), (was, _), (g0, g1) in zip(new, old, gaps):
        path = spans.path(spans.innermost(MAIN, 0.5 * (g0 + g1)))
        head, *mid, tail = name.split("/")
        assert mid == path and "/".join([head, tail]) == was
    named = {n for n, _ in new}
    assert {"bench.frame/frame/step/rng/host", "bench.frame/frame/step/host",
            "bench.frame/host", "bench.display/host"} <= named
    assert layers.idle_gaps(tr, [], MAIN) == old


def test_benchmark_readings_are_the_same_without_ids(synthetic, tmp_path):
    """Every reader of the benchmark and ``breakdown`` read the trace with
    its ids and threads as without them, and reading the program's layers
    changes nothing of the trace."""
    tr, kernels, calls, rows = synthetic
    bare = _trace(_write(tmp_path, chrome_events(ids=False), "bare.json"))
    before = copy.deepcopy(tr)
    layers.frame_readings(kernels, calls, rows, 1)
    layers.idle_gaps(tr, rows, MAIN)
    assert tr == before
    readers = sorted((ROOT / "metrics").glob("*.*.py"))
    assert readers
    for f in readers:
        assert tracelib.read_metric(str(f), tr) == tracelib.read_metric(
            str(f), bare), f.name
    assert tracelib.breakdown(tr) == tracelib.breakdown(bare)
    assert tracelib.breakdown(tr)["device_ops"]


def test_threads_match_as_the_trace_writes_them():
    """A trace writes a thread as the absolute value of its
    ``pthread_self`` read as a signed 32-bit integer (on the H100 host:
    ``threading.get_ident()`` 0x7f..857d9000 appeared as 2055412992)."""
    ident = (0x7F3A << 32) | 2239554304
    assert layers.thread(ident) == layers.thread(2055412992) == 2055412992
    assert layers.thread(-2055412992) == 2055412992
    assert layers.thread(734000832) == 734000832
    spans = layers.Spans([("march", -1, ident, 0.0, 10.0)])
    assert spans.innermost("2055412992", 5.0) == 0
    assert spans.innermost(734000832, 5.0) is None
