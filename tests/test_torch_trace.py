"""The port's layer spans (sz3_tpu_torch.utils.trace): off, a span site
records nothing; on, spans nest, take their parent and the call id of their
public call, cross to worker threads with a handed parent, and fill a
bounded buffer that counts what it drops. Round trips on the CPU name every
layer of the INTERP and LORENZO_REG routes under their public call, with
the counters their callers hold, and write the same archives with tracing
on and off; ``interp.passes`` carries the plan's rank and the points its
passes predicted at 2D, 3D and 4D, and the INTERP passes' roofline bytes
come to 28 a float32 point at the 512^3 plan. On a CUDA card, every K1 and
K2+K3 launch lies inside its entropy span, in the profiler's timeline and on
the host clock.

Run the card's case:  python -m pytest tests/test_torch_trace.py -q -m cuda
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

import sz3_tpu_torch as szp
from sz3_tpu_torch import runtime, serving
from sz3_tpu_torch import utils as putils
from sz3_tpu_torch.ops import blockwise_layout as bl
from sz3_tpu_torch.algos import device_encode
from sz3_tpu_torch.ops import blockwise_wavefront_encode as wfe
from sz3_tpu_torch.ops import interp_fast
from sz3_tpu_torch.utils import trace
from szbench.roofline import interp_encode, stages

INTERP_ENCODE = {"api.compress", "dispatch.bound", "dispatch.tune", "tune.sample",
                 "tune.trials", "tune.seal", "copy.h2d", "interp.passes",
                 "interp.stream_order", "entropy.hist", "entropy.tree", "entropy.pack",
                 "copy.d2h", "copy.wait", "seal", "archive.pack"}
LORENZO_ENCODE = {"api.compress", "dispatch.bound", "copy.h2d", "lorenzo.encode",
                  "lorenzo.fits", "lorenzo.select", "lorenzo.chain", "lorenzo.preplace",
                  "lorenzo.sweep", "lorenzo.stream_order", "entropy.hist", "entropy.tree",
                  "entropy.pack", "copy.d2h", "copy.wait", "seal", "archive.pack"}
DECODE = {"api.decompress", "archive.open", "open", "entropy.decode", "copy.h2d"}


@pytest.fixture
def traced():
    """Tracing on with an empty buffer; off and empty again afterwards."""
    trace.spans()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.spans()


def _field(n=40, seed=0):
    rng = np.random.default_rng(seed)
    return np.exp(0.05 * np.cumsum(rng.standard_normal((n, n, n)), 0)).astype(np.float32)


def _under_root(spans, root):
    """Every span reaches `root` through its parents and shares its call id."""
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.call == root.id, s
        up = s
        while up.parent is not None:
            up = by_id[up.parent]
        assert up is root, s


def test_off_records_nothing():
    trace.disable()
    trace.spans()
    s = trace.span("api.compress", nbytes=1)
    assert s is trace.OFF and trace.span("seal") is trace.OFF
    with s as h:
        assert h.set(total_bits=3) is trace.OFF
        assert trace.current() is None
    szp.compress(_field(12), szp.Config(absErrorBound=1e-2), device="cpu")
    got = trace.spans()
    assert list(got) == [] and got.dropped == 0


def test_nesting_parents_and_call_id(traced):
    with trace.span("api.compress", nbytes=8) as a:
        assert trace.current() is a
        with trace.span("dispatch.tune") as b:
            with trace.span("tune.trials") as c:
                c.set(trials=2)
        with trace.span("seal") as d:
            pass
    with trace.span("api.decompress") as e:
        pass
    got = trace.spans()
    assert [s.name for s in got] == ["tune.trials", "dispatch.tune", "seal", "api.compress",
                                     "api.decompress"]
    assert (a.parent, b.parent, c.parent, d.parent, e.parent) == (None, a.id, b.id, a.id, None)
    assert a.call == b.call == c.call == d.call == a.id and e.call == e.id != a.id
    assert c.attrs == {"trials": 2} and a.attrs == {"nbytes": 8}
    assert a.t0 <= b.t0 <= c.t0 <= c.t1 <= b.t1 <= d.t0 <= d.t1 <= a.t1 <= e.t0
    assert {s.thread for s in got} == {threading.get_ident()}
    assert trace.current() is None


def test_a_parent_handed_to_a_worker_thread(traced):
    seen = {}

    def work(parent):
        with trace.span("serving.seal", parent=parent) as w:
            with trace.span("seal") as inner:
                seen["w"], seen["inner"] = w, inner

    with trace.span("serving.field", field=0) as field:
        t = threading.Thread(target=work, args=(trace.current(),))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    w, inner = seen["w"], seen["inner"]
    assert w.parent == field.id and w.call == field.call == field.id
    assert inner.parent == w.id and inner.call == field.id
    assert w.thread != field.thread and inner.thread == w.thread
    assert {s.name for s in trace.spans()} == {"serving.field", "serving.seal", "seal"}


def test_the_bounded_buffer_counts_drops(traced, monkeypatch):
    monkeypatch.setattr(trace, "LIMIT", 3)
    for i in range(5):
        with trace.span("copy.h2d", bytes=i):
            pass
    got = trace.spans()
    assert [s.attrs["bytes"] for s in got] == [0, 1, 2] and got.dropped == 2
    again = trace.spans()
    assert list(again) == [] and again.dropped == 0


@pytest.mark.parametrize("route", ["interp", "lorenzo"])
def test_round_trip_names_every_layer(traced, route):
    x = _field()
    conf = szp.Config(errorBoundMode=szp.EB.REL, relErrorBound=1e-3)
    encode, decode = INTERP_ENCODE, DECODE | {"interp.decode"}
    if route == "lorenzo":
        conf.cmprAlgo = szp.ALGO.LORENZO_REG
        encode, decode = LORENZO_ENCODE, DECODE | {"lorenzo.decode"}
    blob = szp.compress(x, conf.copy(), device="cpu")
    out, _ = szp.decompress(blob, device="cpu")
    got = trace.spans()
    roots = [s for s in got if s.parent is None]
    assert [s.name for s in roots] == ["api.compress", "api.decompress"]
    enc = [s for s in got if s.call == roots[0].id]
    dec = [s for s in got if s.call == roots[1].id]
    assert {s.name for s in enc} == encode and {s.name for s in dec} == decode
    _under_root(enc, roots[0])
    _under_root(dec, roots[1])
    assert roots[0].attrs["nbytes"] == x.nbytes and roots[0].attrs["archive_bytes"] == len(blob)
    assert roots[1].attrs["nbytes"] == x.nbytes
    assert all(s.t1 >= s.t0 > 0 for s in got)

    trace.disable()
    assert szp.compress(x, conf.copy(), device="cpu") == blob
    assert torch.equal(szp.decompress(blob, device="cpu")[0], out)
    assert list(trace.spans()) == []


def test_lorenzo_passes_are_the_stats_passes(traced, monkeypatch):
    """With the speculated selection replaced by its complement the
    certification makes several passes; the span's count is the one the
    caller's stats receive, and each pass has its chain, preplace, sweep
    and certifying select."""
    select = wfe.select

    def complement(geo, orig_p, tap_p, *args):
        is_reg, ok = select(geo, orig_p, tap_p, *args)
        if tap_p is orig_p:
            return ~is_reg & bl.reg_valid(geo, orig_p.device), ok
        return is_reg, ok

    monkeypatch.setattr(wfe, "select", complement)
    f = np.random.default_rng(7).standard_normal((20, 19, 17)).astype(np.float32)
    x = torch.from_numpy((np.cumsum(f, 0) * 0.1 + np.cumsum(f, -1) * 0.05).astype(np.float32))
    stats = {}
    wfe.encode_blocks_wavefront(x, 1e-1, 32768, True, False, True, stats)
    got = trace.spans()
    enc, = [s for s in got if s.name == "lorenzo.encode"]
    assert stats["passes"] > 3 and enc.attrs["passes"] == stats["passes"]
    assert enc.attrs["blocks"] == bl.geometry(tuple(x.shape)).nblk
    count = {n: sum(s.name == n for s in got) for n in
             ("lorenzo.chain", "lorenzo.preplace", "lorenzo.sweep", "lorenzo.select")}
    assert count == {"lorenzo.chain": stats["passes"], "lorenzo.preplace": stats["passes"],
                     "lorenzo.sweep": stats["passes"], "lorenzo.select": stats["passes"] + 1}
    selects = [s.attrs for s in got if s.name == "lorenzo.select"]
    assert selects[0] == {"phase": "speculate", "pass_no": 0, "route": "plain"}
    assert [a["pass_no"] for a in selects[1:]] == list(range(1, stats["passes"] + 1))
    assert all(a["phase"] == "certify" and a["route"] == "plain" for a in selects[1:])

    trace.spans()                       # through the public call, the same count
    blob = szp.compress(x.numpy(), szp.Config(absErrorBound=1e-1,
                                              cmprAlgo=szp.ALGO.LORENZO_REG), device="cpu")
    enc, = [s for s in trace.spans() if s.name == "lorenzo.encode"]
    assert enc.attrs["passes"] == stats["passes"] and len(blob) > 0


def test_seal_takes_the_engine_arguments(traced, monkeypatch):
    handed = []
    real = runtime.interp_seal_packed

    def seal(conf, tree, bits, bit_count, count, unpred, cap):
        handed.append((bit_count, count))
        return real(conf, tree, bits, bit_count, count, unpred, cap)

    monkeypatch.setattr(runtime, "interp_seal_packed", seal)
    blob = szp.compress(_field(24, seed=3), szp.Config(absErrorBound=1e-3), device="cpu")
    sealed, = [s for s in trace.spans() if s.name == "seal"]
    assert handed == [(sealed.attrs["bit_count"], sealed.attrs["symbols"])]
    assert sealed.attrs["symbols"] == 24 ** 3 and 0 < sealed.attrs["payload_bytes"] < len(blob)


@pytest.mark.parametrize("shape", [(117, 117), (40, 40, 40)])
def test_tune_span_carries_the_decision(traced, shape):
    """dispatch.tune holds the tuner's pick, equal to the Config the archive
    carries, with the sample's edge and blocks and the winner's ratio."""
    rng = np.random.default_rng(5)
    x = np.exp(0.05 * np.cumsum(rng.standard_normal(shape), 0)).astype(np.float32)
    blob = szp.compress(x, szp.Config(errorBoundMode=szp.EB.REL, relErrorBound=1e-4),
                        device="cpu")
    _, carried = szp.decompress(blob, device="cpu")
    tune, = [s for s in trace.spans() if s.name == "dispatch.tune"]
    a = tune.attrs
    assert carried.cmprAlgo == szp.ALGO.INTERP
    assert (a["interp_algo"], a["direction"], a["alpha"], a["beta"]) == \
        (int(carried.interpAlgo), carried.interpDirection, carried.interpAlpha,
         carried.interpBeta)
    assert a["trials"] == 6 and a["blocks"] > 0 and a["est_ratio"] > 0
    assert a["edge"] >= 9 and (a["edge"] - 1) & (a["edge"] - 2) == 0   # a power of two, plus 1


@pytest.mark.parametrize("shape", [(117, 117), (40, 33, 20), (19, 11, 13, 10), (35, 23, 19, 19)])
def test_interp_passes_carry_rank_and_predicted(traced, shape):
    """interp.passes holds the plan's rank and the points its passes
    predicted: the sum of n0 n1 n2 n3 over pass_geometry's rows, which is
    every point but the anchors (or but the first point, without them)."""
    rng = np.random.default_rng(9)
    x = np.exp(0.05 * np.cumsum(rng.standard_normal(shape), 0)).astype(np.float32)
    blob = szp.compress(x, szp.Config(errorBoundMode=szp.EB.REL, relErrorBound=1e-4),
                        device="cpu")
    _, carried = szp.decompress(blob, device="cpu")
    passes, = [s.attrs for s in trace.spans() if s.name == "interp.passes"]
    plan = device_encode.plan_for(carried)
    rows = [interp_fast.pass_geometry(spec, plan.dims) for spec in plan.passes]
    anchor = plan.anchor_stride
    fixed = int(np.prod([len(range(0, n, anchor)) for n in shape])) if anchor else 1
    assert passes["rank"] == len(shape) and passes["points"] == x.size
    assert passes["predicted"] == sum(int(np.prod(r[:4])) for r in rows) == x.size - fixed


def test_interp_encode_bytes_at_the_512_plan():
    """The roofline's bytes of the INTERP passes count 28 bytes a float32
    point at the 512^3 plan (chip_smoke.py's bound: 1.122 ms at 3.35 TB/s)."""
    n = 512 ** 3
    plan = interp_fast.build_fast_plan((512,) * 3, interp_algo=1, direction=0,
                                       anchor_stride=32, alpha=1.25, beta=2.0, eb=1e-3,
                                       quantbin_cnt=65536)
    predicted = interp_fast.pass_points(plan)
    assert predicted == n - 16 ** 3
    nbytes = interp_encode.interp_encode_bytes(n, predicted, 4)
    assert nbytes / n == pytest.approx(28, abs=1e-3)
    assert stages.bound_s(nbytes) * 1e3 == pytest.approx(1.122, abs=5e-4)
    assert interp_encode.interp_encode_bytes(n, n, 8) == 48 * n


def test_batch_seals_run_under_their_fields(traced):
    stack = np.stack([_field(16, seed=s) for s in range(4)])
    blobs = serving.compress_batch(stack, szp.Config(absErrorBound=1e-3), device="cpu")
    got = trace.spans()
    root, = [s for s in got if s.parent is None]
    assert root.name == "serving.compress_batch" and all(s.call == root.id for s in got)
    fields = {s.attrs["field"]: s for s in got if s.name == "serving.field"}
    seals = {s.attrs["field"]: s for s in got if s.name == "serving.seal"}
    assert sorted(fields) == sorted(seals) == list(range(4))
    for i, s in seals.items():
        assert s.parent == fields[i].id and s.thread != root.thread
        inner, = [c for c in got if c.name == "seal" and c.parent == s.id]
        assert inner.attrs["symbols"] == 16 ** 3
    trace.disable()
    assert serving.compress_batch(stack, szp.Config(absErrorBound=1e-3), device="cpu") == blobs


def test_device_trace_names_the_layer_spans(tmp_path):
    trace.disable()
    trace.spans()
    with putils.device_trace(tmp_path / "trace"):
        assert trace.enabled()
        szp.compress(_field(24), szp.Config(absErrorBound=1e-3), device="cpu")
    assert not trace.enabled()
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"api.compress", "interp.passes", "entropy.hist", "entropy.pack", "seal"} <= names
    assert "api.compress" in {s.name for s in trace.spans()}


def test_device_trace_leaves_tracing_on(traced, tmp_path):
    with putils.device_trace(tmp_path / "trace"):
        pass
    assert trace.enabled()


def test_spans_without_profiler_ranges(traced, tmp_path):
    """enable(ranges=False): the spans are kept, and the profiler's timeline
    gets no range of theirs."""
    from torch.profiler import ProfilerActivity, profile

    trace.enable(ranges=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        szp.compress(_field(16), szp.Config(absErrorBound=1e-3), device="cpu")
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    names = {e.get("name") for e in json.loads((tmp_path / "t.json").read_text())["traceEvents"]}
    kept = {s.name for s in trace.spans()}
    assert "api.compress" in kept and "entropy.hist" in kept and not kept & names


@pytest.mark.cuda
def test_entropy_launches_lie_inside_their_spans(traced):
    """A 64^3 compress under torch.profiler: each K1 launch (count and
    placement kernels) lies inside an ``entropy.hist`` range, each K2+K3
    launch (table, sum and write kernels) inside an ``entropy.pack`` one,
    in the profiler's own timeline and, through a marker, on the host
    clock of the spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = _field(64)
    conf = szp.Config(absErrorBound=1e-3)
    szp.compress(x, conf.copy())                  # builds the kernels, warms the caches
    trace.spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        mark = time.perf_counter_ns()
        torch.cuda.mem_get_info()                 # a runtime call on the launches' clock
        szp.compress(x, conf.copy())
        torch.cuda.synchronize()
    spans = trace.spans()
    events = prof.profiler.kineto_results.events()
    host = [e for e in events if e.device_type() != DeviceType.CUDA]
    launch = {e.correlation_id(): e.start_ns() for e in host
              if e.correlation_id() and e.name().startswith("cu")}
    ranges = {n: [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in host if e.name() == n]
              for n in ("entropy.hist", "entropy.pack")}
    off = min(e.start_ns() for e in host if e.name() == "cudaMemGetInfo") - mark
    want = {"hist_count_kernel": "entropy.hist", "literal_slots_kernel": "entropy.hist",
            "pack_table_kernel": "entropy.pack", "pack_sum_kernel": "entropy.pack",
            "pack_write_kernel": "entropy.pack"}
    seen, outside = set(), []
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            continue
        kernel = next((k for k in want if k in e.name()), None)
        if kernel is None:
            continue
        seen.add(kernel)
        at = launch[e.correlation_id()]
        assert any(a <= at <= b for a, b in ranges[want[kernel]]), kernel
        host_at = at - off
        mine = [s for s in spans if s.name == want[kernel]]
        if not any(s.t0 <= host_at <= s.t1 for s in mine):
            near = min(mine, key=lambda s: abs(host_at - (s.t0 + s.t1) / 2))
            outside.append((kernel, host_at - near.t0, near.t1 - host_at))
    assert seen >= set(want) - {"literal_slots_kernel"}    # placement: only with literals
    assert not outside, f"launches outside their span (kernel, ns after t0, ns before t1): {outside}"
