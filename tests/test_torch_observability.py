"""The port's telemetry and small top-level modules, on the CPU, against
the JAX package: the metrics registry's exposition (Prometheus text,
tables, snapshots) byte for byte, host events and their Chrome trace,
the Executor's seven metric families and ``trace_ops``, ``stat``,
``profiler``, ``flags``, ``errors``, ``default_scope_funcs`` and
``net_drawer``.

Tolerances: text and dicts are compared exactly; the executor's fetches
with ``trace_ops`` on are bit-identical to those with it off; the fc
program's fetches agree with the JAX package's to rtol 1e-5 / atol 1e-6
(float32)."""

import gc
import io
import json
import os
import sys
import threading
import weakref

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import errors as jax_errors
from paddle_tpu import flags as jax_flags
from paddle_tpu import net_drawer as jax_net_drawer
from paddle_tpu import observability as jax_obs
from paddle_tpu import stat as jax_stat
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu_torch import (default_scope_funcs, errors, flags,
                              net_drawer, observability as obs, profiler,
                              stat)
from paddle_tpu_torch.observability import metrics
from test_torch_demos import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def fresh_port_telemetry():
    """A zeroed port registry and event ring for each test, as
    tests/conftest.py gives the JAX package's."""
    obs.reset()
    yield
    obs.reset()


def _record(m):
    """The same values recorded into a fresh registry of metrics module
    ``m``: counters and gauges with awkward labels, an empty family,
    histograms with values past the last bucket and on a bucket edge."""
    reg = m.MetricsRegistry()
    c = reg.counter("resp_total", "responses by code")
    c.inc(2, code="200")
    c.inc(code="429", tenant='we"ird\\ten\nant')
    c.inc(0.25, code="503")
    c.inc(1e16, code="big")
    reg.counter("never_total", "no values")          # empty: not rendered
    reg.gauge("no_help_gauge").set(-3.5)
    g = reg.gauge("inflight", "in flight")
    g.inc()
    g.inc(4, worker="a")
    g.dec(worker="a")
    h = reg.histogram("req_seconds", "latency", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.1, 0.5, 5.0, 50.0, 0.0):
        h.observe(v, endpoint="/predict")
    h.observe(2.0, endpoint='/gen"erate')
    hc = reg.histogram("compile_seconds", buckets=m.COMPILE_TIME_BUCKETS)
    hc.observe(0.3, program="abc")
    hd = reg.histogram("default_seconds")
    for v in np.linspace(0.0001, 12.0, 37):
        hd.observe(float(v))
    return reg


def test_exposition_byte_equal_to_the_reference():
    port, ref = _record(metrics), _record(jax_metrics)
    text = port.render_prometheus()
    assert text == ref.render_prometheus()
    assert text.endswith("\n") and "never_total" not in text
    assert '\\"' in text and "\\\\" in text and "\\n" in text
    assert 'req_seconds_bucket{endpoint="/predict",le="+Inf"} 6' in text
    assert "resp_total{code=\"big\"} 1e+16" in text
    assert port.snapshot() == ref.snapshot()
    assert port.render_table() == ref.render_table()
    assert metrics.format_snapshot(json.loads(json.dumps(port.snapshot()))) \
        == jax_metrics.format_snapshot(ref.snapshot())
    rows = [("a", "1"), ("long_name", "22", "x"), ("b",)]
    for headers in (None, ("k", "v", "w")):
        assert metrics.format_table(rows, headers) == \
            jax_metrics.format_table(rows, headers)
    assert metrics.format_table([]) == jax_metrics.format_table([]) == ""
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        for labels in ({"endpoint": "/predict"}, {"endpoint": "none"}):
            a = port.get("req_seconds").quantile(q, **labels)
            b = ref.get("req_seconds").quantile(q, **labels)
            assert a == b or (np.isnan(a) and np.isnan(b))
    assert metrics.MetricsRegistry().render_prometheus() == ""


def test_registry_kinds_gauge_and_histogram_helpers():
    reg = metrics.MetricsRegistry()
    c = reg.counter("c_total")
    assert reg.counter("c_total") is c and reg.get("c_total") is c
    assert reg.get("missing") is None
    with pytest.raises(TypeError):
        reg.gauge("c_total")
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("g")
    g.inc()
    g.inc()
    g.dec()
    assert g.value() == 1
    g.set(7, tenant="a")
    assert sorted(map(sorted, map(dict.items, g.label_sets()))) == [
        [], [("tenant", "a")]]
    h = reg.histogram("h_seconds", buckets=(0.5, 1.0))
    with h.time(stage="x"):
        pass
    assert h.count(stage="x") == 1 and h.count(stage="y") == 0
    assert np.isnan(h.quantile(0.5, stage="y"))
    assert metrics.COMPILE_TIME_BUCKETS == jax_metrics.COMPILE_TIME_BUCKETS
    assert metrics.DEFAULT_LATENCY_BUCKETS == \
        jax_metrics.DEFAULT_LATENCY_BUCKETS


def test_reset_keeps_families_and_handles():
    c = metrics.counter("obs_test_reset_total", "probe")
    c.inc(3, k="v")
    assert obs.snapshot()["obs_test_reset_total"]["values"]
    obs.reset()
    assert "obs_test_reset_total" not in obs.snapshot()
    assert metrics.REGISTRY.get("obs_test_reset_total") is c
    c.inc()
    assert metrics.counter("obs_test_reset_total") is c and c.value() == 1


def test_registry_thread_safety():
    """More writer threads than cores and a short switch interval: a
    lost update would break the totals."""
    reg = metrics.MetricsRegistry()
    c = reg.counter("hits_total")
    g = reg.gauge("depth")
    h = reg.histogram("obs_seconds")
    n_threads, n_iter = 4 * (os.cpu_count() or 2), 300

    def work():
        for _ in range(n_iter):
            c.inc(program="p")
            g.inc()
            g.dec(0.5)
            h.observe(0.01)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert c.value(program="p") == n_threads * n_iter
    assert g.value() == n_threads * n_iter * 0.5
    assert h.count() == n_threads * n_iter


def test_chrome_trace_is_well_formed(tmp_path):
    ev = obs.EventRecorder(max_events=4)
    with ev.span("outer", cat="t", k=1):
        ev.instant("mark")
    ev.complete("x", ev.now(), -1.0)
    for i in range(5):
        ev.instant(f"i{i}")
    assert len(ev.events()) == 4          # bounded ring
    path = ev.export(str(tmp_path / "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    assert doc["displayTimeUnit"] == "ms"
    assert doc["otherData"]["recorder"] == "paddle_tpu_torch.observability"
    for e in doc["traceEvents"]:
        assert {"name", "cat", "ph", "ts", "pid", "tid"} <= set(e)
        assert e["ph"] in ("X", "i")
    ev.clear()
    assert ev.events() == []
    ev2 = obs.EventRecorder()
    with ev2.span("s", cat="c", a=2):
        pass
    (e,) = ev2.events()
    assert e["ph"] == "X" and e["dur"] >= 0 and e["args"] == {"a": 2}
    out = obs.export_chrome_trace(str(tmp_path / "global.json"))
    with open(out) as f:
        assert json.load(f)["traceEvents"] == []


# ---------------------------------------------------------------------------
# the executor's telemetry
# ---------------------------------------------------------------------------


def _fc_programs(rng):
    """A tiny fc + softmax in the JAX package, the same program in the
    port (``Program.from_dict``) and its parameters in both scopes."""
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    pred = fluid.layers.fc(input=x, size=3, act="softmax")
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(fluid.default_startup_program())
    jprog = fluid.default_main_program().clone(for_test=True)
    pprog = pt.Program.from_dict(jprog.to_dict())
    scope = pt.Scope()
    scope.load_numpy({n: np.asarray(v) for n, v in
                      fluid.global_scope().values.items()}, "cpu")
    return jexe, jprog, pprog, scope, pred.name


_EXECUTOR_FAMILIES = frozenset({
    "executor_compile_cache_miss_total", "executor_compile_cache_hit_total",
    "executor_compile_seconds", "executor_feed_convert_seconds",
    "executor_step_seconds", "executor_fetch_seconds",
    "executor_fetch_device_to_host_bytes_total"})


def _families(snap, source):
    """The seven executor families of a snapshot, per label set (times
    dropped: only the counts are comparable)."""
    out = {}
    for name, fam in snap.items():
        if name not in _EXECUTOR_FAMILIES:
            continue
        for v in fam["values"]:
            labels = dict(v["labels"])
            if labels.get("source") == source:
                labels["source"] = "SOURCE"
            key = (name, tuple(sorted(labels.items())))
            out[key] = v.get("value", v.get("count"))
    return out


def test_executor_families_match_the_reference(rng):
    jexe, jprog, pprog, scope, fetch = _fc_programs(rng)
    jax_obs.reset()
    pexe = pt.Executor(pt.CPUPlace())
    xs = [rng.randn(n, 4).astype(np.float32) for n in (2, 2, 5)]
    for x in xs:
        (want,) = jexe.run(jprog, feed={"x": x}, fetch_list=[fetch])
        (got,) = pexe.run(pprog, feed={"x": x}, fetch_list=[fetch],
                          scope=scope)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    label = pprog.fingerprint()[:12]
    assert label == jprog.fingerprint()[:12]
    snap, jsnap = obs.snapshot(), jax_obs.snapshot()
    assert _EXECUTOR_FAMILIES <= set(snap)
    miss = metrics.REGISTRY.get("executor_compile_cache_miss_total")
    hit = metrics.REGISTRY.get("executor_compile_cache_hit_total")
    # two feed shapes: miss, hit, miss
    assert miss.value(program=label, source="plan") == 2
    assert hit.value(program=label, source="plan") == 1
    step = metrics.REGISTRY.get("executor_step_seconds")
    assert step.count(program=label, cached="miss") == 2
    assert step.count(program=label, cached="hit") == 1
    fetched = metrics.REGISTRY.get("executor_fetch_device_to_host_bytes_total")
    assert fetched.value(program=label) == 9 * 3 * 4
    # the same families, label sets and counts as the reference's, its
    # source "jit" where the port's is "plan"
    assert _families(snap, "plan") == _families(jsnap, "jit")
    names_of = [e["name"] for e in obs.GLOBAL_EVENTS.events()]
    assert names_of.count("executor.compile") == 2
    assert names_of.count("executor.step") == 3
    for e in obs.GLOBAL_EVENTS.events():
        assert e["args"]["program"] == label


def test_trace_ops_keys_the_plan_cache_and_keeps_results(rng):
    _, _, prog, scope, fetch = _fc_programs(rng)
    exe = pt.Executor(pt.CPUPlace())
    x = rng.randn(3, 4).astype(np.float32)
    (base,) = exe.run(prog, feed={"x": x}, fetch_list=[fetch], scope=scope)
    label = prog.fingerprint()[:12]
    try:
        flags.FLAGS.set("trace_ops", True)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            (traced,) = exe.run(prog, feed={"x": x}, fetch_list=[fetch],
                                scope=scope)
        (traced2,) = exe.run(prog, feed={"x": x}, fetch_list=[fetch],
                             scope=scope)
    finally:
        flags.FLAGS.set("trace_ops", False)
    np.testing.assert_array_equal(traced, base)
    np.testing.assert_array_equal(traced2, base)
    miss = metrics.REGISTRY.get("executor_compile_cache_miss_total")
    hit = metrics.REGISTRY.get("executor_compile_cache_hit_total")
    # the plain and the traced plan, both built; the traced rerun cached
    assert miss.value(program=label, source="plan") == 2
    assert hit.value(program=label, source="plan") == 1
    op_types = [op.type for op in prog.global_block().ops
                if op.type not in ("feed", "fetch")]
    ranges = [e.name for e in prof.events() if e.name in set(op_types)]
    assert sorted(ranges) == sorted(op_types)


def test_check_program_raises_instead_of_being_ignored(rng):
    """With check_program the verifier's error tier runs at a plan miss:
    a valid program runs, and one that reads a variable nothing writes
    raises ProgramVerificationError (PVE01) before any op runs."""
    from paddle_tpu_torch.analysis import ProgramVerificationError

    _, _, prog, scope, fetch = _fc_programs(rng)
    exe = pt.Executor(pt.CPUPlace())
    try:
        flags.FLAGS.set("check_program", True)
        (out,) = exe.run(prog, feed={"x": np.zeros((1, 4), np.float32)},
                         fetch_list=[fetch], scope=scope)
        assert out.shape == (1, 3)
        block = prog.global_block()
        block.create_var(name="ghost_out", shape=[4], dtype="float32")
        block.append_op(type="relu", inputs={"X": ["never_written"]},
                        outputs={"Out": ["ghost_out"]})
        with pytest.raises(ProgramVerificationError, match="PVE01"):
            exe.run(prog, feed={"x": np.zeros((1, 4), np.float32)},
                    fetch_list=["ghost_out"], scope=scope)
    finally:
        flags.FLAGS.set("check_program", False)


def test_step_overhead_within_budget():
    """The reference's budget: far inside 2% of a step (200 µs with an
    order of magnitude of slack for loaded CI hosts)."""
    overhead = obs.measure_step_overhead(iters=1000)
    assert 0 < overhead < 200e-6, f"telemetry overhead {overhead * 1e6:.1f} µs"


# ---------------------------------------------------------------------------
# stat, profiler, flags, errors
# ---------------------------------------------------------------------------


def test_stat_timed_keeps_name_and_prints_through_the_table():
    stats = stat.StatSet("probe")

    @stat.timed("work", stats)
    def compute(a, b=2):
        """Doc."""
        return a * b

    assert compute.__name__ == "compute" and compute.__doc__ == "Doc."
    assert compute(3) == 6 and compute(4, b=1) == 4
    with stat.timer("other", stats):
        pass
    items = stats.items()
    assert items["work"].count == 2 and items["other"].count == 1
    buf = io.StringIO()
    stats.print_status(out=buf)
    lines = buf.getvalue().splitlines()
    assert lines[0] == "======= StatSet: [probe] ======="
    assert lines[1].split() == ["timer", "total_ms", "avg_ms", "max_ms",
                                "count"]
    # the same rows through the reference's printer
    ref = jax_stat.StatSet("probe")
    ref._items = stats._items
    rbuf = io.StringIO()
    ref.print_status(out=rbuf)
    assert rbuf.getvalue() == buf.getvalue()
    stats.reset()
    assert stats.items() == {}
    assert stat.GLOBAL_STATS.name == jax_stat.GLOBAL_STATS.name


def test_profiler_rejects_unknown_options_and_writes_a_trace(tmp_path):
    with pytest.raises(TypeError, match="bogus_option"):
        with profiler.profiler(str(tmp_path), place=pt.CPUPlace(),
                               bogus_option=1):
            pass
    assert not os.listdir(tmp_path)          # rejected before the trace
    assert "activities" not in profiler._profile_options()
    assert "record_shapes" in profiler._profile_options()
    with profiler.profiler(str(tmp_path), place=pt.CPUPlace(),
                           record_shapes=True):
        with profiler.annotate("probe_range"):
            torch.ones(4).sum()
    with open(tmp_path / profiler.TRACE_FILE) as f:
        doc = json.load(f)
    assert any(e.get("name") == "probe_range" for e in doc["traceEvents"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CPUPlace"):
            with profiler.profiler(str(tmp_path)):
                pass


def test_flags_match_the_reference(monkeypatch):
    port, ref = flags.FLAGS, jax_flags.FLAGS
    assert set(port._defs) == set(ref._defs)
    for name, (default, typ, _) in ref._defs.items():
        assert port._defs[name][:2] == (default, typ), name
        assert port.get(name) == ref.get(name)
    saved = (dict(port._vals), dict(ref._vals))
    try:
        for f in (port, ref):
            f.set("log_period", "13")
            f.set("show_layer_stat", "Yes")
            f.set("use_gpu", 1)
            f.set("undeclared", "raw")
        for name in ("log_period", "show_layer_stat", "use_gpu",
                     "undeclared"):
            assert port.get(name) == ref.get(name)
            assert type(port.get(name)) is type(ref.get(name))
        assert port.log_period == 13 and port.show_layer_stat is True
        assert port.get("nope", 5) == 5 and port.nope is None
        with pytest.raises(AttributeError):
            port._private
        monkeypatch.setenv("PADDLE_SEED", "7")
        monkeypatch.setenv("PADDLE_TRACE_OPS", "0")
        flags.init_from_env()
        jax_flags.init_from_env()
        assert port.seed == ref.seed == 7 and port.trace_ops is False
        argv = ["--num_passes=3", "pos", "--flag", "--save_dir=d"]
        assert flags.init_gflags(argv) == jax_flags.init_gflags(argv) == [
            "pos", "--flag"]
        assert port.num_passes == ref.num_passes == 3
    finally:
        port._vals.clear()
        port._vals.update(saved[0])
        ref._vals.clear()
        ref._vals.update(saved[1])


def test_v2_init_records_its_flags():
    from paddle_tpu_torch import v2

    saved = dict(flags.FLAGS._vals)
    try:
        v2.init(use_gpu=False, trainer_count=1)
        assert flags.FLAGS.use_gpu is False
        assert flags.FLAGS.trainer_count == 1
        v2.init(use_gpu=True)
        assert flags.FLAGS.use_gpu is True
        with pytest.raises(NotImplementedError):
            v2.init(trainer_count=2)
    finally:
        flags.FLAGS._vals.clear()
        flags.FLAGS._vals.update(saved)


def test_errors_and_enforce():
    errors.enforce(True, "never %s", "raised")
    with pytest.raises(errors.EnforceNotMet, match="bad 3 of 4"):
        errors.enforce(0, "bad %d of %d", 3, 4)
    with pytest.raises(errors.PaddleError, match="plain"):
        errors.enforce([], "plain")
    names = [n for n in dir(jax_errors) if n.endswith("Error")
             or n == "EnforceNotMet"]
    for n in names:
        assert issubclass(getattr(errors, n), errors.PaddleError) or \
            n == "PaddleError"
        assert [b.__name__ for b in getattr(errors, n).__mro__] == \
            [b.__name__ for b in getattr(jax_errors, n).__mro__]


# ---------------------------------------------------------------------------
# default_scope_funcs, diagnostics, net_drawer
# ---------------------------------------------------------------------------


def test_default_scope_funcs():
    results = {}

    def body():
        root = default_scope_funcs.get_cur_scope()
        assert root is pt.global_scope()
        default_scope_funcs.var("a").set(np.ones(2, np.float32),
                                         pt.CPUPlace())
        local = default_scope_funcs.enter_local_scope()
        assert default_scope_funcs.get_cur_scope() is local
        assert local.parent is root
        # a lookup climbs to the parent; a set stays local
        holder = default_scope_funcs.find_var("a")
        assert holder.get_tensor().tolist() == [1.0, 1.0]
        default_scope_funcs.var("b").set(torch.zeros(3), pt.CPUPlace())
        assert default_scope_funcs.find_var("b") is not None
        default_scope_funcs.leave_local_scope()
        assert default_scope_funcs.find_var("b") is None
        # nothing keeps the left scope (and its tensors) alive
        left = weakref.ref(local)
        del local
        gc.collect()
        assert left() is None
        default_scope_funcs.leave_local_scope()   # never pops the root
        assert default_scope_funcs.get_cur_scope() is root

        @default_scope_funcs.scoped_function
        def inner():
            """Runs in a fresh scope."""
            results["inner"] = default_scope_funcs.get_cur_scope()

        inner()
        assert inner.__name__ == "inner"
        assert results["inner"].parent is root
        assert default_scope_funcs.get_cur_scope() is root
        root.values.pop("a")

    def run():
        try:
            body()
        except BaseException as exc:  # noqa: BLE001 - reported below
            results["error"] = exc

    # a thread of its own: the stack is thread-local
    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and results.get("error") is None
    assert "inner" in results
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CPUPlace"):
            pt.Scope().var("x").set(np.zeros(1))


def test_capture_stderr_fd(capfd):
    from paddle_tpu_torch.diagnostics import capture_stderr_fd

    with capture_stderr_fd() as got:
        os.write(2, b"native warning\n")
        assert got() == ""
    assert got() == "native warning\n"
    assert "native warning" in capfd.readouterr().err


def test_net_drawer_dot_equals_the_reference(tmp_path):
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    h = fluid.layers.fc(input=x, size=5, act="relu")
    pred = fluid.layers.fc(input=h, size=3, act="softmax")
    label = fluid.layers.data(name="y", shape=[1], dtype="int64")
    loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
    fluid.optimizer.SGD(0.1).minimize(loss)
    jprog = fluid.default_main_program()
    pprog = pt.Program.from_dict(jprog.to_dict())
    want = jax_net_drawer.draw_graph(jprog)
    assert net_drawer.draw_graph(pprog) == want
    assert "fillcolor=\"lightgrey\"" in want   # parameters shaded
    # the same from a program built in the port
    pt.framework.reset_default_programs()
    px = pt.layers.data(name="x", shape=[4])
    pt.layers.fc(px, size=3, act="softmax")
    port_dot = net_drawer.draw_graph(name="net")
    assert port_dot.startswith("digraph net {") and port_dot.endswith("}")
    path = net_drawer.save_graph(str(tmp_path / "g.dot"), pprog)
    with open(path) as f:
        assert f.read() == want
