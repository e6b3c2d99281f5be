"""The port's v1 training loop on the CPU: PyDataProvider2, the v2 data
feeder, ``SGD.train`` / ``test`` with events and prefetch, checkpoints
and parameter tars (crossed with the JAX package both ways), and the
``python -m paddle_tpu_torch.trainer`` command line's train, test and
checkgrad jobs.  The provider, tar, checkpoint and command-line tests are
the port's copies of ``tests/test_v1_api.py``, ``tests/test_v2_api.py``
and ``tests/test_cli.py``'s; the feeder's output must equal the JAX
package's exactly, and a step after a crossed load must give the JAX
package's cost within LOSS_TOL of its value and its parameters within
PARAM_TOL of their largest magnitude."""

import io
import os
import subprocess
import sys

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import io as jax_io
from paddle_tpu.executor import Executor as JaxExecutor
from paddle_tpu.executor import scope_guard as jax_scope_guard
from paddle_tpu.framework import CPUPlace as JaxCPUPlace
from paddle_tpu.v2 import data_type as jdt
from paddle_tpu.v2.trainer import V2DataFeeder as JaxFeeder
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch.trainer import trainer as port_trainer
from paddle_tpu_torch.trainer.config_parser import parse_config
from paddle_tpu_torch.trainer.trainer import Trainer
from paddle_tpu_torch.v2 import data_type as pdt
from paddle_tpu_torch.v2.trainer import V2DataFeeder
from test_torch_demos import (LOSS_TOL, PARAM_TOL, close,  # noqa: F401
                              one_torch_thread, v1_pair)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAFFIC = "paddle_tpu_torch/demos/traffic_prediction/trainer_config.py"


# -- PyDataProvider2 -------------------------------------------------------


def test_provider_decorator_metadata():
    from paddle_tpu_torch.trainer.PyDataProvider2 import (dense_vector,
                                                          integer_value,
                                                          provider)

    @provider(input_types={"a": dense_vector(3), "b": integer_value(2)})
    def p(settings, filename):
        yield {"a": [0.0, 0.0, 0.0], "b": 1}

    assert p.input_types["a"].dim == 3
    rows = list(p(None))
    assert rows[0]["b"] == 1


def test_provider_kwargs_forwarded():
    from paddle_tpu_torch.trainer.PyDataProvider2 import (integer_value,
                                                          provider)

    @provider(input_types={"a": integer_value(10)})
    def p(settings, filename, limit=3):
        for i in range(limit):
            yield {"a": i}

    rows = list(p(None, limit=5))
    assert len(rows) == 5


def test_data_sources_retype_the_data_layers():
    """A config that declares its source first gets its data layers
    typed from the provider's input types once it has run."""
    conf = parse_config(
        "paddle_tpu_torch/demos/sequence_tagging/trainer_config.py")
    assert conf.data_sources["obj"] == "process"
    for name in ("word", "tag"):
        t = conf.data_layers[name].input_type
        assert (t.seq_type, t.dtype) == (1, "int64")


# -- the data feeder -------------------------------------------------------

rng = np.random.RandomState(5)
COLUMNS = {
    "dense": ("dense_vector", (3,), [rng.randn(3).tolist() for _ in range(4)]),
    "int": ("integer_value", (7,), [1, 0, 6, 3]),
    "int_seq": ("integer_value_sequence", (9,),
                [[1, 2], [3], [4, 5, 6, 7, 8], [0] * 17]),
    "dense_seq": ("dense_vector_sequence", (2,),
                  [rng.randn(n, 2).tolist() for n in (1, 4, 2, 3)]),
    "int_nested": ("integer_value_sub_sequence", (9,),
                   [[[1, 2], [3]], [[4]], [[5, 6, 7], [8], [1, 1]], [[2]]]),
    "dense_nested": ("dense_vector_sub_sequence", (2,),
                     [[rng.randn(2, 2).tolist()], [rng.randn(1, 2).tolist(),
                                                   rng.randn(3, 2).tolist()],
                      [rng.randn(1, 2).tolist()], [rng.randn(2, 2).tolist()]]),
    "sparse_binary": ("sparse_binary_vector", (6,), [[0, 2], [5], [], [1, 3]]),
    "sparse_weighted": ("sparse_vector", (6,),
                        [[(0, 0.5), (4, 2.0)], [(5, 1.0)], [(1, -1.0)],
                         [(2, 3.0)]]),
}


@pytest.mark.parametrize("kind", list(COLUMNS))
def test_data_feeder_equals_the_jax_packages(kind):
    ctor, args, column = COLUMNS[kind]
    rows = [(c, i) for i, c in enumerate(column)]
    types = lambda dt: [("col", getattr(dt, ctor)(*args)),  # noqa: E731
                        ("idx", dt.integer_value(10))]
    got = V2DataFeeder(types(pdt)).feed(rows)
    want = JaxFeeder(types(jdt)).feed(rows)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # DataFeeder's column map reorders the rows' fields
    from paddle_tpu_torch.v2.data_feeder import DataFeeder

    swapped = [(i, c) for c, i in rows]
    again = DataFeeder(types(pdt), {"col": 1, "idx": 0}).feed(swapped)
    for name in want:
        np.testing.assert_array_equal(again[name], want[name])


# -- parameter tars and checkpoints ----------------------------------------


def _mse_topology():
    """x (4) -> fc(1) -> mse against y (1), through the v1 DSL."""
    from paddle_tpu_torch.trainer_config_helpers import layers as v1
    from paddle_tpu_torch.v2.topology import Topology

    x = v1.data_layer(name="x", size=4)
    y = v1.data_layer(name="y", size=1)
    pred = v1.fc_layer(input=x, size=1)
    return Topology(v1.regression_cost(input=pred, label=y))


def test_parameters_tar_roundtrip():
    from paddle_tpu_torch.v2.parameters import Parameters

    params = Parameters(_mse_topology(), pt.CPUPlace())
    name = params.keys()[0]
    w = params.get(name)
    buf = io.BytesIO()
    params.to_tar(buf)
    params.set(name, np.zeros_like(w))
    buf.seek(0)
    params.load_tar(buf)
    np.testing.assert_allclose(params.get(name), w)
    buf.seek(0)
    again = Parameters.from_tar(buf, params.topology, pt.CPUPlace())
    np.testing.assert_allclose(again.get(name), w)


def _sgd():
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.v2.parameters import Parameters
    from paddle_tpu_torch.v2.trainer import SGD

    pt.framework.reset_default_programs()
    topo = _mse_topology()
    params = Parameters(topo, pt.CPUPlace())
    return SGD(cost=topo.cost, parameters=params,
               update_equation=opt.Momentum(momentum=0.9,
                                            learning_rate=1e-3))


def _rows_reader(n=48, batch=16):
    r = np.random.RandomState(3)
    rows = [(r.randn(4).astype(np.float32), r.randn(1).astype(np.float32))
            for _ in range(n)]

    def reader():
        for i in range(0, n, batch):
            yield rows[i:i + batch]

    return reader


def test_v2_checkpoint_handler_crash_resume(tmp_path):
    """The CheckpointHandler saves params and optimizer state every
    period and at each pass's end; a fresh trainer restores the newest
    complete step and numbering continues."""
    reader = _rows_reader()
    ck = str(tmp_path / "ck")
    t1 = _sgd()
    t1.train(reader=reader, num_passes=2, checkpoint_dir=ck,
             checkpoint_period=2)
    # 3 batches a pass x 2 passes; period 2 and pass-end saves, keep 3
    assert port_io.latest_checkpoint_step(ck) == 6
    steps = sorted(int(d[5:]) for d in os.listdir(ck)
                   if d.startswith("step_") and d[5:].isdigit())
    assert len(steps) <= 3
    pname = t1.topology.main_program.all_parameters()[0].name
    w_end = np.array(t1.parameters.get(pname))

    t2 = _sgd()
    assert t2.restore_checkpoint(ck) == 6
    np.testing.assert_allclose(np.array(t2.parameters.get(pname)), w_end)
    t2.train(reader=reader, num_passes=1, checkpoint_dir=ck,
             checkpoint_period=2)
    assert port_io.latest_checkpoint_step(ck) == 9
    # a torn write (no marker) is never the latest step
    os.makedirs(os.path.join(ck, "step_12"))
    assert port_io.latest_checkpoint_step(ck) == 9


def test_prefetch_gives_the_same_events_and_costs():
    runs = []
    for prefetch in (False, True):
        t = _sgd()
        events = []
        t.train(reader=_rows_reader(), num_passes=2, prefetch=prefetch,
                event_handler=lambda e: events.append(
                    (type(e).__name__, getattr(e, "pass_id", None),
                     getattr(e, "batch_id", None), getattr(e, "cost", None))))
        pname = t.topology.main_program.all_parameters()[0].name
        runs.append((events, t.parameters.get(pname)))
    (plain, w_plain), (pre, w_pre) = runs
    kinds = lambda ev: [e for e in ev if e[0] != "BeginIteration"]  # noqa
    assert kinds(pre) == kinds(plain)   # the same costs, bit for bit
    assert sorted(pre) == sorted(plain)
    np.testing.assert_array_equal(w_pre, w_plain)
    assert [e[0] for e in plain].count("EndIteration") == 6


def _next_step_matches(jt, port):
    """One step of both on the train source's first batch: the cost,
    then every parameter."""
    jtopo, ptopo = jt._sgd.topology, port._sgd.topology
    jb = next(iter(jt._reader_from_sources()()))
    pb = next(iter(port._reader_from_sources()()))
    with jax_scope_guard(jt.parameters.scope):
        (want,) = JaxExecutor(JaxCPUPlace()).run(
            jtopo.main_program, feed=JaxFeeder(jtopo.feed_types).feed(jb),
            fetch_list=[jtopo.cost_var])
    (got,) = pt.Executor(pt.CPUPlace()).run(
        ptopo.main_program, feed=V2DataFeeder(ptopo.feed_types).feed(pb),
        fetch_list=[ptopo.cost_var], scope=port.parameters.scope)
    want, got = float(np.asarray(want)), float(np.asarray(got))
    assert abs(got - want) <= LOSS_TOL * abs(want), (got, want)
    for name in jt.parameters.keys():
        close(port.parameters.get(name), np.asarray(jt.parameters.get(name)),
              PARAM_TOL, name)


def _scramble(params):
    for name in params.keys():
        params.set(name, np.zeros_like(np.asarray(params.get(name))))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_parameter_tars_cross_both_ways(writer):
    jt, port = v1_pair("traffic_prediction")
    buf = io.BytesIO()
    (jt if writer == "jax" else port).parameters.to_tar(buf)
    reader = port if writer == "jax" else jt
    _scramble(reader.parameters)
    buf.seek(0)
    reader.parameters.load_tar(buf)
    _next_step_matches(jt, port)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_both_ways(writer, tmp_path):
    """Two Adam steps on the writer, its params and moments saved as
    step_2; the reader restores them into a fresh trainer, and the next
    step of the two matches."""
    jt, port = v1_pair("traffic_prediction")
    batches = list(port._reader_from_sources()())[:2]
    if writer == "jax":
        topo = jt._sgd.topology
        feeder = JaxFeeder(topo.feed_types)
        with jax_scope_guard(jt.parameters.scope):
            for b in batches:
                JaxExecutor(JaxCPUPlace()).run(topo.main_program,
                                               feed=feeder.feed(b))
        jax_io.save_checkpoint(str(tmp_path), main_program=topo.main_program,
                               step=2, scope=jt.parameters.scope)
        _, port = v1_pair("traffic_prediction")
        assert port._sgd.restore_checkpoint(str(tmp_path)) == 2
    else:
        topo = port._sgd.topology
        feeder = V2DataFeeder(topo.feed_types)
        for b in batches:
            pt.Executor(pt.CPUPlace()).run(topo.main_program,
                                           feed=feeder.feed(b),
                                           scope=port.parameters.scope)
        port_io.save_checkpoint(str(tmp_path),
                                main_program=topo.main_program, step=2,
                                scope=port.parameters.scope)
        jt, _ = v1_pair("traffic_prediction")
        assert jt._sgd.restore_checkpoint(str(tmp_path)) == 2
    moments = [n for n in port_io.load_state_tree(str(tmp_path), 2)
               if "moment" in n]
    assert moments, "the checkpoint holds no Adam moments"
    _next_step_matches(jt, port)


# -- the command line ------------------------------------------------------


def _tiny_config(tmp_path):
    """A small fc config and its provider for the job modes."""
    d = tmp_path / "tiny"
    d.mkdir()
    (d / "prov.py").write_text(
        "import numpy as np\n"
        "def process(fname):\n"
        "    r = np.random.RandomState(0)\n"
        "    n = int(fname or 32)\n"
        "    for _ in range(n):\n"
        "        y = int(r.randint(0, 3))\n"
        "        x = np.zeros(6, np.float32); x[y*2:y*2+2] = 1.0\n"
        "        x += 0.1 * r.randn(6).astype(np.float32)\n"
        "        yield {'x': x, 'lab': y}\n")
    (d / "conf.py").write_text(
        "from paddle_tpu_torch.trainer_config_helpers import *\n"
        "define_py_data_sources2(train_list='48', test_list='24',\n"
        "                        module='prov', obj='process')\n"
        "settings(batch_size=16, learning_rate=0.1)\n"
        "x = data_layer(name='x', size=6)\n"
        "lab = data_layer(name='lab', size=3)\n"
        "hid = fc_layer(input=x, size=5, act=TanhActivation())\n"
        "pred = fc_layer(input=hid, size=3, act=SoftmaxActivation())\n"
        "outputs(classification_cost(input=pred, label=lab))\n")
    return d


def _trainer_cli(d, *args):
    env = dict(os.environ, PYTHONPATH=str(d) + os.pathsep + REPO,
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.trainer", "--use_gpu=0",
         *args], capture_output=True, text=True, env=env, timeout=300,
        cwd=REPO)


def test_trainer_job_test_mode(tmp_path):
    """--job=test: load a saved pass, evaluate the test source, print the
    cost."""
    d = _tiny_config(tmp_path)
    save_dir = str(tmp_path / "out")
    out = _trainer_cli(d, f"--config={d / 'conf.py'}", "--num_passes=3",
                       f"--save_dir={save_dir}")
    assert out.returncode == 0, out.stderr[-2000:]
    assert sorted(os.listdir(save_dir)) == [
        "pass-00000", "pass-00001", "pass-00002"]
    out = _trainer_cli(d, "--job=test", f"--config={d / 'conf.py'}",
                       f"--init_model_path={save_dir}")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Test done" in out.stdout
    cost = float(out.stdout.split("cost")[-1].strip())
    assert np.isfinite(cost) and cost < 1.0, out.stdout


def test_trainer_job_checkgrad_mode(tmp_path):
    """--job=checkgrad: central differences of every parameter."""
    d = _tiny_config(tmp_path)
    out = _trainer_cli(d, "--job=checkgrad", f"--config={d / 'conf.py'}")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Gradient check PASSED" in out.stdout
    # every trainable parameter is reported (2 fc weights + 2 biases)
    assert out.stdout.count("checkgrad ") == 4, out.stdout


def test_trainer_checkgrad_catches_wrong_gradient(tmp_path):
    """The checker fails at near-zero tolerances, and leaves no autograd
    state behind."""
    d = _tiny_config(tmp_path)
    sys.path.insert(0, str(d))
    try:
        pt.framework.reset_default_programs()
        t = Trainer(parse_config(str(d / "conf.py")), pt.CPUPlace())
        before = {n: t.parameters.get(n) for n in t.parameters.keys()}
        report = t.check_gradient()
        assert len(report) == 4 and all(v < 0.05 for v in report.values())
        with pytest.raises(AssertionError):
            t.check_gradient(epsilon=1e-3, rtol=1e-6, atol=1e-9)
        for n, w in before.items():   # restored after the failure too
            np.testing.assert_array_equal(t.parameters.get(n), w)
        assert torch.is_grad_enabled()
    finally:
        sys.path.remove(str(d))


def test_show_layer_stat_and_log_period_flags(tmp_path):
    """--show_layer_stat prints the runtime table after every log line,
    every log_period batches (tests/test_observability.py's check of the
    reference's trainer); log_period comes from FLAGS when no argument
    gives it, as in the reference."""
    from paddle_tpu.trainer import trainer as jax_trainer
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import stat
    from paddle_tpu_torch.flags import FLAGS

    assert port_trainer._resolve_log_period(7) == 7
    FLAGS.set("log_period", 13)
    try:
        assert port_trainer._resolve_log_period(None) == 13
    finally:
        FLAGS.set("log_period", 100)
    assert port_trainer._resolve_log_period(None) == \
        jax_trainer._resolve_log_period(None) == 100

    obs.reset()
    exe = pt.Executor(pt.CPUPlace())
    pt.framework.reset_default_programs()
    x = pt.layers.data(name="x", shape=[4])
    pred = pt.layers.fc(x, size=2)
    exe.run(pt.default_startup_program())
    exe.run(feed={"x": np.ones((2, 4), np.float32)}, fetch_list=[pred])
    stats = stat.GLOBAL_STATS
    try:
        with stat.timer("probe_timer"):
            pass
        buf = io.StringIO()
        port_trainer._dump_layer_stat(0, 20, out=buf)
    finally:
        stats.reset()
    out = buf.getvalue()
    assert out.startswith("--- runtime stats (pass 0, batch 20) ---")
    assert "executor_compile_cache_miss_total" in out
    assert "source=plan" in out and "probe_timer" in out

    d = _tiny_config(tmp_path)
    out = _trainer_cli(d, f"--config={d / 'conf.py'}", "--num_passes=2",
                       "--log_period=2", "--show_layer_stat")
    assert out.returncode == 0, out.stderr[-2000:]
    # 48 rows a pass in batches of 16: batches 0 and 2 of each pass log
    heads = [ln for ln in out.stderr.splitlines()
             if ln.startswith("--- runtime stats")]
    assert heads == [f"--- runtime stats (pass {p}, batch {b}) ---"
                     for p in (0, 1) for b in (0, 2)]
    assert out.stdout.count("Pass ") == 4
    assert out.stderr.count("executor_step_seconds") >= 4
    out = _trainer_cli(d, f"--config={d / 'conf.py'}", "--num_passes=1")
    assert out.returncode == 0 and "runtime stats" not in out.stderr


def test_traffic_prediction_trains_from_the_command_line(capsys):
    """The acceptance command on the CPU: the final cost under 0.3 x the
    first (the reference test's gate)."""
    pt.framework.reset_default_programs()
    assert port_trainer.main([f"--config={TRAFFIC}", "--num_passes=4",
                              "--use_gpu=0", "--log_period=1"]) == 0
    out = capsys.readouterr().out
    costs = [float(line.split("Cost ")[1].split(",")[0])
             for line in out.splitlines() if line.startswith("Pass ")]
    assert len(costs) == 64
    assert np.mean(costs[-3:]) < 0.3 * costs[0], (costs[0], costs[-3:])
    assert "Training done: 64 batches" in out


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError):
        port_trainer.main([f"--config={TRAFFIC}"])
    with pytest.raises(RuntimeError):
        Trainer(parse_config(TRAFFIC))


def test_export_inference_model_serves_the_prediction(tmp_path):
    pt.framework.reset_default_programs()
    t = Trainer(parse_config(TRAFFIC), pt.CPUPlace())
    out = t.export_inference_model(str(tmp_path / "m"))
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    prog, feeds, fetches = pt.io.load_inference_model(out, exe, scope=scope)
    assert feeds == ["series"]
    x = np.random.RandomState(0).randn(5, 12).astype(np.float32)
    (y,) = exe.run(prog, feed={"series": x}, fetch_list=fetches, scope=scope)
    assert y.shape == (5, 1) and np.isfinite(y).all()


_PROBE = """
import sys
import paddle_tpu_torch as pt
from paddle_tpu_torch.trainer import trainer
from paddle_tpu_torch.demos.gan import train as gan
assert trainer.main(["--config=%s", "--use_gpu=0", "--num_passes=1"]) == 0
gan.main(steps=2, verbose=False, place=pt.CPUPlace())
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
print("LOADED", bad)
""" % TRAFFIC


def test_the_v1_loop_and_the_demos_never_load_jax_or_paddle_tpu():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout, out.stdout[-2000:]


# -- v1 layers past the demos' paths ---------------------------------------


def test_mixed_layer_full_matrix_projection():
    """mixed(full_matrix_projection) equals a bias-free linear fc."""
    from paddle_tpu_torch.trainer_config_helpers import layers as v1
    from paddle_tpu_torch.v2.parameters import Parameters
    from paddle_tpu_torch.v2.topology import Topology

    holder = {}

    def config():
        x = v1.data_layer(name="x", size=6)
        with v1.mixed_layer(size=4) as m:
            m += v1.full_matrix_projection(input=x)
        holder["out"] = m._lo

    parse_config(config)
    topo = Topology(None, output_layers=[holder["out"]])
    params = Parameters(topo, pt.CPUPlace())
    xs = np.random.RandomState(0).randn(3, 6).astype("float32")
    (out,) = pt.Executor(pt.CPUPlace()).run(
        topo.main_program, feed={"x": xs}, fetch_list=[topo.output_vars[0]],
        scope=params.scope)
    w = params.get(topo.main_program.all_parameters()[0].name)
    np.testing.assert_allclose(out, xs @ w, atol=1e-5)


def _v1_costs(tch):
    """A weighted regression cost, and an average img_pool_layer (ceil
    extents, exclusive averages) over a conv with padding."""

    def config():
        x = tch.data_layer(name="x", size=4)
        y = tch.data_layer(name="y", size=1)
        w = tch.data_layer(name="w", size=1)
        pred = tch.fc_layer(input=x, size=1, act=tch.LinearActivation())
        img = tch.data_layer(name="img", size=2 * 7 * 7)
        conv = tch.img_conv_layer(input=img, filter_size=3, num_filters=3,
                                  num_channels=2, padding=1,
                                  act=tch.ReluActivation())
        pool = tch.img_pool_layer(input=conv, pool_size=2, stride=2,
                                  pool_type=tch.AvgPooling())
        tch.outputs(tch.regression_cost(input=pred, label=y, weight=w), pool)

    return config


def test_weighted_regression_and_image_layers_match_the_jax_package():
    import paddle_tpu.trainer_config_helpers as jax_tch
    import paddle_tpu_torch.trainer_config_helpers as port_tch
    from paddle_tpu.trainer.config_parser import parse_config as jax_parse
    from paddle_tpu.v2.topology import Topology as JaxTopology
    from paddle_tpu_torch.v2.topology import Topology

    fluid.framework.reset_default_programs()
    jconf = jax_parse(_v1_costs(jax_tch))
    pt.framework.reset_default_programs()
    pconf = parse_config(_v1_costs(port_tch))
    jtopo = JaxTopology(None, output_layers=jconf.outputs)
    ptopo = Topology(None, output_layers=pconf.outputs)
    assert ([(o["type"], o["size"]) for o in pconf.model_config.layers]
            == [(o["type"], o["size"]) for o in jconf.model_config.layers])
    rng = np.random.RandomState(2)
    feed = {"x": rng.randn(5, 4).astype(np.float32),
            "y": rng.randn(5, 1).astype(np.float32),
            "w": rng.rand(5, 1).astype(np.float32),
            "img": rng.randn(5, 98).astype(np.float32)}
    jscope = fluid.executor.Scope()
    with jax_scope_guard(jscope):
        JaxExecutor(JaxCPUPlace()).run(jtopo.startup_program)
        want = JaxExecutor(JaxCPUPlace()).run(
            jtopo.main_program, feed=feed, fetch_list=jtopo.output_vars)
    pscope = pt.Scope()
    pscope.load_numpy({p.name: np.asarray(jscope.get(p.name))
                       for p in jtopo.main_program.all_parameters()}, "cpu")
    got = pt.Executor(pt.CPUPlace()).run(
        ptopo.main_program, feed=feed, fetch_list=ptopo.output_vars,
        scope=pscope)
    # the pool's extent: ceil((7 - 2) / 2) + 1 = 4, its last window half
    # outside the image (exclusive: averaged over the cell inside)
    assert got[1].shape == (5, 3, 4, 4)
    for g, w in zip(got, want):
        close(g, np.asarray(w), 1e-5, "v1 layer output")
