"""The port's whole-program optimizer and donation analysis
(``paddle_tpu_torch/analysis/optimize.py``) against the JAX package's
(``paddle_tpu/analysis/optimize.py``): for the programs of
tests/test_optimizer.py, built in the JAX package and handed to the port
through ``to_dict``, JSON and ``Program.from_dict``, ``optimize_program``
must give the same rewritten ``to_dict`` and the same ``OptReport``
counts, the port's fetches before and after the rewrite must be bit for
bit the same (``check_parity`` on ``CPUPlace()``), and ``donation_mask``
the same entries.  Plus the Executor's ``optimize_program`` flag and
report, ``ModelBundle(optimize=True)`` and ``Program.prune``."""

import json

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import executor as jexecutor
from paddle_tpu.analysis import optimize as joptimize
from paddle_tpu_torch import analysis
from paddle_tpu_torch.analysis import dataflow, optimize

B, D = 4, 8
CPU = pt.CPUPlace()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh():
    fluid.framework.reset_default_programs()
    pt.framework.reset_default_programs()
    yield


def _dict(prog):
    """``to_dict`` through JSON, block refs as ``{"__block__": idx}``."""
    def block_ref(o):
        if hasattr(o, "idx") and hasattr(o, "ops"):
            return {"__block__": o.idx}
        raise TypeError(f"{type(o).__name__} is not JSON serializable")

    return json.loads(json.dumps(prog.to_dict(), default=block_ref))


def _port(jprog):
    return pt.Program.from_dict(_dict(jprog))


_COUNTS = ("ops_before", "ops_after", "rounds", "folds", "cse_hits",
           "dce_ops_removed", "dce_vars_removed", "optimized")


def _optimize_both(jprog, feeds, fetches):
    """Both pipelines on the same program: the rewritten programs and the
    report counts must be equal; returns the port's (program, report)."""
    pprog = _port(jprog)
    jopt, jrep = joptimize.optimize_program(jprog, feed_names=set(feeds),
                                            fetch_names=fetches)
    popt, prep = optimize.optimize_program(pprog, feed_names=set(feeds),
                                           fetch_names=fetches)
    assert _dict(popt) == _dict(jopt)
    for k in _COUNTS:
        assert getattr(prep, k) == getattr(jrep, k), k
    assert [d.code for d in prep.diagnostics] == \
        [d.code for d in jrep.diagnostics]
    return pprog, popt, prep


def _startup_state(program):
    """The JAX startup program's persistables, numpy."""
    exe = fluid.Executor(fluid.CPUPlace())
    scope = jexecutor.Scope()
    exe.run(fluid.default_startup_program(), scope=scope)
    return {name: np.asarray(scope.get(name))
            for name, var in program.global_block().vars.items()
            if var.persistable and name in scope}


_UNARY = [
    ("relu", lambda L, x: L.relu(x)),
    ("tanh", lambda L, x: L.tanh(x)),
    ("sigmoid", lambda L, x: L.sigmoid(x)),
    ("scale", lambda L, x: L.scale(x, scale=0.5, bias=0.1)),
    ("fc_relu", lambda L, x: L.fc(input=x, size=D, act="relu")),
    ("fc_lin", lambda L, x: L.fc(input=x, size=D)),
    ("softmax", lambda L, x: L.softmax(x)),
    ("abs", lambda L, x: L.abs(x)),
    ("square", lambda L, x: L.square(x)),
]
_BINARY = [
    ("add", lambda L, a, b: L.elementwise_add(x=a, y=b)),
    ("mul", lambda L, a, b: L.elementwise_mul(x=a, y=b)),
    ("sub", lambda L, a, b: L.elementwise_sub(x=a, y=b)),
]


def _build_chain(rng):
    L = fluid.layers
    x = L.data(name="x", shape=[D], dtype="float32")
    names, frontier = [], [x]
    for _ in range(rng.randint(3, 7)):
        if len(frontier) >= 2 and rng.rand() < 0.3:
            i, j = rng.choice(len(frontier), 2, replace=False)
            nm, op = _BINARY[rng.randint(len(_BINARY))]
            out = op(L, frontier[i], frontier[j])
        else:
            nm, op = _UNARY[rng.randint(len(_UNARY))]
            out = op(L, frontier[rng.randint(len(frontier))])
        names.append(nm)
        frontier.append(out)
    return names, frontier[-1]


@pytest.mark.parametrize("seed", range(10))
def test_fuzzed_chain_optimizes_like_the_reference(seed):
    """Random layer chains (training on odd seeds): the same rewrite as
    the JAX pipeline, fetches bit for bit across it in the port, and a
    rewritten program the port's verifier accepts."""
    rng = np.random.RandomState(7000 + seed)
    names, out = _build_chain(rng)
    feed = {"x": rng.randn(B, D).astype("float32") * 0.5}
    fetches = [out.name]
    if seed % 2:
        label = fluid.layers.data(name="y", shape=[D], dtype="float32")
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=out, label=label))
        fluid.optimizer.SGD(learning_rate=1e-3).minimize(loss)
        feed["y"] = rng.randn(B, D).astype("float32") * 0.5
        fetches = [loss.name]
    jprog = fluid.default_main_program()
    state = _startup_state(jprog)
    pprog, popt, report = _optimize_both(jprog, feed, fetches)
    assert report.optimized, names
    optimize.check_parity(pprog, feed, fetches, state=state, place=CPU)
    diags = analysis.verify_program(popt, feed_names=set(feed),
                                    fetch_names=fetches, level="error")
    assert not diags, analysis.format_report(diags)


def _while_acc(L, x, w=None, n_steps=3.0):
    i = L.fill_constant(shape=(1,), dtype="float32", value=0.0)
    n = L.fill_constant(shape=(1,), dtype="float32", value=n_steps)
    acc = L.fill_constant(shape=(4,), dtype="float32", value=0.0)
    cond = L.less_than(i, n)
    loop = L.While(cond)
    with loop.block():
        s = L.scale(x, scale=2.0) if w is None else w
        L.assign(L.elementwise_add(x=acc, y=s), output=acc)
        L.increment(i, value=1.0, in_place=True)
        L.assign(L.less_than(i, n), output=cond)
    return acc


def test_cse_merges_top_level_but_never_across_blocks():
    L = fluid.layers
    x = L.data(name="x", shape=[4], dtype="float32", append_batch_size=False)
    a = L.scale(x, scale=2.0)
    b = L.scale(x, scale=2.0)  # duplicate of a
    out_top = L.elementwise_add(x=a, y=b)
    acc = _while_acc(L, x)
    feed = {"x": np.arange(4, dtype="float32")}
    fetches = [out_top.name, acc.name]
    pprog, popt, report = _optimize_both(fluid.default_main_program(),
                                         feed, fetches)
    assert report.cse_hits >= 1, report.format()
    sub_scales = [sub_op for op in popt.global_block().ops
                  for _, sub in dataflow.op_sub_blocks(op)
                  for _b, _i, sub_op in dataflow.walk_ops(sub)
                  if sub_op.type == "scale"]
    assert sub_scales, "sub-block scale was merged across blocks"
    optimize.check_parity(pprog, feed, fetches, place=CPU)


def test_constant_fold_preserves_dtype():
    """int32 + int32 folds to an int32 fill, the cast to float16 to a
    float16 fill, evaluated through the port's registry on CPU tensors:
    the same fills as the JAX package's jnp evaluation."""
    L = fluid.layers
    c1 = L.fill_constant(shape=(2, 2), dtype="int32", value=3)
    c2 = L.fill_constant(shape=(2, 2), dtype="int32", value=4)
    s = L.elementwise_add(x=c1, y=c2)
    f = L.cast(s, "float16")
    pprog, popt, report = _optimize_both(fluid.default_main_program(), {},
                                         [s.name, f.name])
    assert report.folds >= 2, report.format()
    by_out = {n: op for op in popt.global_block().ops
              for n in op.output_arg_names}
    assert by_out[s.name].type == "fill"
    assert by_out[s.name].attr("dtype") == "int32"
    assert np.asarray(by_out[s.name].attr("data")).dtype == np.int32
    assert (np.asarray(by_out[s.name].attr("data")) == 7).all()
    assert by_out[f.name].attr("dtype") == "float16"
    optimize.check_parity(pprog, {}, [s.name, f.name], place=CPU)


def test_dce_keeps_unfetched_random_ops():
    L = fluid.layers
    x = L.data(name="x", shape=[D], dtype="float32")
    L.dropout(L.scale(x, scale=1.5), dropout_prob=0.3)
    y = L.scale(x, scale=2.0)
    _, popt, _ = _optimize_both(fluid.default_main_program(), {"x": None},
                                [y.name])
    assert any(op.type == "dropout" for op in popt.global_block().ops)


# ---------------------------------------------------------------------------
# donation
# ---------------------------------------------------------------------------


def _same_mask(jprog, feeds, fetches):
    jmask = joptimize.donation_mask(jprog, feeds, fetches)
    pmask = optimize.donation_mask(_port(jprog), feeds, fetches)
    assert {n: e.to_dict() for n, e in pmask.items()} == \
        {n: e.to_dict() for n, e in jmask.items()}
    return pmask


def test_donation_rejects_read_after_last_write():
    L = fluid.layers
    x = L.data(name="x", shape=[4], dtype="float32", append_batch_size=False)
    w = L.create_global_var(shape=(4,), value=1.0, dtype="float32",
                            persistable=True, name="w_state")
    v = L.create_global_var(shape=(4,), value=2.0, dtype="float32",
                            persistable=True, name="v_state")
    t = L.elementwise_add(x=w, y=x)
    L.assign(t, output=w)
    z = L.elementwise_add(x=w, y=x)        # read AFTER the last write
    L.assign(L.elementwise_mul(x=v, y=x), output=v)
    mask = _same_mask(fluid.default_main_program(), {"x"}, [z.name])
    assert not mask["w_state"].eligible
    assert mask["w_state"].reason.startswith("read after last write")
    assert mask["v_state"].eligible, mask["v_state"].reason


def test_donation_rejects_sub_block_alias_and_read_only():
    """A While program: state read inside the loop is never donated."""
    L = fluid.layers
    x = L.data(name="x", shape=[4], dtype="float32", append_batch_size=False)
    w = L.create_global_var(shape=(4,), value=1.0, dtype="float32",
                            persistable=True, name="w_loop")
    r = L.create_global_var(shape=(4,), value=3.0, dtype="float32",
                            persistable=True, name="r_only")
    L.assign(L.elementwise_add(x=w, y=x), output=w)
    ro = L.elementwise_mul(x=r, y=x)
    acc = _while_acc(L, x, w=w, n_steps=2.0)
    mask = _same_mask(fluid.default_main_program(), {"x"},
                      [acc.name, ro.name])
    assert mask["w_loop"].reason == "aliased into a sub-block"
    assert not mask["r_only"].eligible
    assert "read-only" in mask["r_only"].reason


def test_donation_mask_of_the_adam_transformer():
    """The small recompute Adam transformer: the same entries, every
    parameter and both Adam moments of each eligible."""
    from paddle_tpu.models import transformer as jtf

    tokens = fluid.layers.data(name="tokens", shape=[16, 1], dtype="int64")
    labels = fluid.layers.data(name="labels", shape=[16, 1], dtype="int64")
    loss = jtf.transformer_lm_loss(tokens, labels, vocab_size=128,
                                   d_model=64, num_heads=4, num_layers=2,
                                   recompute=True)
    fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    jprog = fluid.default_main_program()
    mask = _same_mask(jprog, {"tokens", "labels"}, [loss.name])
    params = [p.name for p in jprog.global_block().all_parameters()]
    assert params and all(mask[p].eligible for p in params)
    moments = [n for n in mask if "moment" in n]
    assert len(moments) == 2 * len(params)
    assert all(mask[n].eligible for n in moments)


# ---------------------------------------------------------------------------
# the wiring: Executor, ModelBundle, prune
# ---------------------------------------------------------------------------


def _momentum_program():
    L = pt.layers
    x = L.data(name="x", shape=[D], dtype="float32")
    label = L.data(name="y", shape=[1], dtype="float32")
    h = L.fc(input=x, size=D, act="relu")
    pred = L.fc(input=h, size=1)
    loss = L.mean(L.square_error_cost(input=pred, label=label))
    pt.optimizer.Momentum(learning_rate=1e-2, momentum=0.9).minimize(loss)
    return loss


def test_executor_optimize_flag_matches_plain_run():
    loss = _momentum_program()
    program = pt.default_main_program()
    start = pt.Scope()
    pt.Executor(CPU).run(pt.default_startup_program(), scope=start)
    state = {n: v.clone() for n, v in start.values.items()}
    rng = np.random.RandomState(11)
    feed = {"x": rng.randn(B, D).astype("float32"),
            "y": rng.randn(B, 1).astype("float32")}

    def train(flag):
        scope = pt.Scope()
        scope.values.update({n: v.clone() for n, v in state.items()})
        exe = pt.Executor(CPU)
        return [exe.run(program, feed=feed, fetch_list=[loss], scope=scope,
                        optimize_program=flag)[0] for _ in range(4)]

    for a, b in zip(train(False), train(True)):
        np.testing.assert_array_equal(a, b)


def test_executor_exposes_optimize_report():
    L = pt.layers
    x = L.data(name="x", shape=[D], dtype="float32")
    y = L.scale(L.scale(x, scale=2.0), scale=3.0)
    L.scale(x, scale=9.0)  # dead: no fetch depends on it
    program = pt.default_main_program()
    exe = pt.Executor(CPU)
    feed = {"x": np.ones((B, D), np.float32)}
    assert exe.optimize_report(program, feed, (y.name,)) is None
    exe.run(program, feed=feed, fetch_list=[y], optimize_program=True,
            scope=pt.Scope())
    report = exe.optimize_report(program, feed, (y.name,))
    assert report is not None and report.optimized
    assert report.dce_ops_removed >= 1
    # the plan cache is keyed on the rewritten program
    (key,) = exe._cache
    assert key[0] != program.cache_key()


def test_model_bundle_serves_optimized_program(tmp_path):
    from paddle_tpu_torch.serving.replica import ModelBundle, Replica

    x = pt.layers.data(name="x", shape=[4], dtype="float32")
    pred = pt.layers.fc(input=x, size=3, act="softmax")
    exe = pt.Executor(CPU)
    scope = pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    d = str(tmp_path / "model")
    pt.io.save_inference_model(d, ["x"], [pred], exe, scope=scope)
    feeds = {"x": np.random.RandomState(3).randn(5, 4).astype("float32")}
    raw = Replica(ModelBundle(d, optimize=False), 0, place=CPU).run(feeds)
    bundle = ModelBundle(d, optimize=True)
    opt = Replica(bundle, 0, place=CPU).run(feeds)
    assert bundle.opt_report is not None and bundle.opt_report.optimized
    for a, b in zip(raw, opt):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mnist_demo_config_optimizes_with_bit_parity():
    """The port's v1 MNIST demo through the differential harness."""
    from paddle_tpu_torch.trainer.config_parser import parse_config
    from paddle_tpu_torch.v2.topology import Topology

    conf = parse_config("paddle_tpu_torch/demos/mnist_v1/trainer_config.py",
                        "")
    topo = Topology(conf.cost, extra_layers=conf.evaluators)
    program = topo.main_program
    fetches = [v.name for v in topo.output_vars]
    exe = pt.Executor(CPU)
    scope = pt.Scope()
    exe.run(topo.startup_program, scope=scope)
    state = {n: scope.get(n).numpy()
             for n, v in program.global_block().vars.items()
             if v.persistable and scope.get(n) is not None}
    rng = np.random.RandomState(0)
    feed = {"pixel": rng.rand(8, 784).astype("float32"),
            "label": rng.randint(0, 10, size=(8, 1)).astype("int64")}
    report = optimize.check_parity(program, feed, fetches, state=state,
                                   place=CPU)
    assert report.optimized


def test_backward_slice_subsumes_prune():
    """Program.prune delegates to the optimizer's backward slice, and
    keeps what the JAX package's prune keeps."""
    L = fluid.layers
    x = L.data(name="x", shape=[D], dtype="float32")
    label = L.data(name="y", shape=[D], dtype="float32")
    out = L.fc(input=x, size=D, act="relu")
    loss = L.mean(L.square_error_cost(input=out, label=label))
    fluid.optimizer.SGD(learning_rate=1e-3).minimize(loss)
    jprog = fluid.default_main_program()
    sliced = _port(jprog).prune([out.name])
    assert _dict(sliced) == _dict(jprog.prune([out]))
    types = [op.type for op in sliced.global_block().ops]
    assert "sgd" not in types and "mul" in types
    diags = analysis.verify_program(sliced, feed_names={"x"},
                                    fetch_names=[out.name], level="error")
    assert not diags, analysis.format_report(diags)
