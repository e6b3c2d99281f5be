"""The port's ``api.py`` (the SWIG surface: buffers, ``GradientMachine``,
``ParameterOptimizer``), ``DataFeeder`` and ``v2.reader`` /
``v2.minibatch`` against the JAX package on the CPU.

Tolerances: ``GradientMachine`` costs and gradients within 1e-5 of the
JAX value's largest magnitude; ``ParameterOptimizer`` weights after 20
steps of each rule within rtol 1e-6 of the reference's native C++
optimizer (an element's error floored at 1e-6 of the largest weight);
the LoD classifier's two Momentum steps from ``DataFeeder`` feeds within
1e-5 of max; feeds, offsets and buffers exactly.
"""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import api as japi
from paddle_tpu_torch import api
from test_torch_control_flow import close, compare
from test_torch_demos import one_torch_thread  # noqa: F401

TOL = 1e-5


# ---------------------------------------------------------------------------
# the buffer types and initPaddle
# ---------------------------------------------------------------------------


def test_buffers_write_through_as_the_reference():
    """Matrix / Vector / IVector / Arguments: the reference's numpy
    buffers (tests/test_api_utils.py), in-place views writing through."""
    for mod in (japi, api):
        m = mod.Matrix.createDense(list(range(6)), 2, 3)
        view = m.toNumpyMatInplace()
        view[1, 1] = -1.0
        assert m.get(1, 1) == -1.0
        cp = m.copyToNumpyMat()
        cp[0, 0] = 99.0
        assert m.get(0, 0) == 0.0
        with pytest.raises(mod.RangeError):
            m.get(5, 0)
        sp = mod.Matrix.createSparse(2, 5, 3, isNonVal=False)
        sp.sparseCopyFrom([0, 2, 3], [1, 4, 0], [0.5, 0.25, -1.0])
        assert sp.getSparseRowColsVal(1) == [(0, -1.0)]
        v = mod.Vector.create([1.0, 2.0, 3.0])
        v.toNumpyArrayInplace()[0] = 4.0
        assert v.getData() == [4.0, 2.0, 3.0]
        iv = mod.IVector.create([3, 1, 2])
        assert iv.toNumpyArrayInplace().dtype == np.int32
        a = mod.Arguments.createArguments(2)
        a.setSlotIds(0, [1, 2])
        a.setSlotSequenceStartPositions(0, [0, 2])
        assert a.getSlotIds(0).dtype == np.int64
        assert a.getSlotSequenceStartPositions(0).dtype == np.int32


def test_init_paddle_records_flags_only():
    from paddle_tpu_torch.flags import FLAGS

    before = FLAGS.get("log_period")
    try:
        api.initPaddle("--use_gpu=false", "--log_period=7", "bare")
        assert FLAGS.get("log_period") == 7
    finally:
        FLAGS.set("log_period", before)


# ---------------------------------------------------------------------------
# GradientMachine
# ---------------------------------------------------------------------------


def _conf(fl, hidden=6, classes=3, dim=5):
    """A v1 config in package ``fl``: x -> fc(tanh) -> fc(softmax) ->
    classification_cost against integer labels."""
    import importlib

    v1 = importlib.import_module(f"{fl.__name__}.trainer_config_helpers")
    cp = importlib.import_module(f"{fl.__name__}.trainer.config_parser")
    dt = importlib.import_module(f"{fl.__name__}.v2.data_type")

    def config():
        x = v1.data_layer(name="x", size=dim)
        lab = v1.data_layer(name="lab", size=classes)
        hid = v1.fc_layer(input=x, size=hidden, act=v1.TanhActivation())
        pred = v1.fc_layer(input=hid, size=classes,
                           act=v1.SoftmaxActivation())
        v1.outputs(v1.classification_cost(input=pred, label=lab))

    fl.framework.reset_default_programs()
    conf = cp.parse_config(config)
    conf.data_layers["lab"].input_type = dt.integer_value(classes)
    return conf


def _args(mod, x, lab):
    a = mod.Arguments.createArguments(2)
    a.setSlotValue(0, x)
    a.setSlotIds(1, lab)
    return a


def test_gradient_machine_against_the_jax_package(rng):
    """forwardBackward's cost and gradients at 1e-5, and forward on the
    test clone, from the JAX machine's weights; each parameter through
    the swig Parameter wrapper."""
    jgm = japi.GradientMachine.createFromConfigProto(_conf(fluid))
    gm = api.GradientMachine.createFromConfigProto(_conf(pt),
                                                   place=pt.CPUPlace())
    names = gm.getParameters().keys()
    assert names == jgm.getParameters().keys()
    for n in names:
        gm.getParameters().set(n, np.asarray(jgm.getParameters().get(n)))
    x = rng.randn(8, 5).astype(np.float32)
    lab = rng.randint(0, 3, (8, 1)).astype(np.int64)
    jout, out = japi.Arguments(0), api.Arguments(0)
    want = jgm.forwardBackward(_args(japi, x, lab), jout)
    got = gm.forwardBackward(_args(api, x, lab), out)
    compare("cost", got, np.asarray(want), TOL)
    assert set(gm._last_grads) == set(names)
    for n in names:
        close(gm._last_grads[n], jgm._last_grads[n], TOL, n)
    jf = jgm.forward(_args(japi, x, lab), japi.Arguments(0))
    f = gm.forward(_args(api, x, lab), api.Arguments(0))
    for g, w in zip(f, jf):
        close(np.asarray(g), np.asarray(w), TOL, "forward")
    p, jp = gm.getParameter(0), jgm.getParameter(0)
    assert (p.getName(), p.getSize()) == (jp.getName(), jp.getSize())
    assert p.getConfig().toProtoString() == jp.getConfig().toProtoString()
    buf = p.getBuf()
    np.testing.assert_array_equal(buf.copyToNumpyArray(),
                                  jp.getBuf().copyToNumpyArray())
    buf.toNumpyArrayInplace()[:] = 0.5
    p.setBuf(buf)
    assert (gm.getParameters().get(p.getName()) == 0.5).all()
    with pytest.raises(api.RangeError):
        gm.getParameter(99)


def test_entry_points_take_the_card_by_default():
    """Without a place, GradientMachine, ParameterOptimizer and
    SequenceGenerator take CUDAPlace(0) (never FLAGS.use_gpu), and raise
    where no card is found; SequenceGenerator runs on CPUPlace() when
    asked (its beams are held to the JAX package's in
    tests/test_torch_generation.py)."""
    from paddle_tpu_torch.demos.seq2seq.gen_config import make_beam_gen
    from paddle_tpu_torch.executor import Scope

    class Params:
        scope = Scope()

    pt.framework.reset_default_programs()
    gen = api.SequenceGenerator(make_beam_gen(beam_size=2, max_length=4),
                                Params, place=pt.CPUPlace())
    beams = gen.generate([[4, 7, 2]])
    assert 1 <= len(beams) <= 2
    assert all(len(ids) <= 4 and all(0 <= t < 16 for t in ids)
               for _, ids in beams)
    assert [s for s, _ in beams] == sorted((s for s, _ in beams),
                                           reverse=True)
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal without a CUDA device")
    with pytest.raises(RuntimeError, match="CPUPlace"):
        api.GradientMachine.createFromConfigProto(_conf(pt))
    with pytest.raises(RuntimeError, match="CPUPlace"):
        api.ParameterOptimizer.create("type=sgd lr=0.1")
    with pytest.raises(RuntimeError, match="CPUPlace"):
        api.SequenceGenerator(make_beam_gen(), Params)


# ---------------------------------------------------------------------------
# ParameterOptimizer against the native C++ optimizer
# ---------------------------------------------------------------------------

RULES = {
    "sgd": "type=sgd lr=0.1",
    "sgd_momentum": "type=sgd lr=0.05 momentum=0.9",
    "sgd_nesterov_decay": "type=sgd lr=0.05 momentum=0.9 nesterov=1 "
                          "decay=0.01",
    "adagrad": "type=adagrad lr=0.1 epsilon=1e-6",
    "decayed_adagrad": "type=decayed_adagrad lr=0.1 rho=0.9",
    "adadelta": "type=adadelta lr=1.0 rho=0.95 epsilon=1e-6",
    "rmsprop": "type=rmsprop lr=0.01 rho=0.9",
    "adam": "type=adam lr=0.01 beta1=0.9 beta2=0.999 epsilon=1e-8",
    "adam_linear_decay": "type=adam lr=0.01 decay=0.001 lr_policy=linear "
                         "lr_decay_a=0.0004 lr_decay_b=0.002",
    "adamax": "type=adamax lr=0.02 beta1=0.9 beta2=0.999",
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_parameter_optimizer_against_the_native_one(rng, rule):
    cfg = api.OptimizationConfig.createFromProtoString(RULES[rule].encode())
    w0 = rng.randn(64).astype(np.float32)
    opt = api.ParameterOptimizer.create(cfg, place=pt.CPUPlace())
    ref = japi.ParameterOptimizer.create(
        japi.OptimizationConfig(RULES[rule]))
    opt.init(api.Vector.create(w0))
    ref.init(w0)
    for _ in range(20):
        g = rng.randn(64).astype(np.float32)
        opt.update(api.Vector.create(g))
        ref.update(g)
    want = ref.getWeights().copyToNumpyArray()
    got = opt.getWeights().copyToNumpyArray()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    assert np.abs(got - w0).max() > 1e-3     # it moved


def test_parameter_optimizer_refuses_an_unknown_rule():
    for mod, kw in ((japi, {}), (api, {"place": pt.CPUPlace()})):
        with pytest.raises(mod.UnsupportError):
            mod.ParameterOptimizer.create("type=bogus lr=1", **kw).init(
                np.zeros(3, np.float32))
    with pytest.raises(api.UnsupportError, match="init"):
        api.ParameterOptimizer.create("type=sgd", place=pt.CPUPlace()).update(
            np.zeros(3, np.float32))


# ---------------------------------------------------------------------------
# DataFeeder
# ---------------------------------------------------------------------------


def _lod_classifier(fl, vocab=40, emb=6, hidden=5):
    """The LoD bag-of-words classifier (chip_smoke.build_lod_program) at
    small widths, in package ``fl``: (ids, label, loss)."""
    fl.framework.reset_default_programs()
    ids = fl.layers.data(name="ids", shape=[1], dtype="int64", lod_level=1)
    label = fl.layers.data(name="label", shape=[1], dtype="int64")
    e = fl.layers.embedding(input=ids, size=[vocab, emb])
    h = fl.layers.fc(input=e, size=hidden, act="tanh")
    pooled = fl.layers.sequence_pool(h, "average")
    pred = fl.layers.fc(input=pooled, size=2, act="softmax")
    loss = fl.layers.mean(fl.layers.cross_entropy(input=pred, label=label))
    fl.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    return ids, label, loss


def _rows(rng, n=5, vocab=40):
    return [(rng.randint(0, vocab, (rng.randint(1, 7),)).tolist(),
             int(rng.randint(0, 2))) for _ in range(n)]


def test_data_feeder_feeds_as_the_jax_package(rng):
    """Dense, scalar and LoD columns: the same arrays and offsets, the
    LoD rows padded with zeros to a multiple of lod_bucket past the last
    offset."""
    rows = [(rng.randn(3).astype(np.float32), int(rng.randint(0, 4)),
             rng.randint(0, 9, (rng.randint(1, 5),)).tolist())
            for _ in range(4)]
    feeds = []
    for fl in (fluid, pt):
        fl.framework.reset_default_programs()
        vs = [fl.layers.data(name="x", shape=[3]),
              fl.layers.data(name="y", shape=[1], dtype="int64"),
              fl.layers.data(name="ids", shape=[1], dtype="int64",
                             lod_level=1)]
        feeds.append(fl.DataFeeder(vs, lod_bucket=8).feed(rows))
    want, got = feeds
    for n in ("x", "y"):
        assert got[n].dtype == np.asarray(want[n]).dtype
        np.testing.assert_array_equal(got[n], want[n])
    assert got["ids"].data.shape[0] % 8 == 0
    np.testing.assert_array_equal(got["ids"].data, want["ids"].data)
    np.testing.assert_array_equal(got["ids"].lod[0], want["ids"].lod[0])
    assert got["ids"].data[got["ids"].lod[0][-1]:].sum() == 0


def test_lod_classifier_steps_from_data_feeder_feeds(rng):
    """Two Momentum steps of the LoD classifier from DataFeeder feeds
    (128-row buckets) against the JAX package's, and on the port the
    same steps from unpadded feeds: the ops ignore rows past the last
    offset."""
    batches = [_rows(rng), _rows(rng)]
    built = {}
    for fl in (fluid, pt):
        ids, label, loss = _lod_classifier(fl)
        built[fl] = (fl.DataFeeder([ids, label]), loss)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    state = {n: np.asarray(v) for n, v in fluid.global_scope().values.items()}
    params = sorted(p.name for p in
                    fluid.default_main_program().all_parameters())
    want = [exe.run(fluid.default_main_program(),
                    feed=built[fluid][0].feed(b), fetch_list=[loss.name])[0]
            for b in batches]
    want_params = [np.asarray(fluid.global_scope().get(n)) for n in params]
    runs = []
    for bucket in (128, 1):
        scope = pt.Scope()
        scope.load_numpy(state, "cpu")
        feeder = pt.DataFeeder(built[pt][0].feed_list, lod_bucket=bucket)
        port = pt.Executor(pt.CPUPlace())
        costs = [port.run(pt.default_main_program(), feed=feeder.feed(b),
                          fetch_list=[loss.name], scope=scope)[0]
                 for b in batches]
        runs.append((costs, [scope.get(n).numpy() for n in params]))
    for costs, ps in runs:
        for g, w in zip(costs, want):
            compare("loss", g, w, TOL)
        for n, g, w in zip(params, ps, want_params):
            close(g, w, TOL, n)


# ---------------------------------------------------------------------------
# v2.reader and v2.minibatch
# ---------------------------------------------------------------------------


def test_readers_and_batch_as_the_jax_package():
    import paddle_tpu.v2 as jv2
    import paddle_tpu_torch.v2 as pv2

    def make(v2):
        base = v2.reader.creator.np_array(np.arange(10))
        doubled = v2.reader.map_readers(lambda a: int(a) * 2, base)
        both = v2.reader.compose(doubled, v2.reader.firstn(base, 10))
        chained = v2.reader.chain(both, v2.reader.cache(both))
        mapped = v2.reader.xmap_readers(lambda s: s[0] + s[1], chained,
                                        3, 4, order=True)
        return [list(b) for b in v2.batch(v2.reader.buffered(mapped, 2), 3,
                                          drop_last=False)()]

    assert make(pv2) == make(jv2)
    with pytest.raises(pv2.reader.ComposeNotAligned):
        list(pv2.reader.compose(pv2.reader.creator.np_array(range(3)),
                                pv2.reader.creator.np_array(range(2)))())
    with pytest.raises(NotImplementedError, match="step 6"):
        pv2.reader.creator.recordio("x.recordio")


def _lod_case(kind):
    """(build(x) -> outputs, per-row output?) for LoD op ``kind`` over a
    LoD float input x of width 4."""
    L = pt.layers
    if kind.startswith("pool_"):
        return lambda x: [L.sequence_pool(x, kind[5:])], False
    if kind == "softmax":
        return lambda x: [L.sequence_softmax(L.fc(input=x, size=1))], True
    if kind == "conv":
        return lambda x: [L.sequence_conv(x, num_filters=3,
                                          filter_size=3)], True
    if kind == "lstm":
        # the gate projection is 4 x the hidden width
        return lambda x: list(L.dynamic_lstm(L.fc(input=x, size=32),
                                             size=8)), True
    raise ValueError(kind)


LOD_KINDS = ["pool_average", "pool_sum", "pool_sqrt", "pool_max",
             "pool_first", "pool_last", "softmax", "conv", "lstm"]


@pytest.mark.parametrize("kind", LOD_KINDS)
def test_lod_ops_ignore_rows_past_the_last_offset(rng, kind):
    """What DataFeeder's bucket padding relies on: each LoD op's outputs
    for the sequences (and for the rows up to the last offset) are the
    same whatever rows lie past the last offset."""
    build, per_row = _lod_case(kind)
    pt.framework.reset_default_programs()
    x = pt.layers.data(name="x", shape=[4], lod_level=1)
    outs = build(x)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    off = [0, 3, 8, 9, 11]
    rows = rng.randn(off[-1], 4).astype(np.float32)
    junk = 1e3 * rng.randn(128 - off[-1], 4).astype(np.float32)
    runs = [exe.run(pt.default_main_program(), feed={"x": (data, [off])},
                    fetch_list=outs, scope=scope)
            for data in (rows, np.concatenate([rows, junk]))]
    for got, want in zip(*runs):
        got = np.asarray(getattr(got, "data", got))
        want = np.asarray(getattr(want, "data", want))
        if per_row:
            got, want = got[:off[-1]], want[:off[-1]]
        np.testing.assert_array_equal(got, want, err_msg=kind)
