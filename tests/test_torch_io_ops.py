"""The io ops of the port (paddle_tpu_torch/ops/io_ops.py: feed, fetch,
save, load, print, grad_printer, seq_text_printer, cond), its
``io.serialize_tensor_bytes`` / ``deserialize_tensor_bytes`` and the v1
evaluators that emit them (trainer_config_helpers/evaluators.py),
against the JAX package on the CPU.

Each program is built with the JAX package's layers, passed through
``to_dict``, JSON and the port's ``Program.from_dict``, and run by both
Executors from the same state and feeds.  Tolerances: fetched values
within 1e-5 of the JAX value's largest magnitude, integers and file
bytes exactly; the printers' text equal where they print fed values,
and their numbers within 1e-5 of max where they print computed ones
(the two packages' products may differ in the last place, which an
8-digit print can show).
"""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu.executor as jexecutor
import paddle_tpu_torch as pt
import paddle_tpu_torch.executor as pexecutor
from paddle_tpu import io as jio
from paddle_tpu.layer_helper import LayerHelper
from paddle_tpu.registry import LowerContext as JaxLowerContext
from paddle_tpu.registry import OpRegistry as JaxRegistry
from paddle_tpu_torch import io as pio
from paddle_tpu_torch.registry import LowerContext, OpRegistry
from test_torch_control_flow import compare, data, run_op
from test_torch_demos import one_torch_thread  # noqa: F401
from test_torch_gru import jax_dict

TOL = 1e-5


def f32(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def programs(build):
    """``build()`` under fresh JAX programs -> (JAX main, JAX startup,
    the port's main from the same dict, build()'s result)."""
    fluid.framework.reset_default_programs()
    pt.framework.reset_default_programs()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        out = build()
    return main, startup, pt.Program.from_dict(jax_dict(main)), out


def run_twice(build, feeds, fetch, capfd=None, runs=1):
    """The JAX Executor's fetches, then the port's, each ``runs`` times
    in a scope of its own; with ``capfd`` also each side's printed text."""
    main, startup, port_main, _ = programs(build)
    exe = fluid.Executor(fluid.CPUPlace())
    jscope = jexecutor.Scope()
    with jexecutor.scope_guard(jscope):
        exe.run(startup)
        state = {n: np.asarray(v) for n, v in jscope.values.items()}
        want = [exe.run(main, feed=feeds, fetch_list=fetch)
                for _ in range(runs)]
    jtext = capfd.readouterr().out if capfd else None
    scope = pt.Scope()
    scope.load_numpy(state, "cpu")
    port = pt.Executor(pt.CPUPlace())
    with pexecutor.scope_guard(scope):
        got = [port.run(port_main, feed=feeds, fetch_list=fetch, scope=scope)
               for _ in range(runs)]
    ptext = capfd.readouterr().out if capfd else None
    return got, want, ptext, jtext


def append(type, inputs, outputs, attrs=None):
    """One op; outputs {slot: (dtype, shape)} -> their Variables."""
    helper = LayerHelper(type)
    outs = {slot: helper.create_tmp_variable(dt, shape)
            for slot, (dt, shape) in outputs.items()}
    helper.append_op(type=type, inputs=inputs,
                     outputs={k: [v] for k, v in outs.items()},
                     attrs=attrs or {})
    return list(outs.values())


# ---------------------------------------------------------------------------
# the tensor file format
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "int64", "bfloat16"])
def test_tensor_bytes_cross_both_ways(rng, dtype):
    """The bytes either package writes are the same, each reads the
    other's, and a tensor (bf16 too) writes what its numpy twin writes."""
    arr = (rng.randn(3, 4, 2) * 10).astype(
        ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)
    want = jio.serialize_tensor_bytes(arr)
    assert pio.serialize_tensor_bytes(arr) == want
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    assert pio.serialize_tensor_bytes(t) == want
    back = pio.deserialize_tensor_bytes(want)
    assert back.dtype == arr.dtype and back.shape == arr.shape
    assert back.tobytes() == arr.tobytes()
    jback = jio.deserialize_tensor_bytes(pio.serialize_tensor_bytes(t))
    assert jback.dtype == arr.dtype and jback.tobytes() == arr.tobytes()
    with pytest.raises(ValueError, match="not a paddle_tpu tensor file"):
        pio.deserialize_tensor_bytes(b"XXXX" + want[4:])


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("type", ["feed", "fetch"])
def test_feed_and_fetch_are_the_identity(rng, type):
    """The Executors skip both as plumbing; their lowerings hand X on."""
    x = f32(rng, 3, 2)
    main, _, port_main, _ = programs(lambda: append(
        type, {"X": [data(fluid, "x", x.shape)]},
        {"Out": ("float32", x.shape)}))
    jop, pop = main.global_block().ops[-1], port_main.global_block().ops[-1]
    jvals = {"x": jnp.asarray(x)}
    JaxRegistry.get(type).lower(JaxLowerContext(jop, jvals))
    pvals = {"x": torch.from_numpy(x)}
    OpRegistry.get(type).lower(LowerContext(pop, pvals, torch.device("cpu")))
    out = pop.output("Out")[0]
    np.testing.assert_array_equal(pvals[out].numpy(), np.asarray(jvals[out]))


@pytest.mark.parametrize("dtype", ["float32", "int64"])
def test_save_writes_the_same_bytes(rng, tmp_path, dtype):
    """save over a fed X writes the JAX op's file byte for byte (an int64
    X as int64), into a directory it makes; overwrite=False refuses an
    existing file."""
    x = (rng.randn(4, 3) * 5).astype(dtype)

    def build(path, overwrite=True):
        return lambda: append("save", {"X": [data(fluid, "x", x.shape,
                                                   dtype)]}, {},
                              {"file_path": str(path),
                               "overwrite": overwrite})

    jpath, ppath = tmp_path / "j" / "x.bin", tmp_path / "p" / "x.bin"
    main, startup, _, _ = programs(build(jpath))
    fluid.Executor(fluid.CPUPlace()).run(main, feed={"x": x})
    _, _, port_main, _ = programs(build(ppath))
    pt.Executor(pt.CPUPlace()).run(port_main, feed={"x": x})
    np.testing.assert_array_equal(
        pio.deserialize_tensor_bytes(ppath.read_bytes()), x)
    if dtype == "int64":
        # with x64 off the JAX package holds an int64 var as int32 and
        # writes that; the port keeps int64 (ROADMAP Queue 3, int64)
        jarr = jio.deserialize_tensor_bytes(jpath.read_bytes())
        assert jarr.dtype == np.int32
        assert ppath.read_bytes() == jio.serialize_tensor_bytes(
            jarr.astype(np.int64))
    else:
        assert ppath.read_bytes() == jpath.read_bytes()
    _, _, port_main, _ = programs(build(ppath, overwrite=False))
    with pytest.raises(IOError, match="overwrite=False"):
        pt.Executor(pt.CPUPlace()).run(port_main, feed={"x": x})


def test_load_reads_the_file_and_rereads_it_on_every_run(rng, tmp_path):
    """load gives the file's tensor as the JAX op does.  The JAX op reads
    the file when it traces the op, so its Executor keeps the first value
    while the plan is cached; the port reads the file on every run (a
    quirk not followed, ROADMAP Queue 3)."""
    path = tmp_path / "w.bin"
    first, second = f32(rng, 2, 5), f32(rng, 2, 5)
    path.write_bytes(jio.serialize_tensor_bytes(first))
    main, startup, port_main, (out,) = programs(lambda: append(
        "load", {}, {"Out": ("float32", (2, 5))},
        {"file_path": str(path)}))
    jexe, pexe = fluid.Executor(fluid.CPUPlace()), pt.Executor(pt.CPUPlace())
    (want,) = jexe.run(main, fetch_list=[out.name])
    (got,) = pexe.run(port_main, fetch_list=[out.name])
    compare(out.name, got, want, 0.0)
    path.write_bytes(pio.serialize_tensor_bytes(second))
    (want,) = jexe.run(main, fetch_list=[out.name])
    (got,) = pexe.run(port_main, fetch_list=[out.name])
    np.testing.assert_array_equal(np.asarray(want), first)
    np.testing.assert_array_equal(got, second)


def test_print_prints_the_jax_text(rng, capfd):
    """print over a fed X and a fed LoD X: the same text, once a run,
    and X handed on."""
    x = f32(rng, 3, 4)
    ids = (np.arange(5, dtype=np.int64).reshape(5, 1), [[0, 2, 5]])

    def build():
        xv = data(fluid, "x", x.shape)
        iv = data(fluid, "ids", (5, 1), "int64", lod_level=1)
        a = append("print", {"X": [xv]}, {"Out": ("float32", x.shape)},
                   {"message": "x here"})
        b = append("print", {"X": [iv]}, {"Out": ("int64", (5, 1))},
                   {"message": "ids"})
        return a + b

    got, want, ptext, jtext = run_twice(
        build, {"x": x, "ids": ids}, ["print_0.tmp_0", "print_1.tmp_0"],
        capfd, runs=2)
    assert ptext == jtext
    assert ptext.count("[print x here]") == 2 and "[print ids]" in ptext
    np.testing.assert_array_equal(got[-1][0], x)


def test_grad_printer_prints_the_gradient_in_the_backward(rng, capfd):
    """grad_printer is the identity forward; its grad op prints the
    cotangent as the JAX op does and passes it through."""
    x = f32(rng, 3, 4)

    def build():
        xv = data(fluid, "x", x.shape, grad=True)
        (y,) = append("grad_printer", {"X": [xv]},
                      {"Out": ("float32", x.shape)}, {"message": "gp"})
        from test_torch_gru import weighted_loss

        fluid.backward.append_backward(weighted_loss([y]))
        return y

    got, want, ptext, jtext = run_twice(build, {"x": x}, ["x@GRAD"], capfd)
    assert "[grad gp]" in jtext
    assert ptext == jtext
    compare("x@GRAD", got[0][0], want[0][0], TOL)


def _seqtext(build_feed, tmp_path, name, dict_file=None, with_id=False):
    """The text each package's seq_text_printer writes to a file of its
    own: two runs in one Scope (the second appends), then a run in a new
    Scope (which truncates)."""
    texts = []
    for fl, ex_mod, exe_of in (
            (fluid, jexecutor, lambda: fluid.Executor(fluid.CPUPlace())),
            (pt, pexecutor, lambda: pt.Executor(pt.CPUPlace()))):
        path = tmp_path / f"{name}_{fl.__name__}.txt"
        main, _, port_main, _ = programs(lambda: _seqtext_op(
            build_feed, path, dict_file, with_id))
        prog = main if fl is fluid else port_main
        exe = exe_of()
        runs = []
        for scope_runs in (2, 1):
            scope = ex_mod.Scope()
            with ex_mod.scope_guard(scope):
                for _ in range(scope_runs):
                    exe.run(prog, feed=build_feed()[1], fetch_list=[])
                    runs.append(path.read_text())
        texts.append(runs)
    return texts


def _seqtext_op(build_feed, path, dict_file, with_id):
    shape, feed, lod = build_feed()
    ins = {"X": [data(fluid, "ids", shape, "int64", lod_level=lod)]}
    if with_id:
        ins["Id"] = [data(fluid, "sid", (feed["sid"].shape[0], 1), "int64")]
    return append("seq_text_printer", ins, {"Out": ("int64", shape)},
                  {"result_file": str(path), "dict_file": dict_file,
                   "delimited": True})


@pytest.mark.parametrize("case", ["lod_dict", "lod_id", "dense"])
def test_seq_text_printer_writes_the_jax_text(tmp_path, case):
    """id \\t tokens lines over LoD rows (with the dictionary, or with an
    Id input) and over dense rows; truncated once a Scope, appended to
    within it."""
    dict_file = tmp_path / "dict.txt"
    dict_file.write_text("the\ncat\nsat\nmat\n")
    if case == "dense":
        def build_feed():
            v = np.array([[0, 1, 2], [3, 4, 5]], np.int64)
            return v.shape, {"ids": v}, 0
    else:
        def build_feed():
            ids = (np.array([[0], [1], [2], [1], [3]], np.int64),
                   [[0, 3, 5]])
            feed = {"ids": ids}
            if case == "lod_id":
                feed["sid"] = np.array([[7], [9]], np.int64)
            return (5, 1), feed, 1
    jruns, pruns = _seqtext(build_feed, tmp_path, case,
                            str(dict_file) if case == "lod_dict" else None,
                            with_id=case == "lod_id")
    assert pruns == jruns
    assert len(pruns[1].splitlines()) == 2 * len(pruns[0].splitlines())
    assert pruns[2] == pruns[0]


@pytest.mark.parametrize("grad", [False, True])
def test_cond_merges_both_branches_row_by_row(rng, grad):
    """cond runs its true and false sub-blocks over the whole batch and
    takes each row from the branch its Cond picks; its gradient too."""
    x = f32(rng, 6, 3)
    c = np.array([[1], [0], [0], [1], [1], [0]], np.int64)

    def build():
        xv = data(fluid, "x", x.shape, grad=grad)
        cv = data(fluid, "c", c.shape, "int64")
        helper = LayerHelper("cond")
        out = helper.create_tmp_variable("float32", x.shape)
        prog = helper.main_program
        blocks = []
        for scale, bias in ((2.0, 1.0), (-1.0, 0.5)):
            blocks.append(prog.create_block())
            helper.append_op(type="scale", inputs={"X": [xv]},
                             outputs={"Out": [out]},
                             attrs={"scale": scale, "bias": bias})
            prog.rollback()
        helper.append_op(type="cond", inputs={"Cond": [cv], "Xs": [xv]},
                         outputs={"Outs": [out]},
                         attrs={"true_block": blocks[0],
                                "false_block": blocks[1]})
        return [out]

    got = run_op(build, {"x": x, "c": c}, grads_of=["x"] if grad else (),
                 diff=grad)
    out = got["cond_0.tmp_0"]
    want = np.where(c.astype(bool), 2 * x + 1, -x + 0.5)
    np.testing.assert_allclose(out, want, rtol=1e-6)


def test_host_side_ops_keep_their_plans_eager(tmp_path, rng):
    """save, load, print, seq_text_printer and grad_printer's grad op
    hold an OpInfo.host_sync reason (a graph replays no Python, so they
    would print or write once); grad_printer's forward and cond hold
    none; the optimizer leaves the side effects in place."""
    from paddle_tpu_torch.analysis import optimize_program
    from paddle_tpu_torch.executor import _op_sync_reason

    for t in ("save", "load", "print", "seq_text_printer",
              "grad_printer_grad"):
        assert _op_sync_reason(type("Op", (), {"type": t, "attr":
                                               lambda s, k, d=None: d})(),
                               OpRegistry.get(t)), t
    for t in ("grad_printer", "cond", "feed", "fetch"):
        assert _op_sync_reason(type("Op", (), {"type": t, "attr":
                                               lambda s, k, d=None: d})(),
                               OpRegistry.get(t)) is None, t
    x = f32(rng, 2, 3)

    def build():
        xv = data(fluid, "x", x.shape)
        append("save", {"X": [xv]}, {}, {"file_path": str(tmp_path / "x")})
        return append("print", {"X": [xv]}, {"Out": ("float32", x.shape)},
                      {"message": "m"})

    _, _, port_main, _ = programs(build)
    opt, _ = optimize_program(port_main, feed_names={"x"}, fetch_names=[])
    assert [op.type for op in opt.global_block().ops] == ["save", "print"]
    plan = pt.Executor._classify(port_main, {"x": torch.zeros(2, 3)}, [])
    assert [w for w, _ in plan.eager_reasons] == ["op 0 (save)",
                                                 "op 1 (print)"]


# ---------------------------------------------------------------------------
# the v1 evaluators
# ---------------------------------------------------------------------------


def _eval_run(fl, make_ev, feed, size_x=4, size_pred=3, int_label=True,
              backward=False, retype=None):
    """The tests/test_evaluators_tail.py config in package ``fl``: a tiny
    fc net, the evaluator(s) ``make_ev(v1, ev_module, pred, lab)`` beside
    it; (Topology, the evaluator layers)."""
    import importlib

    v1 = importlib.import_module(f"{fl.__name__}.trainer_config_helpers")
    evm = importlib.import_module(
        f"{fl.__name__}.trainer_config_helpers.evaluators")
    cp = importlib.import_module(f"{fl.__name__}.trainer.config_parser")
    dt = importlib.import_module(f"{fl.__name__}.v2.data_type")
    topo_mod = importlib.import_module(f"{fl.__name__}.v2.topology")
    # the layers' names (which the printers print) count from here
    importlib.import_module(f"{fl.__name__}.v2.layer")._counter[0] = 0
    holder = {}

    def config():
        x = v1.data_layer(name="x", size=size_x)
        lab = v1.data_layer(name="lab", size=size_pred)
        pred = v1.fc_layer(input=x, size=size_pred,
                           act=v1.SoftmaxActivation())
        holder["evs"] = make_ev(v1, evm, pred, lab)
        v1.outputs(v1.classification_cost(input=pred, label=lab))

    fl.framework.reset_default_programs()
    conf = cp.parse_config(config)
    if int_label:
        conf.data_layers["lab"].input_type = dt.integer_value(size_pred)
    for name, t in (retype or {}).items():
        conf.data_layers[name].input_type = getattr(dt, t[0])(*t[1:])
    evs = holder["evs"]
    evs = [e for e in (evs if isinstance(evs, (list, tuple)) else [evs])
           if hasattr(e, "build")]
    topo = topo_mod.Topology(conf.cost, extra_layers=evs)
    if backward:
        with fl.program_guard(topo.main_program, topo.startup_program):
            fl.append_backward(topo.cost_var)
    return topo


def _numbers(text):
    import re

    return np.asarray([float(t) for t in re.findall(
        r"-?\d+\.\d*(?:e[-+]\d+)?|-?\d+(?:e[-+]\d+)?",
        re.sub(r"\[(print|grad) [^\]]*\]", "", text))])


def evaluator_parity(make_ev, feed, capfd, **kw):
    """Both packages' topologies from the same weights and feed: the
    programs equal, every extra output within TOL of max, the printed
    lines' prefixes equal and their numbers within TOL of max."""
    jt = _eval_run(fluid, make_ev, feed, **kw)
    pt_topo = _eval_run(pt, make_ev, feed, **kw)
    assert pt.Program.from_dict(jax_dict(jt.main_program)) is not None
    fetch = [v.name for v in jt.output_vars]
    assert fetch == [v.name for v in pt_topo.output_vars]
    jscope = jexecutor.Scope()
    with jexecutor.scope_guard(jscope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(jt.startup_program)
        state = {n: np.asarray(v) for n, v in jscope.values.items()}
        want = exe.run(jt.main_program, feed=feed, fetch_list=fetch)
    jtext = capfd.readouterr().out
    scope = pt.Scope()
    scope.load_numpy(state, "cpu")
    with pexecutor.scope_guard(scope):
        got = pt.Executor(pt.CPUPlace()).run(
            pt_topo.main_program, feed=feed, fetch_list=fetch, scope=scope)
    ptext = capfd.readouterr().out
    for name, g, w in zip(fetch, got, want):
        compare(name, g, w, TOL)
    plines = [ln.split("]")[0] for ln in ptext.splitlines()
              if ln.startswith(("[print", "[grad"))]
    assert plines == [ln.split("]")[0] for ln in jtext.splitlines()
                      if ln.startswith(("[print", "[grad"))]
    pn, jn = _numbers(ptext), _numbers(jtext)
    assert pn.shape == jn.shape
    if jn.size:
        assert np.abs(pn - jn).max() <= TOL * max(np.abs(jn).max(), 1.0)
    return got, plines


def _feed(seed=0, B=6, size_x=4, k=3):
    r = np.random.RandomState(seed)
    return {"x": r.randn(B, size_x).astype("float32"),
            "lab": r.randint(0, k, (B, 1)).astype("int64")}


EVALUATORS = {
    "classification_error": (
        lambda v1, ev, p, l: ev.classification_error_evaluator(p, l), {}),
    "auc": (lambda v1, ev, p, l: ev.auc_evaluator(p, l),
            dict(size_pred=2, feed_k=2)),
    "precision_recall": (
        lambda v1, ev, p, l: ev.precision_recall_evaluator(p, l), {}),
    "sum": (lambda v1, ev, p, l: ev.sum_evaluator(input=p), {}),
    "sum_weighted": (lambda v1, ev, p, l: ev.sum_evaluator(
        input=p, weight=v1.data_layer(name="w", size=1)), dict(w=True)),
    "column_sum": (lambda v1, ev, p, l: [ev.column_sum_evaluator(input=p),
                                          p], {}),
    "column_sum_weighted": (lambda v1, ev, p, l: ev.column_sum_evaluator(
        input=p, weight=v1.data_layer(name="w", size=1)), dict(w=True)),
    "value_printer": (lambda v1, ev, p, l: ev.value_printer_evaluator(
        input=p, name="vp"), {}),
    "maxid_printer": (lambda v1, ev, p, l: ev.maxid_printer_evaluator(
        input=p, num_results=2, name="mi"), {}),
    "maxframe_printer": (lambda v1, ev, p, l: ev.maxframe_printer_evaluator(
        input=p, num_results=2, name="mf"), {}),
    "classification_error_printer": (
        lambda v1, ev, p, l: ev.classification_error_printer_evaluator(
            input=p, label=l, name="cep"), {}),
    "gradient_printer": (lambda v1, ev, p, l: ev.gradient_printer_evaluator(
        input=p, name="gp"), dict(backward=True)),
}


@pytest.mark.parametrize("name", sorted(EVALUATORS))
def test_evaluator_against_the_jax_package(name, capfd):
    make_ev, opts = EVALUATORS[name]
    opts = dict(opts)
    feed = _feed(k=opts.pop("feed_k", 3))
    if opts.pop("w", False):
        feed["w"] = np.arange(6, dtype="float32").reshape(6, 1)
    got, lines = evaluator_parity(make_ev, feed, capfd, **opts)
    if "printer" in name:
        assert lines, name


def test_chunk_and_pnpair_evaluators(capfd):
    """chunk_evaluator (IOB over int ids) and pnpair_evaluator (scores
    within query ids), fed as data layers."""
    r = np.random.RandomState(3)
    feed = {"x": r.randn(6, 4).astype("float32"),
            "lab": r.randint(0, 5, (6, 1)).astype("int64"),
            "inf": r.randint(0, 5, (6, 1)).astype("int64"),
            "score": r.randn(6, 1).astype("float32"),
            "qid": np.array([[0], [0], [0], [1], [1], [1]], np.int64)}

    def make(v1, ev, p, lab):
        inf = v1.data_layer(name="inf", size=5)
        score = v1.data_layer(name="score", size=1)
        qid = v1.data_layer(name="qid", size=1)
        return [ev.chunk_evaluator(inf, lab, chunk_scheme="IOB",
                                   num_chunk_types=2),
                ev.pnpair_evaluator(score, lab, qid)]

    evaluator_parity(make, feed, capfd, size_pred=5, retype={
        "inf": ("integer_value", 5), "qid": ("integer_value", 2)})


def test_seqtext_printer_evaluator(tmp_path, capfd):
    """seqtext_printer_evaluator over the argmax ids of each row: both
    packages write the same file."""
    texts = []
    for fl in (fluid, pt):
        path = tmp_path / f"{fl.__name__}.txt"

        def make(v1, ev, p, lab, _path=path):
            return ev.seqtext_printer_evaluator(input=lab,
                                                result_file=str(_path))

        topo = _eval_run(fl, make, _feed())
        ex_mod = jexecutor if fl is fluid else pexecutor
        scope = ex_mod.Scope()
        exe = (fluid.Executor(fluid.CPUPlace()) if fl is fluid
               else pt.Executor(pt.CPUPlace()))
        with ex_mod.scope_guard(scope):
            exe.run(topo.startup_program)
            exe.run(topo.main_program, feed=_feed(),
                    fetch_list=[topo.output_vars[0]])
        texts.append(path.read_text())
    assert texts[1] == texts[0] and len(texts[0].splitlines()) == 6


def test_host_accumulator_evaluators():
    """ctc_error_evaluator and detection_map_evaluator give the host-side
    accumulators, with the JAX package's settings."""
    from paddle_tpu.trainer_config_helpers import evaluators as jev
    from paddle_tpu_torch import evaluator as pev_mod
    from paddle_tpu_torch.trainer_config_helpers import evaluators as pev

    assert sorted(pev.__all__) == sorted(jev.__all__)
    assert isinstance(pev.ctc_error_evaluator(), pev_mod.CTCError)
    for ap in ("11point", "Integral"):
        p = pev.detection_map_evaluator(overlap_threshold=0.4, ap_type=ap)
        j = jev.detection_map_evaluator(overlap_threshold=0.4, ap_type=ap)
        assert isinstance(p, pev_mod.DetectionMAP)
        assert (p.overlap_threshold, p.ap_version) == (j.overlap_threshold,
                                                       j.ap_version)
