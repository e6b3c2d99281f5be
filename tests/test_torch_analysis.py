"""The port's program verifier (``paddle_tpu_torch/analysis``) against the
JAX package's (``paddle_tpu/analysis``): every case of
tests/test_analysis.py, built once in the JAX package and handed to the
port through ``to_dict``, JSON and ``Program.from_dict`` (or built in
each package where the case needs an object JSON cannot carry, a foreign
block), must give the same diagnostics: code, severity, block, op index,
op type, variable and message.  Plus the Executor's gate at a plan miss,
the registry audit against the port's own baseline, and the
did-you-mean registry errors."""

import json

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import analysis as janalysis
from paddle_tpu.flags import FLAGS as JFLAGS
from paddle_tpu.registry import OpInfo as JOpInfo
from paddle_tpu.registry import OpRegistry as JRegistry
from paddle_tpu.registry import SkipInferShape as JSkip
from paddle_tpu_torch import analysis
from paddle_tpu_torch.analysis import ProgramVerificationError, Severity
from paddle_tpu_torch.flags import FLAGS
from paddle_tpu_torch.registry import OpInfo, OpRegistry, SkipInferShape


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


def jax_dict(prog):
    """The JAX package's ``to_dict`` through JSON, block refs as
    ``{"__block__": idx}``."""
    def block_ref(o):
        if hasattr(o, "idx") and hasattr(o, "ops"):
            return {"__block__": o.idx}
        raise TypeError(f"{type(o).__name__} is not JSON serializable")

    return json.loads(json.dumps(prog.to_dict(), default=block_ref))


def _key(d):
    return (d.code, d.severity, d.block_idx, d.op_idx, d.op_type, d.var,
            d.message)


def _same(jdiags, pdiags):
    assert sorted(map(_key, pdiags)) == sorted(map(_key, jdiags))
    return pdiags


def _verify_both(feeds=None, fetches=None, level="warning"):
    """The JAX default main program and its port, both verified."""
    jprog = fluid.default_main_program()
    pprog = pt.Program.from_dict(jax_dict(jprog))
    jd = janalysis.verify_program(jprog, feed_names=feeds,
                                  fetch_names=fetches, level=level)
    pd = analysis.verify_program(pprog, feed_names=feeds,
                                 fetch_names=fetches, level=level)
    return _same(jd, pd)


def _each(build, feeds=None, fetches=None, level="warning"):
    """``build(lib)`` in each package's default main program, verified
    there."""
    out = []
    for lib, an in ((fluid, janalysis), (pt, analysis)):
        build(lib)
        out.append(an.verify_program(lib.default_main_program(),
                                     feed_names=feeds, fetch_names=fetches,
                                     level=level))
    return _same(*out)


def _codes(diags):
    return {d.code for d in diags}


# ---------------------------------------------------------------------------
# one broken program per check
# ---------------------------------------------------------------------------


def test_read_before_write_fires_pve01():
    block = fluid.default_main_program().global_block()
    block.create_var(name="out", shape=[4], dtype="float32")
    block.append_op(type="relu", inputs={"X": ["never_written"]},
                    outputs={"Out": ["out"]})
    diags = _verify_both(feeds=set(), fetches=["out"], level="error")
    (d,) = [d for d in diags if d.code == "PVE01"]
    assert d.var == "never_written" and d.op_idx == 0 and d.block_idx == 0
    assert d.severity == Severity.ERROR and d.op_type == "relu"


def test_read_of_later_write_fires_pve01():
    block = fluid.default_main_program().global_block()
    block.create_var(name="a", shape=[4], dtype="float32")
    block.create_var(name="b", shape=[4], dtype="float32")
    block.append_op(type="relu", inputs={"X": ["a"]}, outputs={"Out": ["b"]})
    block.append_op(type="fill_constant", outputs={"Out": ["a"]},
                    attrs={"shape": [4], "value": 1.0, "dtype": "float32"})
    diags = _verify_both(feeds=set(), fetches=["b"], level="error")
    assert any(d.code == "PVE01" and d.var == "a" for d in diags), diags


def test_dtype_clash_fires_pve03():
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    y = fluid.layers.data(name="y", shape=[4], dtype="int32")
    out = fluid.layers.elementwise_add(x=x, y=y)
    diags = _verify_both(feeds={"x", "y"}, fetches=[out.name],
                         level="error")
    (d,) = [d for d in diags if d.code == "PVE03"]
    assert d.op_type == "elementwise_add" and "int32" in d.message


def test_dangling_fetch_fires_pve02():
    x = fluid.layers.data(name="x", shape=[4])
    fluid.layers.fc(input=x, size=3)
    diags = _verify_both(feeds={"x"}, fetches=["no_such_var"],
                         level="error")
    (d,) = [d for d in diags if d.code == "PVE02"]
    assert d.var == "no_such_var" and "fetch list" in d.message


def test_waw_overwrite_fires_pvw01():
    block = fluid.default_main_program().global_block()
    block.create_var(name="t", shape=[2], dtype="float32")
    for value in (1.0, 2.0):
        block.append_op(type="fill_constant", outputs={"Out": ["t"]},
                        attrs={"shape": [2], "value": value,
                               "dtype": "float32"})
    diags = _verify_both(feeds=set(), fetches=["t"], level="warning")
    (d,) = [d for d in diags if d.code == "PVW01"]
    assert d.var == "t" and d.op_idx == 1


def test_waw_spares_read_modify_write():
    block = fluid.default_main_program().global_block()
    block.create_var(name="t", shape=[2], dtype="float32")
    block.append_op(type="fill_constant", outputs={"Out": ["t"]},
                    attrs={"shape": [2], "value": 0.0, "dtype": "float32"})
    block.append_op(type="increment", inputs={"X": ["t"]},
                    outputs={"Out": ["t"]}, attrs={"step": 1.0})
    diags = _verify_both(feeds=set(), fetches=["t"], level="warning")
    assert "PVW01" not in _codes(diags), diags


def test_bad_sub_block_fires_pve04():
    """A block of another Program as a while's sub_block: JSON cannot
    carry a foreign block, so each package builds the case."""
    def build(lib):
        other = lib.Program()
        block = lib.default_main_program().global_block()
        block.create_var(name="c", shape=[1], dtype="bool")
        block.append_op(type="fill_constant", outputs={"Out": ["c"]},
                        attrs={"shape": [1], "value": 0.0, "dtype": "bool"})
        block.append_op(type="while", inputs={"Condition": ["c"], "X": []},
                        outputs={"Out": []},
                        attrs={"sub_block": other.global_block()})

    diags = _each(build, feeds=set(), fetches=["c"], level="error")
    (d,) = [d for d in diags if d.code == "PVE04"]
    assert d.op_type == "while" and "different Program" in d.message


def test_unknown_op_fires_pve05_with_suggestion():
    block = fluid.default_main_program().global_block()
    block.create_var(name="a", shape=[2], dtype="float32")
    block.create_var(name="b", shape=[2], dtype="float32")
    op = fluid.Operator.__new__(fluid.Operator)
    op.block, op.type = block, "sofmax"  # typo for softmax
    op.inputs, op.outputs = {"X": ["a"]}, {"Out": ["b"]}
    op.attrs = {}
    block.ops.append(op)
    diags = _verify_both(feeds={"a"}, fetches=["b"], level="error")
    (d,) = [d for d in diags if d.code == "PVE05"]
    assert "sofmax" in d.message and "softmax" in (d.hint or "")


def test_grad_pairing_fires_pve06():
    block = fluid.default_main_program().global_block()
    block.create_var(name="phantom@GRAD", shape=[4], dtype="float32")
    diags = _verify_both(feeds=set(), fetches=None, level="error")
    (d,) = [d for d in diags if d.code == "PVE06"]
    assert "phantom" in d.message


def test_shape_infer_rejection_fires_pve07():
    """A registered infer_shape rule that rejects the op's metadata, in
    both registries: the port's PVE07 runs its own OpInfo.infer_shape."""
    def strict(skip):
        def rule(op, block):
            xv = block.find_var(op.inputs["X"][0])
            ov = block.find_var(op.outputs["Out"][0])
            if xv is None or ov is None or xv.shape is None \
                    or ov.shape is None:
                raise skip
            if tuple(xv.shape) != tuple(ov.shape):
                raise ValueError(f"shape {ov.shape} != input {xv.shape}")
        return rule

    JRegistry.register(JOpInfo(type="t_strict_unary", lower=lambda c: None,
                               infer_shape=strict(JSkip),
                               input_slots=("X",)))
    OpRegistry.register(OpInfo(type="t_strict_unary", lower=lambda c: None,
                               infer_shape=strict(SkipInferShape),
                               input_slots=("X",)))
    try:
        block = fluid.default_main_program().global_block()
        block.create_var(name="a", shape=[4], dtype="float32")
        out = block.create_var(name="b", shape=[4], dtype="float32")
        block.append_op(type="t_strict_unary", inputs={"X": ["a"]},
                        outputs={"Out": ["b"]})
        out.shape = (5,)  # break the declared metadata after the fact
        diags = _verify_both(feeds={"a"}, fetches=["b"], level="error")
        (d,) = [d for d in diags if d.code == "PVE07"]
        assert d.op_type == "t_strict_unary"
    finally:
        JRegistry._ops.pop("t_strict_unary", None)
        OpRegistry._ops.pop("t_strict_unary", None)


def test_persistable_double_write_fires_pvw02():
    block = fluid.default_main_program().global_block()
    block.create_var(name="state", shape=[2], dtype="float32",
                     persistable=True)
    for value in (1.0, 2.0):
        block.append_op(type="fill_constant", outputs={"Out": ["state"]},
                        attrs={"shape": [2], "value": value,
                               "dtype": "float32"})
    diags = _verify_both(feeds=set(), fetches=["state"], level="warning")
    (d,) = [d for d in diags if d.code == "PVW02"]
    assert d.var == "state" and "last write wins" in d.message


def test_unused_feed_fires_pvw03():
    x = fluid.layers.data(name="x", shape=[4])
    fluid.layers.data(name="unused", shape=[4])
    out = fluid.layers.fc(input=x, size=3)
    diags = _verify_both(feeds={"x", "unused"}, fetches=[out.name],
                         level="warning")
    (d,) = [d for d in diags if d.code == "PVW03"]
    assert d.var == "unused"


def test_dead_code_reported_at_info():
    x = fluid.layers.data(name="x", shape=[4])
    live = fluid.layers.fc(input=x, size=3)
    fluid.layers.relu(x)  # result reaches nothing
    diags = _verify_both(feeds={"x"}, fetches=[live.name], level="all")
    assert any(d.code == "PVI01" and d.op_type == "relu" for d in diags)


def test_clean_training_program_verifies_clean():
    x = fluid.layers.data(name="x", shape=[8])
    y = fluid.layers.data(name="y", shape=[8])
    out = fluid.layers.fc(input=x, size=8, act="relu")
    loss = fluid.layers.mean(fluid.layers.square_error_cost(input=out,
                                                            label=y))
    fluid.optimizer.SGD(learning_rate=1e-3).minimize(loss)
    for jprog, feeds, fetches in (
            (fluid.default_main_program(), {"x", "y"}, [loss.name]),
            (fluid.default_startup_program(), set(), None)):
        pprog = pt.Program.from_dict(jax_dict(jprog))
        jd = janalysis.verify_program(jprog, feed_names=feeds,
                                      fetch_names=fetches, level="all")
        pd = analysis.verify_program(pprog, feed_names=feeds,
                                     fetch_names=fetches, level="all")
        assert not _same(jd, pd), analysis.format_report(pd)


def test_while_program_verifies_clean():
    layers = fluid.layers
    i = layers.fill_constant(shape=(1,), dtype="float32", value=0.0)
    n = layers.fill_constant(shape=(1,), dtype="float32", value=4.0)
    acc = layers.fill_constant(shape=(1,), dtype="float32", value=0.0)
    cond = layers.less_than(i, n)
    w = layers.While(cond)
    with w.block():
        new_acc = layers.elementwise_add(x=acc, y=i)
        layers.assign(new_acc, output=acc)
        layers.increment(i, value=1.0, in_place=True)
        layers.assign(layers.less_than(i, n), output=cond)
    diags = _verify_both(feeds=set(), fetches=[acc.name], level="error")
    assert not diags, analysis.format_report(diags)


def test_report_format_matches():
    """format_report of the same findings reads the same in both."""
    x = fluid.layers.data(name="x", shape=[4])
    fluid.layers.data(name="unused", shape=[4])
    live = fluid.layers.fc(input=x, size=3)
    fluid.layers.relu(x)
    jprog = fluid.default_main_program()
    pprog = pt.Program.from_dict(jax_dict(jprog))
    kw = dict(feed_names={"x", "unused"}, fetch_names=[live.name],
              level="all")
    jrep = janalysis.format_report(janalysis.verify_program(jprog, **kw))
    prep = analysis.format_report(analysis.verify_program(pprog, **kw))
    assert prep == jrep and "PVW03" in prep and "PVI01" in prep


# ---------------------------------------------------------------------------
# the Executor's gate at a plan miss
# ---------------------------------------------------------------------------


def _port_fc():
    x = pt.layers.data(name="x", shape=[4])
    out = pt.layers.fc(input=x, size=3, act="relu")
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    return exe, scope, out


def test_executor_dangling_fetch_clear_error():
    exe, scope, _ = _port_fc()
    with pytest.raises(RuntimeError) as ei:
        exe.run(feed={"x": np.zeros((2, 4), np.float32)},
                fetch_list=["ghost_var"], scope=scope)
    assert "ghost_var" in str(ei.value) and "fetch list" in str(ei.value)


def test_executor_check_program_flag_rejects_before_any_op(monkeypatch):
    """The error tier raises at the plan miss, before any op lowers: the
    relu rule is never called."""
    block = pt.default_main_program().global_block()
    block.create_var(name="out", shape=[4], dtype="float32")
    block.append_op(type="relu", inputs={"X": ["never_written"]},
                    outputs={"Out": ["out"]})
    calls = []
    info = OpRegistry.get("relu")
    monkeypatch.setattr(info, "lower", lambda ctx: calls.append(ctx))
    FLAGS.set("check_program", True)
    try:
        exe = pt.Executor(pt.CPUPlace())
        with pytest.raises(ProgramVerificationError) as ei:
            exe.run(feed={}, fetch_list=["out"], scope=pt.Scope())
        assert "PVE01" in str(ei.value) and "never_written" in str(ei.value)
        assert calls == [] and not exe._cache
    finally:
        FLAGS.set("check_program", False)


def test_executor_check_program_flag_passes_valid_program():
    FLAGS.set("check_program", True)
    try:
        exe, scope, out = _port_fc()
        (o,) = exe.run(feed={"x": np.ones((2, 4), np.float32)},
                       fetch_list=[out], scope=scope)
        assert o.shape == (2, 3)
    finally:
        FLAGS.set("check_program", False)


def test_check_program_messages_match_the_reference():
    """The same rejected program raises the same report in both
    Executors."""
    block = fluid.default_main_program().global_block()
    block.create_var(name="out", shape=[4], dtype="float32")
    block.append_op(type="relu", inputs={"X": ["never_written"]},
                    outputs={"Out": ["out"]})
    pprog = pt.Program.from_dict(jax_dict(fluid.default_main_program()))
    FLAGS.set("check_program", True)
    JFLAGS.set("check_program", True)
    try:
        with pytest.raises(janalysis.ProgramVerificationError) as jei:
            fluid.Executor(fluid.CPUPlace()).run(feed={},
                                                 fetch_list=["out"])
        with pytest.raises(ProgramVerificationError) as pei:
            pt.Executor(pt.CPUPlace()).run(pprog, feed={},
                                           fetch_list=["out"],
                                           scope=pt.Scope())
        assert str(pei.value) == str(jei.value)
    finally:
        FLAGS.set("check_program", False)
        JFLAGS.set("check_program", False)


# ---------------------------------------------------------------------------
# registry: audit ratchet + did-you-mean
# ---------------------------------------------------------------------------


def test_registry_audit_clean_against_checked_in_baseline():
    """The port's registry against the port's own baseline: no
    regression and no stale entry."""
    diags = analysis.audit_registry()
    assert not diags, analysis.format_report(diags)


def test_port_baseline_within_the_reference_baseline():
    """Every op the port grandfathers, the JAX package grandfathers too:
    the port's coverage is no worse op for op."""
    jbase, pbase = janalysis.load_baseline(), analysis.load_baseline()
    for key in pbase:
        assert set(pbase[key]) <= set(jbase[key]), key


def test_registry_audit_catches_regression():
    OpRegistry.register(OpInfo(type="t_bare_op", lower=lambda ctx: None))
    try:
        errs = [d for d in analysis.audit_registry()
                if d.severity == Severity.ERROR]
        assert any(d.code == "PVA01" and d.var == "t_bare_op"
                   for d in errs), errs
        assert any(d.code == "PVA02" and d.var == "t_bare_op"
                   for d in errs), errs
    finally:
        OpRegistry._ops.pop("t_bare_op", None)


def test_registry_audit_flags_stale_baseline_entries():
    baseline = analysis.load_baseline()
    baseline["missing_infer_shape"] = (baseline["missing_infer_shape"]
                                       + ["t_never_registered"])
    diags = analysis.audit_registry(baseline)
    assert any(d.code == "PVA03" and d.var == "t_never_registered"
               for d in diags), diags


def test_registry_get_suggests_close_name():
    with pytest.raises(KeyError) as ei:
        OpRegistry.get("rellu")
    assert "did you mean 'relu'" in str(ei.value)
    with pytest.raises(KeyError) as ei:
        OpRegistry.get("sofmax_grad")
    assert "softmax_grad" in str(ei.value)


def test_infer_same_shape_fills_missing_metadata():
    block = pt.default_main_program().global_block()
    block.create_var(name="src", shape=[3, 7], dtype="float32")
    block.create_var(name="dst", dtype="float32")  # no shape
    block.append_op(type="relu", inputs={"X": ["src"]},
                    outputs={"Out": ["dst"]})
    assert block.var("dst").shape == (3, 7)
