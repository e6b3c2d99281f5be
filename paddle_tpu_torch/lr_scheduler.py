"""Learning-rate schedules as in-graph sub-programs
(``paddle_tpu/lr_scheduler.py``): each schedule is a few ops computing
the rate from the persistable ``@lr_global_step@`` counter, which an
``increment`` op bumps once a step; pass the returned Variable as an
optimizer's ``learning_rate``.  The programs equal the JAX package's."""

from __future__ import annotations

import math

from paddle_tpu_torch.initializer import ConstantInitializer
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["exponential_decay", "natural_exp_decay", "inverse_time_decay",
           "polynomial_decay", "piecewise_decay"]


def _counter(helper: LayerHelper, step_name="@lr_global_step@"):
    main = helper.main_program.global_block()
    if main.has_var(step_name):
        return main.var(step_name)
    startup = helper.startup_program.global_block()
    svar = startup.create_var(name=step_name, shape=(1,), dtype="float32",
                              persistable=True)
    ConstantInitializer(0.0)(svar, startup)
    var = main.create_var(name=step_name, shape=(1,), dtype="float32",
                          persistable=True)
    main.append_op(type="increment", inputs={"X": [var]},
                   outputs={"Out": [var]}, attrs={"step": 1.0})
    return var


def _unary_chain(helper, x, ops):
    """Threads x through (op_type, attrs) ops, each a (1,) float32."""
    for op_type, attrs in ops:
        out = helper.create_tmp_variable("float32", (1,))
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs=attrs)
        x = out
    return x


def _step_over(helper, decay_steps, staircase):
    div = _unary_chain(helper, _counter(helper),
                       [("scale", {"scale": 1.0 / decay_steps})])
    return _unary_chain(helper, div, [("floor", {})]) if staircase else div


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False, **kwargs):
    """lr * decay_rate ^ (step / decay_steps)."""
    helper = LayerHelper("exponential_decay", **kwargs)
    return _unary_chain(helper, _step_over(helper, decay_steps, staircase), [
        ("scale", {"scale": math.log(decay_rate)}),
        ("exp", {}),
        ("scale", {"scale": float(learning_rate)})])


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False, **kwargs):
    """lr * exp(-decay_rate * step / decay_steps)."""
    helper = LayerHelper("natural_exp_decay", **kwargs)
    return _unary_chain(helper, _step_over(helper, decay_steps, staircase), [
        ("scale", {"scale": -float(decay_rate)}),
        ("exp", {}),
        ("scale", {"scale": float(learning_rate)})])


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False, **kwargs):
    """lr / (1 + decay_rate * step / decay_steps)."""
    helper = LayerHelper("inverse_time_decay", **kwargs)
    return _unary_chain(helper, _step_over(helper, decay_steps, staircase), [
        ("scale", {"scale": float(decay_rate), "bias": 1.0}),
        ("reciprocal", {}),
        ("scale", {"scale": float(learning_rate)})])


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=1e-4,
                     power=1.0, cycle=False, **kwargs):
    """(lr - end) (1 - min(step, decay_steps) / decay_steps)^power + end;
    ``cycle`` is accepted and, as in the JAX package, not applied."""
    helper = LayerHelper("polynomial_decay", **kwargs)
    return _unary_chain(helper, _counter(helper), [
        ("scale", {"scale": 1.0 / decay_steps}),
        ("clip", {"min": 0.0, "max": 1.0}),
        ("scale", {"scale": -1.0, "bias": 1.0}),
        ("pow", {"factor": float(power)}),
        ("scale", {"scale": float(learning_rate - end_learning_rate),
                   "bias": float(end_learning_rate)})])


def piecewise_decay(boundaries, values, **kwargs):
    """values[i] for step in [boundaries[i - 1], boundaries[i]): values[0]
    plus (values[i + 1] - values[i]) [step >= boundaries[i]] summed."""
    assert len(values) == len(boundaries) + 1
    helper = LayerHelper("piecewise_decay", **kwargs)
    step = _counter(helper)

    def const(value):
        v = helper.create_tmp_variable("float32", (1,))
        helper.append_op(type="fill_constant", outputs={"Out": [v]},
                         attrs={"shape": [1], "dtype": "float32",
                                "value": float(value)})
        return v

    acc = const(values[0])
    prev = values[0]
    for b, v in zip(boundaries, values[1:]):
        geq = helper.create_tmp_variable("bool", (1,))
        helper.append_op(type="greater_equal",
                         inputs={"X": [step], "Y": [const(b)]},
                         outputs={"Out": [geq]})
        gf = helper.create_tmp_variable("float32", (1,))
        helper.append_op(type="cast", inputs={"X": [geq]},
                         outputs={"Out": [gf]},
                         attrs={"out_dtype": "float32"})
        delta = _unary_chain(helper, gf, [("scale", {"scale": float(v - prev)})])
        nacc = helper.create_tmp_variable("float32", (1,))
        helper.append_op(type="sum", inputs={"X": [acc, delta]},
                         outputs={"Out": [nacc]})
        acc, prev = nacc, v
    return acc
