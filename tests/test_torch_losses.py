"""The pointwise losses the port adds (``paddle_tpu_torch/ops/loss_ops.py``:
sigmoid_cross_entropy_with_logits, smooth_l1_loss (with and without its
weights), huber_loss, hinge_loss, rank_loss, margin_rank_loss, log_loss
and modified_huber_loss) against the JAX package on the CPU, forward and
gradient: each op in a one-op program, a probe-weighted mean of its loss
output as the objective, ``append_backward`` by the JAX package, the
same Program run by both Executors.  The inputs hold each op's kinks
exactly (x = 0 under |x| and max(x, 0), hinge and margin ties, huber's
|r| = delta), where JAX's gradients are conventions the port must keep.

Tolerance: rtol 1e-5 / atol 1e-6 (the same float32 pointwise math).
"""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.backward import append_backward
from paddle_tpu.layer_helper import LayerHelper

TOL = dict(rtol=1e-5, atol=1e-6)
N = 6


def _col(*vals):
    return np.array(vals, np.float32).reshape(-1, 1)


def _cases():
    rng = np.random.RandomState(12)
    x = rng.randn(N, 3).astype(np.float32)
    x[0, 0] = x[2, 1] = 0.0                     # |x| and max(x, 0) at 0
    y = x + rng.randn(N, 3).astype(np.float32)
    y[1] = x[1]                                 # a zero difference
    y[3, 0] = x[3, 0] + 0.5                     # |d| = 1 / sigma^2 (sigma 2)
    return {
        # op: (inputs, differentiable inputs, attrs, outputs, loss slot)
        "sigmoid_cross_entropy_with_logits": (
            dict(X=x, Label=(rng.rand(N, 3) < 0.5).astype(np.float32)),
            ("X",), {}, ("Out",), "Out"),
        "smooth_l1_loss": (dict(X=x, Y=y), ("X", "Y"), dict(sigma=2.0),
                           ("Diff", "Out"), "Out"),
        "smooth_l1_loss_weighted": (
            dict(X=x, Y=y, InsideWeight=rng.rand(N, 3).astype(np.float32),
                 OutsideWeight=rng.rand(N, 3).astype(np.float32)),
            ("X", "Y"), dict(sigma=1.0), ("Diff", "Out"), "Out"),
        "huber_loss": (dict(X=_col(0.5, -1.0, 2.0, 0.0, 1.5, -3.0),
                            Y=_col(1.5, -1.0, -0.5, 0.7, 1.0, 0.0)),
                       ("X", "Y"), dict(delta=1.0), ("Residual", "Out"),
                       "Out"),
        "hinge_loss": (dict(Logits=_col(1.0, -1.0, 0.3, -2.0, 2.5, 0.0),
                            Labels=_col(1, 0, 1, 1, 0, 0)),
                       ("Logits",), {}, ("Loss",), "Loss"),
        "rank_loss": (dict(Label=_col(1, 0, 0.5, 1, 0, 1),
                           Left=_col(0.3, -1.2, 0.0, 2.0, 0.7, -0.4),
                           Right=_col(-0.5, 0.4, 0.0, 1.0, 0.7, 0.9)),
                      ("Left", "Right"), {}, ("Out",), "Out"),
        "margin_rank_loss": (dict(Label=_col(1, -1, 1, -1, 1, 1),
                                  X1=_col(0.3, -1.2, 0.0, 2.0, 0.9, -0.4),
                                  X2=_col(-0.5, 0.4, 0.1, 1.0, 0.8, 0.9)),
                             ("X1", "X2"), dict(margin=0.1),
                             ("Out", "Activated"), "Out"),
        "log_loss": (dict(Predicted=_col(0.1, 0.5, 0.9, 0.99, 0.3, 0.02),
                          Labels=_col(1, 0, 1, 0, 0, 1)),
                     ("Predicted",), dict(epsilon=1e-4), ("Loss",), "Loss"),
        "modified_huber_loss": (dict(X=_col(-2.0, -1.0, 0.0, 0.5, 1.0, 3.0),
                                     Y=_col(1, 1, 0, 1, 0, 1)),
                                ("X",), {}, ("IntermediateVal", "Out"),
                                "Out"),
    }


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_op_matches_jax(case):
    feeds, diff, attrs, outputs, loss_slot = CASES[case]
    op = case.replace("_weighted", "")
    assert pt.registry.OpRegistry.get(op, none_ok=True) is not None
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ins = {k: [fluid.layers.data(name=k, shape=list(v.shape),
                                     append_batch_size=False)]
               for k, v in feeds.items()}
        for k in diff:
            ins[k][0].stop_gradient = False
        helper = LayerHelper(op)
        outs = {o: [helper.create_tmp_variable("float32")] for o in outputs}
        helper.append_op(type=op, inputs=ins, outputs=outs, attrs=attrs)
        loss_out = outs[loss_slot][0]
        probe = fluid.layers.data(name="probe", shape=[N, 1],
                                  append_batch_size=False)
        loss = fluid.layers.mean(fluid.layers.elementwise_mul(
            loss_out, probe, axis=0))
        append_backward(loss)
    feeds = dict(feeds, probe=np.linspace(0.5, 2.0, N, dtype=np.float32)
                 .reshape(N, 1))
    fetch = ([v[0].name for v in outs.values()] + [loss.name]
             + [k + "@GRAD" for k in diff])
    want = fluid.Executor(fluid.CPUPlace()).run(main, feed=feeds,
                                                fetch_list=fetch)
    got = pt.Executor(pt.CPUPlace()).run(
        pt.Program.from_dict(main.to_dict()), feed=feeds, fetch_list=fetch)
    for name, g, w in zip(fetch, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
