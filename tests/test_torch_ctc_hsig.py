"""CTC, hierarchical sigmoid, the factorization machine and NCE on the
port (``paddle_tpu_torch/ops/ctc_ops.py``, ``nce`` in
``ops/nn_extra_ops.py``) against the JAX package on the CPU, mirroring
``tests/test_ctc_hsig_fm.py``.

``warpctc``, ``hierarchical_sigmoid`` and ``factorization_machine``: the
loss and its gradients through both Executors (``run_op``), and their
layers' programs equal (``both``), with CTC's edge cases named: repeated
labels, an empty label, an infeasible alignment (the recursion's -1e30
states keep the loss large and the gradient finite, on both sides) and
``norm_by_times``.  ``nce`` draws its negatives inside the op, and jax's
streams are not torch's: the port's cost (``nce_cost``) and its grad rule
are held to the JAX op's own values at the JAX op's own SampleLabels
(the JAX lowering under ``jax.vjp`` with a fixed key), and the port's
draw to its contract: uniform in [0, V) (a seeded chi-square), shared
across the batch.

Tolerance: 1e-5 of the JAX tensor's largest magnitude.
"""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.framework import Program as JaxProgram
from paddle_tpu.registry import LowerContext as JaxLowerContext
from paddle_tpu.registry import OpRegistry as JaxRegistry
from paddle_tpu_torch.autodiff import _OpProxy
from paddle_tpu_torch.ops.nn_extra_ops import nce_cost
from paddle_tpu_torch.registry import LowerContext, OpRegistry
from test_torch_control_flow import both, data, run_op
from test_torch_demos import one_torch_thread  # noqa: F401
from test_torch_gru import close
from test_torch_op_tail import single

TOL = 1e-5


def ctc_feeds(rng, B=4, T=12, C=7, S=5, label_lens=(5, 3, 4, 1),
              logit_lens=(12, 10, 12, 8), repeats=False):
    labels = np.zeros((B, S), np.int64)
    for b in range(B):
        labels[b, :label_lens[b]] = (
            rng.randint(1, 3, label_lens[b]) if repeats
            else rng.randint(1, C, label_lens[b]))
    return {"lg": rng.randn(B, T, C).astype(np.float32), "lb": labels,
            "tl": np.asarray(logit_lens, np.int64).reshape(-1, 1),
            "ll": np.asarray(label_lens, np.int64).reshape(-1, 1)}


@pytest.mark.parametrize("case", ["plain", "repeats", "empty_label",
                                  "infeasible", "norm_by_times"])
def test_warpctc(rng, case):
    """The CTC loss and the logits' gradient.  ``infeasible``: row 0's
    labels (five repeats of one class) need 9 steps and get 4."""
    kw = {}
    if case == "repeats":
        kw = dict(repeats=True)
    elif case == "empty_label":
        kw = dict(label_lens=(2, 0, 3, 0))
    elif case == "infeasible":
        kw = dict(logit_lens=(4, 10, 12, 8))
    feeds = ctc_feeds(rng, **kw)
    if case == "infeasible":
        feeds["lb"][0] = 3
    got = single("warpctc", feeds,
                 {"Logits": "lg", "Label": "lb", "LogitsLength": "tl",
                  "LabelLength": "ll"}, {"Loss": ("float32", (4, 1))},
                 {"blank": 0, "norm_by_times": case == "norm_by_times"},
                 grads_of=["lg"])
    loss = next(iter(got.values()))
    assert np.isfinite(got["lg@GRAD"]).all()
    if case == "infeasible":
        assert loss[0, 0] > 1e29


def test_warpctc_layer_trains(rng):
    """tests/test_ctc_hsig_fm.py's alignment-free model on both packages:
    the programs equal, three Adam steps agree."""
    B, T, C, S = 8, 8, 4, 2
    protos = rng.randn(3, T, C).astype(np.float32)
    ks = rng.randint(0, 3, B)
    feeds = {"x": protos[ks] + 0.2 * rng.randn(B, T, C).astype(np.float32),
             "lb": np.stack([(ks % 3) + 1, ((ks + 1) % 3) + 1],
                            1).astype(np.int64)}

    def case(fl):
        x = fl.layers.data(name="x", shape=[T, C], dtype="float32")
        lb = fl.layers.data(name="lb", shape=[S], dtype="int64")
        h = fl.layers.fc(input=x, size=16, num_flatten_dims=2, act="tanh")
        logits = fl.layers.fc(input=h, size=C, num_flatten_dims=2)
        loss = fl.layers.mean(fl.layers.warpctc(logits, lb))
        fl.optimizer.Adam(learning_rate=0.02).minimize(loss)
        return [loss]

    both(case, feeds, steps=3, tol=1e-4)


@pytest.mark.parametrize("num_classes", [2, 7, 8, 33])
def test_hsigmoid(rng, num_classes):
    """The layer's program on both packages, and the cost's gradients in
    X, W and the bias."""
    B, D = 5, 4
    feeds = {"x": rng.randn(B, D).astype(np.float32),
             "lab": rng.randint(0, num_classes, (B, 1)).astype(np.int64)}

    def case(fl):
        x = data(fl, "x", (B, D), grad=True)
        lab = data(fl, "lab", (B, 1), "int64")
        return [fl.layers.hsigmoid(x, lab, num_classes)]

    both(case, feeds)

    def build():
        return case(fluid)

    run_op(build, feeds, grads_of=["x"])


def test_factorization_machine(rng):
    B, D, K = 5, 7, 3
    feeds = {"x": rng.randn(B, D).astype(np.float32)}

    def case(fl):
        return [fl.layers.factorization_machine(data(fl, "x", (B, D),
                                                     grad=True), K)]

    both(case, feeds)
    run_op(lambda: case(fluid), feeds, grads_of=["x"])


# ---------------------------------------------------------------------------
# nce
# ---------------------------------------------------------------------------


class _FixedKey:
    def next_key(self):
        return jax.random.PRNGKey(7)


NCE_ATTRS = {"num_neg_samples": 6, "num_total_classes": 40}


def jax_nce(x, label, w, b):
    """The JAX op's lowering with a fixed key as a function of (x, w, b):
    ((Cost, SampleLogits), SampleLabels), for vjp with an aux."""
    block = JaxProgram().global_block()
    fop = block.append_op(
        type="nce", inputs={"Input": ["x"], "Label": ["label"],
                            "Weight": ["w"], "Bias": ["b"]},
        outputs={"Cost": ["cost"], "SampleLogits": ["logits"],
                 "SampleLabels": ["ids"]}, attrs=NCE_ATTRS)

    def run(x_, w_, b_):
        values = {"x": x_, "label": label, "w": w_, "b": b_}
        JaxRegistry.get("nce").lower(JaxLowerContext(fop, values,
                                                     rng=_FixedKey()))
        return (values["cost"], values["logits"]), values["ids"]

    return run


def test_nce_against_jax_samples(rng):
    """The port's cost and grad rule at the JAX op's own samples: Cost,
    SampleLogits, and the Input, Weight and Bias gradients of random
    cotangents of both."""
    B, D, V = 5, 4, NCE_ATTRS["num_total_classes"]
    x = rng.randn(B, D).astype(np.float32)
    w = rng.randn(V, D).astype(np.float32)
    b = rng.randn(V).astype(np.float32)
    label = rng.randint(0, V, (B, 2)).astype(np.int32)
    g = rng.randn(B, 1).astype(np.float32)
    gl = rng.randn(B, 8).astype(np.float32)
    run = jax_nce(x, jnp.asarray(label), w, b)
    (cost, logits), vjp, ids = _vjp_with_aux(run, x, w, b)
    gx, gw, gb = vjp((jnp.asarray(g), jnp.asarray(gl)))
    ids = np.asarray(ids)
    assert (ids[:, :2] == label).all()
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in
         dict(x=x, w=w, b=b, ids=ids.astype(np.int64), g=g, gl=gl).items()}
    got_cost, got_logits = nce_cost(t["x"], t["w"], t["b"], t["ids"], 6, V)
    close(got_cost, cost, TOL, "Cost")
    close(got_logits, logits, TOL, "SampleLogits")
    # the grad rule, on a grad op reading these samples
    gop = _OpProxy(
        "nce_grad",
        {"Input": ["x"], "Weight": ["w"], "Bias": ["b"],
         "SampleLabels": ["ids"], "Cost@GRAD": ["g"],
         "SampleLogits@GRAD": ["gl"]},
        {"Input@GRAD": ["gx"], "Weight@GRAD": ["gw"], "Bias@GRAD": ["gb"]},
        {"__fwd_attrs__": dict(NCE_ATTRS)}, None)
    values = dict(t)
    OpRegistry.get("nce_grad").lower(LowerContext(gop, values))
    for name, want in (("gx", gx), ("gw", gw), ("gb", gb)):
        close(values[name], want, TOL, name)


def _vjp_with_aux(run, x, w, b):
    out, vjp, aux = jax.vjp(run, jnp.asarray(x), jnp.asarray(w),
                            jnp.asarray(b), has_aux=True)
    return out, vjp, aux

def test_nce_program_draws(rng):
    """The port's nce in a program with its gradient: the negatives are
    shared across the batch and uniform in [0, V) (a chi-square over 6000
    draws), the labels lead each row, the Cost is nce_cost at the drawn
    SampleLabels and the Input gradient its autograd gradient there."""
    B, D, V, neg = 3, 4, 10, 6000
    feeds = {"x": rng.randn(B, D).astype(np.float32),
             "label": rng.randint(0, V, (B, 1)).astype(np.int64)}
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = data(pt, "x", (B, D), grad=True)
        label = data(pt, "label", (B, 1), "int64")
        helper = pt.layer_helper.LayerHelper("nce")
        w = helper.create_parameter(None, [V, D], "float32")
        outs = {s: helper.create_tmp_variable(dt, shape) for s, (dt, shape) in
                (("Cost", ("float32", (B, 1))),
                 ("SampleLogits", ("float32", (B, 1 + neg))),
                 ("SampleLabels", ("int64", (B, 1 + neg))))}
        helper.append_op(type="nce", inputs={"Input": [x], "Label": [label],
                                             "Weight": [w]},
                         outputs={k: [v] for k, v in outs.items()},
                         attrs={"num_neg_samples": neg,
                                "num_total_classes": V})
        pt.append_backward(pt.layers.mean(outs["Cost"]))
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    cost, ids, gx = exe.run(main, feed=feeds,
                            fetch_list=[outs["Cost"], outs["SampleLabels"],
                                        "x@GRAD"], scope=scope)
    ids = np.asarray(ids)
    assert (ids[:, 0] == feeds["label"][:, 0]).all()
    assert (ids[1:, 1:] == ids[0, 1:]).all()
    counts = np.bincount(ids[0, 1:], minlength=V)
    assert counts.shape == (V,)
    chi2 = float(((counts - neg / V) ** 2 / (neg / V)).sum())
    assert chi2 < 27.88, chi2   # p = 0.001 at 9 degrees of freedom
    wt = scope.values[w.name].clone()
    xt = torch.from_numpy(feeds["x"]).requires_grad_(True)
    want, _ = nce_cost(xt, wt, None, torch.from_numpy(ids), neg, V)
    close(cost, want.detach(), TOL, "Cost")
    (want_gx,) = torch.autograd.grad(want.mean(), [xt])
    close(gx, want_gx, TOL, "x@GRAD")
