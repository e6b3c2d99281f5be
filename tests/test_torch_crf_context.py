"""The ``linear_chain_crf`` and ``context_project`` ops of the port
against the JAX package's, on the CPU: one-op programs built with
paddle_tpu's layers, run by the JAX Executor and by the port's Executor
from ``Program.from_dict``, every output and the gradient of a weighted
mean of the output (the weights fed) to each differentiable input within
1e-5.  Ragged lengths include 1 and the full T; the context windows
start below, at and above 0 and are longer than T."""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.backward import append_backward
from paddle_tpu.layer_helper import LayerHelper
from test_torch_demos import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _data(name, shape, dtype="float32", grad=False):
    v = fluid.layers.data(name=name, shape=list(shape), dtype=dtype,
                          append_batch_size=False)
    v.stop_gradient = not grad
    return v


def _run_both(main, startup, feed, fetch):
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    want = [np.asarray(w) for w in exe.run(main, feed=feed,
                                           fetch_list=fetch)]
    got = pt.Executor(pt.CPUPlace()).run(pt.Program.from_dict(main.to_dict()),
                                         feed=feed, fetch_list=fetch,
                                         scope=pt.Scope())
    return got, want


def _check(got, want, fetch):
    for name, g, w in zip(fetch, got, want):
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


CRF_CASES = {
    "ragged": (6, [1, 6, 3, 2]),
    "all_length_1": (4, [1, 1, 1]),
    "all_full": (5, [5, 5]),
    "t_1": (1, [1, 1, 1]),
    "no_length": (5, None),
}


@pytest.mark.parametrize("case", list(CRF_CASES))
def test_linear_chain_crf_matches_the_jax_package(case):
    T, lens = CRF_CASES[case]
    B = len(lens) if lens is not None else 3
    D = 5
    rng = np.random.RandomState(7)
    feed = {"em": rng.randn(B, T, D).astype(np.float32),
            "tr": (0.5 * rng.randn(D + 2, D)).astype(np.float32),
            "lab": rng.randint(0, D, (B, T)).astype(np.int64),
            "w": rng.rand(B, 1).astype(np.float32)}
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        em = _data("em", (B, T, D), grad=True)
        tr = _data("tr", (D + 2, D), grad=True)
        lab = _data("lab", (B, T), "int64")
        ins = {"Emission": [em], "Transition": [tr], "Label": [lab]}
        if lens is not None:
            feed["len"] = np.asarray(lens, np.int32)
            ins["Length"] = [_data("len", (B,), "int32")]
        helper = LayerHelper("linear_chain_crf")
        outs = {s: helper.create_variable_for_type_inference("float32")
                for s in ("LogLikelihood", "Alpha", "EmissionExps",
                          "TransitionExps")}
        helper.append_op(type="linear_chain_crf", inputs=ins,
                         outputs={s: [v] for s, v in outs.items()})
        w = _data("w", (B, 1))
        append_backward(fluid.layers.mean(
            fluid.layers.elementwise_mul(outs["LogLikelihood"], w)))
    fetch = [v.name for v in outs.values()] + ["em@GRAD", "tr@GRAD"]
    got, want = _run_both(main, startup, feed, fetch)
    _check(got, want, fetch)
    # the negative log-likelihood of a distribution over paths
    assert (got[0] > 0).all()


def test_crf_layer_program_and_cost_match_the_jax_package():
    """fluid.layers.linear_chain_crf: the programs equal, the cost and the
    transition parameter's gradient within 1e-5 from the same weights."""
    B, T, D = 3, 4, 4
    rng = np.random.RandomState(3)
    feed = {"em": rng.randn(B, T, D).astype(np.float32),
            "lab": rng.randint(0, D, (B, T)).astype(np.int64),
            "len": np.asarray([4, 1, 2], np.int32)}
    progs = []
    for pkg in (fluid, pt):
        pkg.framework.reset_default_programs()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            em = pkg.layers.data(name="em", shape=[B, T, D], dtype="float32",
                                 append_batch_size=False)
            lab = pkg.layers.data(name="lab", shape=[B, T], dtype="int64",
                                  append_batch_size=False)
            ln = pkg.layers.data(name="len", shape=[B], dtype="int32",
                                 append_batch_size=False)
            ll = pkg.layers.linear_chain_crf(
                em, lab, ln, param_attr=pkg.ParamAttr(name="crfw"))
            loss = pkg.layers.mean(ll)
            pkg.backward.append_backward(loss)
        progs.append((main, startup, loss))
    (jmain, jstart, jloss), (pmain, _, ploss) = progs
    assert pmain.to_dict() == jmain.to_dict()
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.executor.Scope()
    with fluid.executor.scope_guard(scope):
        exe.run(jstart)
        want = exe.run(jmain, feed=feed, fetch_list=[jloss, "crfw@GRAD"])
        crfw = np.asarray(scope.get("crfw"))
    pscope = pt.Scope()
    pscope.load_numpy({"crfw": crfw}, "cpu")
    got = pt.Executor(pt.CPUPlace()).run(pmain, feed=feed, scope=pscope,
                                         fetch_list=[ploss, "crfw@GRAD"])
    _check(got, [np.asarray(w) for w in want], ["loss", "crfw@GRAD"])


CONTEXT_CASES = {
    "centred": (3, -1, [1, 5, 3]),
    "start_0": (3, 0, [5, 2, 1]),
    "start_above_0": (2, 2, [3, 5, 1]),
    "start_far_below": (2, -4, [2, 1, 5]),
    "len_above_t": (7, -3, [1, 5, 4]),
    "len_above_t_start_0": (8, 0, [5, 3, 1]),
    "no_length": (3, -2, None),
}


@pytest.mark.parametrize("case", list(CONTEXT_CASES))
def test_context_project_matches_the_jax_package(case):
    ctx_len, start, lens = CONTEXT_CASES[case]
    B, T, D = 3, 5, 4
    rng = np.random.RandomState(11)
    feed = {"x": rng.randn(B, T, D).astype(np.float32),
            "w": rng.rand(B, T, D * ctx_len).astype(np.float32)}
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = _data("x", (B, T, D), grad=True)
        ins = {"X": [x]}
        if lens is not None:
            feed["len"] = np.asarray(lens, np.int32)
            ins["Length"] = [_data("len", (B,), "int32")]
        helper = LayerHelper("context_project")
        out = helper.create_variable_for_type_inference("float32")
        helper.append_op(type="context_project", inputs=ins,
                         outputs={"Out": [out]},
                         attrs={"context_length": ctx_len,
                                "context_start": start})
        w = _data("w", (B, T, D * ctx_len))
        append_backward(fluid.layers.mean(
            fluid.layers.elementwise_mul(out, w)))
    fetch = [out.name, "x@GRAD"]
    got, want = _run_both(main, startup, feed, fetch)
    _check(got, want, fetch)
    assert got[0].shape == (B, T, D * ctx_len)
    if lens is not None:
        # a step past its row's length reaches no window: no gradient
        for b, n in enumerate(lens):
            assert not got[1][b, n:].any()
