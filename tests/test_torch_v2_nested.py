"""Nested (2-level) sequences and the config-equivalence pairs on the
port, each held against the JAX package: the port's copies of
``tests/test_nested_sequences.py`` and ``tests/test_network_compare.py``.

- The v2 feeder's nested layout: (B, S, T, D) beside ``@len`` and
  ``@sublen``, array for array the JAX package's.
- A recurrent_group over a nested input (each outer step pools one
  subsequence and mixes it with the outer memory), forward and
  reversed: ``paddle.infer`` equals the JAX package's within FWD_TOL of
  its largest magnitude and a numpy loop within the reference test's
  rtol 1e-4 / atol 1e-5.
- The nested document classifier: two SGD steps with Momentum give the
  JAX package's costs (LOSS_TOL) and parameters (PARAM_TOL), and the
  port's training with the reference test's Adam(0.03) passes its gate
  (the last three costs under half the first three).  The parity steps
  take Momentum: Adam's first steps move an element by about the
  learning rate whatever its gradient's size, so a gradient of rounding
  size moves a weight by up to 0.06 in either package.
- Each pair of formulations of one computation (mixed full-matrix
  projection and a bias-free fc, addto and an identity-projection mixed,
  repeat and self-concat, simple_lstm and its explicit composition,
  gated_unit_layer and its manual gate, the gru_group and the fused
  grumemory): with parameters equal by creation order, the two agree on
  the port (the reference test's rtol 1e-5 / atol 1e-6), and each equals
  the JAX package's output of the same formulation within FWD_TOL.
"""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.trainer_config_helpers as jtch
import paddle_tpu.v2 as jpaddle
import paddle_tpu_torch as pt
import paddle_tpu_torch.trainer_config_helpers as ptch
import paddle_tpu_torch.v2 as ppaddle
from paddle_tpu.v2.trainer import V2DataFeeder as JaxFeeder
from paddle_tpu_torch.v2.trainer import V2DataFeeder
from test_torch_demos import (LOSS_TOL, PARAM_TOL, close,  # noqa: F401
                              one_torch_thread)

FWD_TOL = 1e-5
PKGS = ((jtch, jpaddle), (ptch, ppaddle))


def _fresh(paddle):
    (fluid if paddle is jpaddle else pt).framework.reset_default_programs()
    paddle.layer._counter[0] = 0


def _create(paddle, out):
    if paddle is jpaddle:
        return paddle.parameters.create(out)
    return paddle.parameters.create(out, place=pt.CPUPlace())


def test_feeder_nested_layout():
    rows = [
        [[[[1, 1], [2, 2]], [[3, 3]]]],
        [[[[4, 4], [5, 5], [6, 6]]]],
    ]
    feeds = []
    for paddle, feeder in ((jpaddle, JaxFeeder), (ppaddle, V2DataFeeder)):
        t = paddle.data_type.dense_vector_sub_sequence(2)
        feeds.append(feeder([("x", t)], time_bucket=4).feed(rows))
    want, got = feeds
    assert sorted(got) == sorted(want) == ["x", "x@len", "x@sublen"]
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    assert got["x"].shape == (2, 2, 4, 2)
    np.testing.assert_array_equal(got["x@len"], [2, 1])
    np.testing.assert_array_equal(got["x@sublen"], [[2, 1], [3, 0]])
    ids = [[[[1, 2, 3], [4]]], [[[5], [6, 7], [8]]]]
    feeds = []
    for paddle, feeder in ((jpaddle, JaxFeeder), (ppaddle, V2DataFeeder)):
        t = paddle.data_type.integer_value_sub_sequence(10)
        feeds.append(feeder([("w", t)]).feed(ids))
    for k in feeds[0]:
        np.testing.assert_array_equal(feeds[1][k], feeds[0][k])


D, H = 3, 5


def _nested_group(t, p, reverse=False):
    x = p.layer.data(name="x",
                     type=p.data_type.dense_vector_sub_sequence(D))

    def outer_step(sub_seq):
        pooled = p.layer.pooling(input=sub_seq,
                                 pooling_type=p.pooling.Sum())
        mem = t.memory(name="h", size=H)
        return p.layer.fc(input=[pooled, mem], size=H, act="tanh",
                          name="h", bias_attr=False)

    return t.recurrent_group(step=outer_step,
                             input=t.SubsequenceInput(x), reverse=reverse)


@pytest.mark.parametrize("reverse", [False, True])
def test_nested_group_matches_jax_and_manual(reverse):
    rng = np.random.RandomState(0)
    subs = [rng.randn(2, D).astype(np.float32),
            rng.randn(3, D).astype(np.float32),
            rng.randn(1, D).astype(np.float32)]
    rows = [[[s.tolist() for s in subs]], [[subs[1].tolist()]]]
    outs, weights = [], None
    for t, p in PKGS:
        _fresh(p)
        out = _nested_group(t, p, reverse)
        params = _create(p, p.layer.last_seq(input=out))
        if weights is None:
            weights = {n: np.asarray(params.get(n)) for n in params.keys()}
        assert sorted(params.keys()) == sorted(weights)
        for n, w in weights.items():
            params.set(n, w)
        outs.append(np.asarray(p.infer(output_layer=out, parameters=params,
                                       input=rows)))
    want, got = outs
    close(got, want, FWD_TOL, "nested group")
    names = sorted(weights)
    w_x, w_h = weights[names[0]], weights[names[1]]
    if w_x.shape[0] != D:
        w_x, w_h = w_h, w_x
    order = list(range(len(subs)))[::-1] if reverse else range(len(subs))
    h = np.zeros(H, np.float32)
    for j in order:
        h = np.tanh(subs[j].sum(0) @ w_x + h @ w_h)
        np.testing.assert_allclose(got[0, j], h, rtol=1e-4, atol=1e-5)


NCLASS, DD, HH = 3, 4, 10


def _doc_classifier(t, p):
    x = p.layer.data(name="x",
                     type=p.data_type.dense_vector_sub_sequence(DD))
    y = p.layer.data(name="y", type=p.data_type.integer_value(NCLASS))

    def outer_step(sub_seq):
        pooled = p.layer.pooling(input=sub_seq,
                                 pooling_type=p.pooling.Max())
        mem = t.memory(name="h", size=HH)
        return p.layer.fc(input=[pooled, mem], size=HH, act="tanh",
                          name="h")

    seq_h = t.recurrent_group(step=outer_step, input=x)
    last = p.layer.last_seq(input=seq_h)
    pred = p.layer.fc(input=last, size=NCLASS, act="softmax")
    return p.layer.classification_cost(input=pred, label=y)


def _docs(seed, n):
    rng = np.random.RandomState(seed)
    protos = np.random.RandomState(1).randn(NCLASS, DD).astype(
        np.float32) * 2
    rows = []
    for _ in range(n):
        k = int(rng.randint(0, NCLASS))
        doc = []
        for _ in range(int(rng.randint(1, 4))):
            steps = int(rng.randint(2, 5))
            doc.append((protos[k] + 0.2 * rng.randn(steps, DD)).astype(
                np.float32).tolist())
        rows.append((doc, k))
    return rows


def _sgd(t, p, cost, opt):
    params = _create(p, cost)
    return params, p.trainer.SGD(cost=cost, parameters=params,
                                 update_equation=opt(p))


def _costs(p, sgd, reader, passes=1):
    costs = []
    sgd.train(reader, num_passes=passes,
              event_handler=lambda e: costs.append(e.cost)
              if isinstance(e, p.event.EndIteration) else None)
    return costs


def test_nested_group_sgd_steps_match_jax():
    rows = _docs(2, 16)
    reader = lambda: iter([rows[:8], rows[8:]])  # noqa: E731
    runs = []
    for t, p in PKGS:
        _fresh(p)
        runs.append(_sgd(t, p, _doc_classifier(t, p), lambda p: (
            p.optimizer.Momentum(momentum=0.9, learning_rate=0.03))))
    (jparams, jsgd), (pparams, psgd) = runs
    for n in jparams.keys():
        pparams.set(n, np.asarray(jparams.get(n)))
    want = _costs(jpaddle, jsgd, reader)
    got = _costs(ppaddle, psgd, reader)
    for g, w in zip(got, want):
        assert abs(g - w) <= LOSS_TOL * abs(w), (g, w)
    for n in jparams.keys():
        close(pparams.get(n), np.asarray(jparams.get(n)), PARAM_TOL, n)


def test_nested_group_trains():
    _fresh(ppaddle)
    params, sgd = _sgd(ptch, ppaddle, _doc_classifier(ptch, ppaddle),
                       lambda p: p.optimizer.Adam(learning_rate=0.03))
    rows = _docs(3, 40)
    costs = _costs(ppaddle, sgd, ppaddle.batch(lambda: iter(rows), 8),
                   passes=8)
    assert np.mean(costs[-3:]) < 0.5 * np.mean(costs[:3]), (
        costs[:3], costs[-3:])


# ---------------------------------------------------------------------------
# the config-equivalence pairs
# ---------------------------------------------------------------------------


def _x(dim=6, n=4, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(dim).astype(np.float32),) for _ in range(n)]


def _seq_rows(dim, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(int(rng.randint(2, 6)), dim).astype(np.float32),)
            for _ in range(3)]


def _seq_data(t, p, dim):
    x = t.data_layer(name="x", size=dim)
    x.input_type = p.data_type.dense_vector_sequence(dim)
    return x


def _mixed_vs_fc(t, p):
    def via_mixed():
        x = t.data_layer(name="x", size=6)
        with t.mixed_layer(size=3) as m:
            m += t.full_matrix_projection(input=x)
        return m._lo

    def via_fc():
        x = t.data_layer(name="x", size=6)
        return t.fc_layer(input=x, size=3, act=t.LinearActivation(),
                          bias_attr=False)

    return via_mixed, via_fc


def _addto_vs_mixed(t, p):
    def via_addto():
        return t.addto_layer(input=[t.data_layer(name="a", size=5),
                                    t.data_layer(name="b", size=5)])

    def via_mixed():
        a = t.data_layer(name="a", size=5)
        b = t.data_layer(name="b", size=5)
        with t.mixed_layer(size=5) as m:
            m += t.identity_projection(input=a)
            m += t.identity_projection(input=b)
        return m._lo

    return via_addto, via_mixed


def _repeat_vs_concat(t, p):
    def via_repeat():
        return t.repeat_layer(input=t.data_layer(name="x", size=4),
                              num_repeats=2)

    def via_concat():
        x = t.data_layer(name="x", size=4)
        return t.concat_layer(input=[x, x])

    return via_repeat, via_concat


def _simple_lstm_vs_explicit(t, p):
    def via_helper():
        return t.last_seq(input=t.simple_lstm(input=_seq_data(t, p, 6),
                                              size=4))

    def via_explicit():
        proj = t.fc_layer(input=_seq_data(t, p, 6), size=16,
                          act=t.LinearActivation())
        return t.last_seq(input=t.lstmemory(input=proj, size=4))

    return via_helper, via_explicit


def _gated_vs_manual(t, p):
    def via_gated():
        return t.gated_unit_layer(input=t.data_layer(name="x", size=6),
                                  size=3, act=t.TanhActivation())

    def via_manual():
        x = t.data_layer(name="x", size=6)
        proj = t.fc_layer(input=x, size=3, act=t.TanhActivation())
        gate = t.fc_layer(input=x, size=3, act=t.SigmoidActivation())
        return _elementwise_mul(p, proj, gate)

    return via_gated, via_manual


def _elementwise_mul(p, a, b):
    lib = pt if p is ppaddle else fluid

    def build(ctx, x, y):
        return lib.layers.elementwise_mul(getattr(x, "var", x),
                                          getattr(y, "var", y))

    return p.layer.LayerOutput("manual_gate", [a, b], build, size=3)


def _gru_group_vs_fused(t, p):
    def via_group():
        return t.last_seq(input=t.gru_group(input=_seq_data(t, p, 12),
                                            size=4))

    def via_fused():
        return t.last_seq(input=t.grumemory(input=_seq_data(t, p, 12),
                                            size=4))

    return via_group, via_fused


PAIRS = {
    "mixed_full_matrix_projection_equals_fc": (_mixed_vs_fc, _x()),
    "addto_equals_identity_projection_mixed": (
        _addto_vs_mixed,
        [(a[0][:5], b[0][:5]) for a, b in zip(_x(seed=1, n=3),
                                                _x(seed=2, n=3))]),
    "repeat_layer_equals_self_concat": (_repeat_vs_concat,
                                        _x(dim=4, n=3)),
    "simple_lstm_equals_explicit_composition": (_simple_lstm_vs_explicit,
                                                _seq_rows(6, 2)),
    "gated_unit_equals_manual_gate": (_gated_vs_manual, _x()),
    "gru_group_equals_fused_grumemory": (_gru_group_vs_fused,
                                         _seq_rows(12, 3)),
}


def _pair_outputs(t, p, pair, rows):
    """The pair's two outputs on ``rows`` with parameters set pairwise by
    creation order from one seeded stream."""
    built = []
    for build in pair(t, p):
        _fresh(p)
        out = build()
        built.append((out, _create(p, out)))
    names = [params.keys() for _, params in built]
    assert len(names[0]) == len(names[1]), names
    rng = np.random.RandomState(7)
    for na, nb in zip(*names):
        wa, wb = built[0][1].get(na), built[1][1].get(nb)
        assert wa.size == wb.size, (na, wa.shape, nb, wb.shape)
        w = rng.uniform(-0.5, 0.5, wa.size).astype(np.float32)
        built[0][1].set(na, w.reshape(wa.shape))
        built[1][1].set(nb, w.reshape(wb.shape))
    return [np.asarray(p.infer(output_layer=out, parameters=params,
                               input=rows)) for out, params in built]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_network_pair(name):
    pair, rows = PAIRS[name]
    want = _pair_outputs(jtch, jpaddle, pair, rows)
    got = _pair_outputs(ptch, ppaddle, pair, rows)
    np.testing.assert_allclose(got[0], got[1], rtol=1e-5, atol=1e-6)
    for g, w in zip(got, want):
        close(g, w, FWD_TOL, name)
