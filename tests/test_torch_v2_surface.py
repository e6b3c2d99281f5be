"""The paddle.v2 surface and the v1 constructors under it, on the port
against the JAX package, on the CPU, at small sizes.

Each case builds one net with either package's ``trainer_config_helpers``
and ``v2`` modules (the same function, given the package), then:

- the Programs of ``paddle.parameters.create`` equal (``to_dict``
  through JSON), parameter names and shapes too;
- with every parameter set to the same seeded values in both,
  ``paddle.infer`` on the same rows gives the JAX package's outputs,
  within FWD_TOL of their largest magnitude (float32 ops in another
  order), integer outputs exactly.  ``nce`` draws its negative samples
  from each package's generator: its case checks the Program and a
  finite cost.

Beside the cases: every name of the JAX package's v1 ``layers.__all__``
and ``networks.__all__`` resolves under ``paddle_tpu_torch.v2.layer`` /
``.networks``; ``parse_network``; the v2 optimizers (Programs, two steps,
``server_config``); ``v2.op``, ``v2.evaluator``, ``config_base``,
``v2.fluid``, ``v2.image`` and ``v2.plot``.
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
from test_torch_demos import (LOSS_TOL, PARAM_TOL, close,  # noqa: F401
                              one_torch_thread, program_dict)

FWD_TOL = 1e-5
B = 4


def _reset(paddle):
    paddle.layer._counter[0] = 0


def build_both(case):
    """(JAX (outputs, Parameters), port (outputs, Parameters)) of
    ``case(tch, paddle)``, the Programs checked equal and the port's
    parameters set to the JAX package's, both seeded."""
    fluid.framework.reset_default_programs()
    _reset(jpaddle)
    jouts = case(jtch, jpaddle)
    jouts = list(jouts) if isinstance(jouts, (list, tuple)) else [jouts]
    jparams = jpaddle.parameters.create(
        jpaddle.topology.Topology(output_layers=jouts))
    pt.framework.reset_default_programs()
    _reset(ppaddle)
    pouts = case(ptch, ppaddle)
    pouts = list(pouts) if isinstance(pouts, (list, tuple)) else [pouts]
    pparams = ppaddle.parameters.create(
        ppaddle.topology.Topology(output_layers=pouts), place=pt.CPUPlace())
    assert (program_dict(pparams.topology.main_program)
            == program_dict(jparams.topology.main_program))
    assert [(p.name, tuple(p.shape)) for p in
            pparams.topology.main_program.all_parameters()] == [
        (p.name, tuple(p.shape)) for p in
        jparams.topology.main_program.all_parameters()]
    rng = np.random.RandomState(7)
    for n in jparams.keys():
        # a batch norm's statistics among them: its variance positive
        lo, hi = (0.5, 1.5) if n.startswith("batch_norm") else (-0.5, 0.5)
        w = rng.uniform(lo, hi, jparams.get_shape(n)).astype(np.float32)
        jparams.set(n, w)
        pparams.set(n, w)
    return (jouts, jparams), (pouts, pparams)


def check_case(case, rows):
    (jouts, jparams), (pouts, pparams) = build_both(case)
    want = jpaddle.infer(output_layer=jouts, parameters=jparams, input=rows)
    got = ppaddle.infer(output_layer=pouts, parameters=pparams, input=rows)
    want = want if isinstance(want, list) else [want]
    got = got if isinstance(got, list) else [got]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert np.isfinite(g).all(), i
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(np.asarray(g), w)
        else:
            close(g, w, FWD_TOL, f"output {i}")
    return got


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------

def dense(n, dim, lo=-1.0, hi=1.0, seed=0):
    r = np.random.RandomState(seed)
    return [r.uniform(lo, hi, dim).astype(np.float32) for _ in range(n)]


def seqs(n, dim, seed=0, lens=(1, 7)):
    r = np.random.RandomState(seed)
    return [r.randn(int(r.randint(*lens)), dim).astype(np.float32)
            for _ in range(n)]


def id_seqs(n, vocab, seed=0, lens=(1, 7)):
    r = np.random.RandomState(seed)
    return [r.randint(0, vocab, int(r.randint(*lens))).tolist()
            for _ in range(n)]


def nested(n, dim, seed=0):
    r = np.random.RandomState(seed)
    return [[r.randn(int(r.randint(1, 4)), dim).astype(np.float32).tolist()
             for _ in range(int(r.randint(1, 4)))] for _ in range(n)]


def rows_of(*cols):
    return list(zip(*cols))


def x_of(p, dim=6, name="x"):
    return p.layer.data(name=name, type=p.data_type.dense_vector(dim))


def seq_of(p, dim=6, name="s"):
    return p.layer.data(name=name,
                        type=p.data_type.dense_vector_sequence(dim))


# ---------------------------------------------------------------------------
# the v1 constructors, the lifted paths, the v2 layers and networks
# ---------------------------------------------------------------------------


def _fc(t, x, size, act=None):
    return t.fc_layer(input=x, size=size, act=act or t.LinearActivation())


CASES = {
    "batch_norm_layer": (
        lambda t, p: t.batch_norm_layer(input=_fc(t, x_of(p), 6)),
        lambda: rows_of(dense(B, 6))),
    "dropout_layer": (
        lambda t, p: t.dropout_layer(input=_fc(t, x_of(p), 6),
                                     dropout_rate=0.3),
        lambda: rows_of(dense(B, 6))),
    "concat_layer": (
        lambda t, p: t.concat_layer(input=[_fc(t, x_of(p), 3),
                                           _fc(t, x_of(p, 4, "y"), 5)]),
        lambda: rows_of(dense(B, 6), dense(B, 4, seed=1))),
    "concat_layer_projection": (
        lambda t, p: t.concat_layer(input=[
            x_of(p), t.identity_projection(input=x_of(p, 4, "y"))]),
        lambda: rows_of(dense(B, 6), dense(B, 4, seed=1))),
    "lstmemory": (
        lambda t, p: t.lstmemory(input=_fc(t, seq_of(p), 16)),
        lambda: rows_of(seqs(B, 6))),
    "lstmemory_reverse": (
        lambda t, p: t.lstmemory(input=_fc(t, seq_of(p), 16), reverse=True),
        lambda: rows_of(seqs(B, 6))),
    "recurrent_layer": (
        lambda t, p: t.recurrent_layer(input=_fc(t, seq_of(p), 4)),
        lambda: rows_of(seqs(B, 6))),
    "recurrent_layer_reverse": (
        lambda t, p: t.recurrent_layer(input=_fc(t, seq_of(p), 4),
                                       reverse=True),
        lambda: rows_of(seqs(B, 6))),
    "last_first_seq": (
        lambda t, p: [t.last_seq(input=_fc(t, seq_of(p), 3)),
                      t.first_seq(input=_fc(t, seq_of(p), 3))],
        lambda: rows_of(seqs(B, 6))),
    "maxid_layer": (
        lambda t, p: t.maxid_layer(input=_fc(t, x_of(p), 5,
                                             t.SoftmaxActivation())),
        lambda: rows_of(dense(B, 6))),
    "cos_sim": (
        lambda t, p: t.cos_sim(a=_fc(t, x_of(p), 4), b=_fc(t, x_of(p), 4),
                               scale=2.0),
        lambda: rows_of(dense(B, 6))),
    "crf_decoding_layer": (
        lambda t, p: t.crf_decoding_layer(input=_fc(t, seq_of(p), 5),
                                          size=5),
        lambda: rows_of(seqs(B, 6))),
    "ctc_layer": (
        lambda t, p: t.ctc_layer(
            input=_fc(t, seq_of(p), 5, t.SoftmaxActivation()),
            label=p.layer.data(
                name="l", type=p.data_type.integer_value_sequence(4)),
            size=5),
        lambda: rows_of(seqs(B, 6, lens=(4, 8)),
                        id_seqs(B, 4, lens=(1, 3)))),
    "warp_ctc_layer": (
        lambda t, p: t.warp_ctc_layer(
            input=_fc(t, seq_of(p), 5),
            label=p.layer.data(
                name="l", type=p.data_type.integer_value_sequence(4)),
            size=5, blank=4, norm_by_times=True),
        lambda: rows_of(seqs(B, 6, lens=(4, 8)),
                        id_seqs(B, 4, lens=(1, 3)))),
    "hsigmoid_layer": (
        lambda t, p: t.hsigmoid_layer(
            input=_fc(t, x_of(p), 4),
            label=p.layer.data(name="l", type=p.data_type.integer_value(8)),
            num_classes=8),
        lambda: rows_of(dense(B, 6), [1, 7, 3, 0])),
    "dotmul_projection": (
        lambda t, p: t.mixed_layer(
            size=6, input=[t.dotmul_projection(input=x_of(p))]),
        lambda: rows_of(dense(B, 6))),
    "table_projection": (
        lambda t, p: t.mixed_layer(size=4, input=[t.table_projection(
            input=p.layer.data(
                name="w", type=p.data_type.integer_value_sequence(20)),
            size=4)]),
        lambda: rows_of(id_seqs(B, 20))),
    "trans_full_matrix_projection": (
        lambda t, p: t.mixed_layer(size=3, input=[
            t.trans_full_matrix_projection(input=x_of(p), size=3)]),
        lambda: rows_of(dense(B, 6))),
    "factorization_machine": (
        lambda t, p: t.factorization_machine(input=x_of(p), factor_size=3),
        lambda: rows_of(dense(B, 6))),
    "get_output_layer": (
        lambda t, p: t.get_output_layer(input=_fc(t, x_of(p), 3),
                                        arg_name="out"),
        lambda: rows_of(dense(B, 6))),
    "hinge_cost": (
        lambda t, p: t.hinge_cost(input=_fc(t, x_of(p), 1),
                                  label=x_of(p, 1, "l")),
        lambda: rows_of(dense(B, 6),
                        [np.float32([v]) for v in (0, 1, 1, 0)])),
    "huber_regression_cost": (
        lambda t, p: t.huber_regression_cost(input=_fc(t, x_of(p), 1),
                                             label=x_of(p, 1, "l"),
                                             delta=0.3),
        lambda: rows_of(dense(B, 6), dense(B, 1, seed=2))),
    "multi_binary_label_cross_entropy": (
        lambda t, p: t.multi_binary_label_cross_entropy(
            input=_fc(t, x_of(p), 4), label=x_of(p, 4, "l")),
        lambda: rows_of(dense(B, 6), [np.float32(r > 0) for r in
                                      dense(B, 4, seed=3)])),
    "sum_cost": (
        lambda t, p: t.sum_cost(input=_fc(t, x_of(p), 3)),
        lambda: rows_of(dense(B, 6))),
    "interpolation_layer": (
        lambda t, p: t.interpolation_layer(
            input=[_fc(t, x_of(p), 3), _fc(t, x_of(p), 3)],
            weight=_fc(t, x_of(p), 1, t.SigmoidActivation())),
        lambda: rows_of(dense(B, 6))),
    "pad_layer": (
        lambda t, p: t.pad_layer(
            input=t.img_conv_layer(input=x_of(p, 48), num_channels=3,
                                   filter_size=3, num_filters=2, padding=1),
            pad_c=[1, 0], pad_h=[0, 1], pad_w=[1, 1]),
        lambda: rows_of(dense(B, 48))),
    "power_layer": (
        lambda t, p: [t.power_layer(input=_fc(t, x_of(p), 3,
                                              t.SigmoidActivation()),
                                    power=2.5),
                      t.power_layer(input=_fc(t, x_of(p), 3,
                                              t.SigmoidActivation()),
                                    weight=_fc(t, x_of(p), 1))],
        lambda: rows_of(dense(B, 6))),
    "repeat_layer": (
        lambda t, p: t.repeat_layer(input=_fc(t, x_of(p), 3),
                                    num_repeats=3),
        lambda: rows_of(dense(B, 6))),
    "slope_intercept_layer": (
        lambda t, p: t.slope_intercept_layer(input=x_of(p), slope=-2.0,
                                             intercept=0.5),
        lambda: rows_of(dense(B, 6))),
    "trans_layer": (
        lambda t, p: t.trans_layer(input=_fc(t, x_of(p), 3)),
        lambda: rows_of(dense(B, 6))),
    # the paths behind the six lifted raises
    "img_conv_layer_trans": (
        lambda t, p: t.img_conv_layer(input=x_of(p, 48), num_channels=3,
                                      filter_size=3, num_filters=2,
                                      padding=1, trans=True),
        lambda: rows_of(dense(B, 48))),
    "pooling_stride": (
        lambda t, p: t.pooling_layer(input=_fc(t, seq_of(p), 3), stride=2,
                                     pooling_type=t.AvgPooling()),
        lambda: rows_of(seqs(B, 6))),
    "pooling_max_index": (
        lambda t, p: t.pooling_layer(
            input=_fc(t, seq_of(p), 3),
            pooling_type=t.MaxPooling(output_max_index=True)),
        lambda: rows_of(seqs(B, 6))),
    "pooling_nested": (
        lambda t, p: [t.pooling_layer(input=p.layer.data(
            name="n", type=p.data_type.dense_vector_sub_sequence(3)),
            agg_level=t.AggregateLevel.TO_SEQUENCE),
            t.pooling_layer(input=p.layer.data(
                name="n", type=p.data_type.dense_vector_sub_sequence(3)),
                pooling_type=t.SumPooling())],
        lambda: rows_of(nested(B, 3))),
    "pooling_nested_stride": (
        lambda t, p: t.pooling_layer(input=p.layer.data(
            name="n", type=p.data_type.dense_vector_sub_sequence(3)),
            stride=2),
        lambda: rows_of(nested(B, 3))),
    "expand_into_nested": (
        lambda t, p: [
            t.expand_layer(input=x_of(p, 3), expand_as=p.layer.data(
                name="n", type=p.data_type.dense_vector_sub_sequence(3))),
            t.expand_layer(
                input=t.pooling_layer(
                    input=p.layer.data(
                        name="n",
                        type=p.data_type.dense_vector_sub_sequence(3)),
                    agg_level=t.AggregateLevel.TO_SEQUENCE),
                expand_as=p.layer.data(
                    name="n", type=p.data_type.dense_vector_sub_sequence(3)),
                expand_level=t.ExpandLevel.FROM_SEQUENCE)],
        lambda: rows_of(dense(B, 3), nested(B, 3, seed=1))),
    "identity_projection_offset": (
        lambda t, p: t.mixed_layer(size=3, input=[
            t.identity_projection(input=x_of(p), offset=2)]),
        lambda: rows_of(dense(B, 6))),
    "fc_nested": (
        lambda t, p: p.layer.fc(input=p.layer.data(
            name="n", type=p.data_type.dense_vector_sub_sequence(3)),
            size=4, act=p.activation.Tanh()),
        lambda: rows_of(nested(B, 3))),
    # the v2 layers
    "v2_image_layers": (
        lambda t, p: p.layer.img_pool(input=p.layer.batch_norm(
            input=p.layer.img_conv(
                input=t.img_conv_layer(input=x_of(p, 48), num_channels=3,
                                       filter_size=3, num_filters=4,
                                       padding=1),
                filter_size=3, num_filters=2, padding=1,
                act=p.activation.Relu()), act=p.activation.Relu()),
            pool_size=2, stride=2, pool_type=p.pooling.Avg()),
        lambda: rows_of(dense(B, 48))),
    "v2_sequence_layers": (
        lambda t, p: [
            p.layer.pooling(input=p.layer.lstmemory(
                input=p.layer.fc(input=seq_of(p), size=8), reverse=True),
                pooling_type=p.pooling.Avg()),
            p.layer.last_seq(input=p.layer.simple_rnn(
                input=seq_of(p), size=3, reverse=True)),
            p.layer.first_seq(input=p.layer.dropout(
                input=p.layer.fc(input=seq_of(p), size=3),
                dropout_rate=0.5)),
            p.layer.max_id(input=p.layer.fc(input=x_of(p), size=4)),
            p.layer.concat(input=[p.layer.fc(input=x_of(p), size=2),
                                  p.layer.fc(input=x_of(p), size=3)])],
        lambda: rows_of(seqs(B, 6), dense(B, 6, seed=1))),
    # the networks
    "img_conv_group": (
        lambda t, p: p.networks.img_conv_group(
            input=x_of(p, 3 * 8 * 8), num_channels=3, pool_size=2,
            pool_stride=2, conv_num_filter=[4, 2], conv_with_batchnorm=True),
        lambda: rows_of(dense(B, 192))),
    "img_conv_bn_pool": (
        lambda t, p: t.img_conv_bn_pool(input=x_of(p, 48), filter_size=3,
                                        num_filters=2, pool_size=2,
                                        num_channel=3, pool_stride=2),
        lambda: rows_of(dense(B, 48))),
    "simple_lstm": (
        lambda t, p: [t.simple_lstm(input=seq_of(p), size=4),
                      p.networks.simple_lstm(input=seq_of(p), size=3,
                                             reverse=True)],
        lambda: rows_of(seqs(B, 6))),
    "lstmemory_group": (
        lambda t, p: t.lstmemory_group(input=_fc(t, seq_of(p), 16), size=4),
        lambda: rows_of(seqs(B, 6))),
    "gru_group_simple_gru": (
        lambda t, p: [t.gru_group(input=_fc(t, seq_of(p), 9), size=3),
                      t.simple_gru(input=seq_of(p), size=3, reverse=True)],
        lambda: rows_of(seqs(B, 6))),
    "bidirectional": (
        lambda t, p: [t.bidirectional_lstm(input=seq_of(p), size=3),
                      t.bidirectional_gru(input=seq_of(p), size=3,
                                          return_seq=True),
                      p.networks.bidirectional_lstm(input=seq_of(p), size=2),
                      p.networks.stacked_lstm(input=seq_of(p), size=2)],
        lambda: rows_of(seqs(B, 6))),
    # layer_math: the unary layers and the overloads
    "layer_math": (
        lambda t, p: [
            *[getattr(p.op, f)(input=_fc(t, x_of(p), 3,
                                         t.SigmoidActivation()))
              for f in p.op.__all__],
            _fc(t, x_of(p), 3) + _fc(t, x_of(p), 3),
            _fc(t, x_of(p), 3) + 1.5, 2.0 - _fc(t, x_of(p), 3),
            _fc(t, x_of(p), 3) - _fc(t, x_of(p), 3),
            3.0 * _fc(t, x_of(p), 3), _fc(t, x_of(p), 3) * _fc(t, x_of(p), 1),
            _fc(t, x_of(p), 3) + _fc(t, x_of(p), 1)],
        lambda: rows_of(dense(B, 6))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_constructor_matches_jax(name):
    case, rows = CASES[name]
    check_case(case, rows())


def test_nce_layer_program_and_cost():
    def case(t, p):
        return t.nce_layer(
            input=_fc(t, x_of(p), 4),
            label=p.layer.data(name="l", type=p.data_type.integer_value(10)),
            num_classes=10, num_neg_samples=3)

    (_, _), (pouts, pparams) = build_both(case)
    got = ppaddle.infer(output_layer=pouts, parameters=pparams,
                        input=rows_of(dense(B, 6), [1, 2, 9, 0]))
    assert np.isfinite(got).all() and got.size == 1


def test_lifted_raises_are_gone():
    """None of the port's ``trainer_config_helpers/layers.py`` constructors
    still says it waits for this slice."""
    import inspect

    src = inspect.getsource(ptch.layers)
    for text in ("comes with the v2 slice", "comes with conv2d_transpose",
                 "comes with the slice_tensor op"):
        assert text not in src


def test_lstmemory_ignores_act_as_the_jax_package_does():
    """A quirk followed: the v2 lstmemory's ``act`` is not read (tanh),
    in both packages."""
    rows = rows_of(seqs(B, 6))
    outs = [check_case(lambda t, p, a=a: t.lstmemory(
        input=_fc(t, seq_of(p), 16), act=a), rows)[0]
        for a in (ptch.ReluActivation(), None)]
    np.testing.assert_array_equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# names, parse_network, the optimizers and the small modules
# ---------------------------------------------------------------------------

def test_every_v1_name_resolves_under_v2():
    import paddle_tpu.trainer_config_helpers.layers as jl
    import paddle_tpu.trainer_config_helpers.networks as jn
    import paddle_tpu_torch.v2.layer as pl

    for n in jl.__all__:
        assert getattr(ppaddle.layer, pl._convert_v1_name(n)) is not None, n
    for n in jn.__all__:
        assert getattr(ppaddle.networks, n) is not None, n
    assert set(ppaddle.layer.__all__) == set(jpaddle.layer.__all__)
    assert set(ptch.networks.__all__) == set(jn.__all__)


def test_parse_network_matches_jax():
    views = []
    for t, p in ((jtch, jpaddle), (ptch, ppaddle)):
        _reset(p)
        x = x_of(p)
        h = t.batch_norm_layer(input=_fc(t, x, 4))
        out = p.layer.fc(input=t.concat_layer(input=[h, x]), size=2)
        views.append(p.layer.parse_network(out))
    assert views[1].layers == views[0].layers
    assert views[1].input_layer_names == views[0].input_layer_names == ["x"]


OPTIMIZERS = {
    "Momentum": dict(momentum=0.9, learning_rate=0.05,
                     gradient_clipping_threshold=1.0),
    "Adam": dict(learning_rate=0.01, beta1=0.8),
    "Adamax": dict(learning_rate=0.01),
    "AdaGrad": dict(learning_rate=0.1),
    "DecayedAdaGrad": dict(learning_rate=0.1, rho=0.9),
    "AdaDelta": dict(learning_rate=1.0, rho=0.9),
    "RMSProp": dict(learning_rate=0.01, rho=0.9),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_match_jax(name):
    kw = OPTIMIZERS[name]
    rows = rows_of(dense(2 * B, 6), [1, 0, 2, 1, 2, 0, 0, 1])
    out = {}
    for t, p in ((jtch, jpaddle), (ptch, ppaddle)):
        (fluid if p is jpaddle else pt).framework.reset_default_programs()
        _reset(p)
        pred = _fc(t, x_of(p), 3, t.SoftmaxActivation())
        cost = p.layer.classification_cost(
            input=pred,
            label=p.layer.data(name="l", type=p.data_type.integer_value(3)))
        params = (p.parameters.create(cost) if p is jpaddle else
                  p.parameters.create(cost, place=pt.CPUPlace()))
        opt = getattr(p.optimizer, name)(
            regularization=p.optimizer.L2Regularization(1e-3), **kw)
        sgd = p.trainer.SGD(cost=cost, parameters=params,
                            update_equation=opt)
        out[p] = (params, sgd, opt)
    (jparams, jsgd, jopt), (pparams, psgd, popt) = out[jpaddle], out[ppaddle]
    assert (program_dict(psgd.topology.main_program)
            == program_dict(jsgd.topology.main_program))
    assert popt.server_config() == jopt.server_config()
    for n in jparams.keys():
        pparams.set(n, np.asarray(jparams.get(n)))
    costs = {}
    for p, sgd in ((jpaddle, jsgd), (ppaddle, psgd)):
        costs[p] = []
        sgd.train(lambda: iter([rows[:B], rows[B:]]),
                  event_handler=lambda e, c=costs[p]: c.append(e.cost)
                  if isinstance(e, p.event.EndIteration) else None)
    for g, w in zip(costs[ppaddle], costs[jpaddle]):
        assert abs(g - w) <= LOSS_TOL * abs(w), (g, w)
    for n in jparams.keys():
        close(pparams.get(n), np.asarray(jparams.get(n)), PARAM_TOL, n)


def test_v2_modules_surface():
    import paddle_tpu_torch.v2.fluid as pfluid
    from paddle_tpu_torch.v2.fluid import layers as flayers

    assert ppaddle.evaluator.__all__ == jpaddle.evaluator.__all__
    assert ppaddle.op.__all__ == jpaddle.op.__all__
    assert ppaddle.config_base.Layer is ppaddle.layer.LayerOutput
    assert ppaddle.config_base.__convert_to_v2__(len) is len
    assert flayers is pt.layers and pfluid.Executor is pt.Executor
    assert pfluid.CPUPlace is pt.CPUPlace
    import paddle_tpu_torch.v2.fluid.optimizer as fopt

    assert fopt is pt.optimizer
    assert ppaddle.data_feeder.DataFeeder is not None
    assert ppaddle.infer is ppaddle.inference.infer


def test_image_helpers_match_jax():
    img = np.random.RandomState(4).randint(0, 255, (20, 30, 3)).astype(
        np.float32)
    for fn, args in (("to_chw", ()), ("center_crop", (12,)),
                     ("left_right_flip", ()), ("resize_short", (10,)),
                     ("random_crop", (12,))):
        np.random.seed(5)
        want = getattr(jpaddle.image, fn)(img, *args)
        np.random.seed(5)
        got = getattr(ppaddle.image, fn)(img, *args)
        np.testing.assert_array_equal(got, want)
    for is_train in (True, False):
        np.random.seed(6)
        want = jpaddle.image.simple_transform(img, 16, 12, is_train,
                                              mean=[1.0, 2.0, 3.0])
        np.random.seed(6)
        got = ppaddle.image.simple_transform(img, 16, 12, is_train,
                                             mean=[1.0, 2.0, 3.0])
        np.testing.assert_array_equal(got, want)


def test_ploter(tmp_path):
    from paddle_tpu.v2.plot import Ploter as JaxPloter
    from paddle_tpu_torch.v2.plot import Ploter

    for cls in (Ploter, JaxPloter):
        pl = cls("train", "test")
        pl.append("train", 0, 1.5)
        pl.append("train", 1, 1.25)
        assert pl["train"].step == [0, 1] and pl["train"].value == [1.5, 1.25]
        path = str(tmp_path / f"{cls.__module__}.png")
        drawn = pl.plot(path)
        assert drawn in (None, path)
        pl.reset()
        assert pl["train"].step == [] and pl["test"].value == []


def test_infer_of_a_generation_output_names_its_roadmap_item():
    """A beam_search output (a ``BeamGen``) is decoded by a
    SequenceGenerator on the parameters' place: ``field="id"`` gives
    each row's best ids, ``field="value"`` its beams, as the JAX
    package's ``infer`` does (held to it in
    tests/test_torch_generation.py)."""
    from paddle_tpu_torch.executor import Scope

    class Params:
        scope = Scope()
        place = pt.CPUPlace()

    _reset(ppaddle)
    ctx = ppaddle.layer.data(name="c",
                             type=ppaddle.data_type.dense_vector(6))

    def step(word, c):
        mem = ptch.memory(name="d", size=6)
        h = ppaddle.layer.fc(input=[word, mem, c], size=6, act="tanh",
                             name="d", bias_attr=False)
        return ppaddle.layer.fc(input=h, size=5, act="softmax",
                                bias_attr=False)

    spec = ptch.beam_search(
        step=step, input=[ptch.GeneratedInput(size=5, embedding_name="e",
                                               embedding_size=4),
                          ptch.StaticInput(ctx, size=6)],
        bos_id=0, eos_id=1, beam_size=2, max_length=4)
    rows = [[np.full(6, 0.5, np.float32).tolist()]]
    # one Inference: a rebuilt step names its unnamed weights anew
    inference = ppaddle.inference.Inference(spec, Params)
    ids = inference.infer(rows, field="id")
    beams = inference.infer(rows)
    assert len(ids) == len(beams) == 1
    assert ids[0] == beams[0][0][1]
    assert all(0 <= t < 5 for t in ids[0]) and len(ids[0]) <= 4
