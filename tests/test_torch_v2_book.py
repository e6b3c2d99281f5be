"""The paddle.v2 book's two models on the port against the JAX package, on
the CPU, at small widths, built with each package's v2 API by the same
builders (``chip_smoke.build_vgg_bn_drop``, ``build_sentiment_lstm``):
vgg_bn_drop's five conv groups narrowed to [4, 4], [8, 8], [8] x 3,
[16] x 3, [16] x 3 on 3 x 32 x 32 CIFAR records (every pool keeps an
image), and stacked_lstm_net at hid 32 (H 8), vocab 200, over ragged
lengths.

- The Programs equal (``to_dict`` through JSON), parameter names and
  shapes too.
- Two ``paddle.trainer.SGD`` steps from the JAX package's weights, with
  the book's optimizers (Momentum with L2 for the VGG, Adam with L2 for
  the sentiment net): each cost within LOSS_TOL of its value, every
  parameter after them within PARAM_TOL of its largest magnitude.  The
  VGG's dropouts are 0 there (each package draws its own masks); its
  conv biases feed a training BN, so their gradients are rounding noise
  around an exact zero, and its BN biases sum gradients that cancel: the
  biases are held op by op on the JAX package's values of each step's
  inputs (``test_torch_image_models.ops_on_the_jax_values``, a bias
  gradient relative to the terms it sums).
- ``paddle.infer`` (the test topology: dropout scales by the keep rate)
  gives the JAX package's outputs within PARAM_TOL of their largest
  magnitude, and its rows sum to 1.
- A Parameters tar written by either package loads in the other.
"""

import io

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu as fluid
import paddle_tpu.v2 as jpaddle
import paddle_tpu_torch as pt
import paddle_tpu_torch.v2 as ppaddle
from paddle_tpu.executor import Executor as JaxExecutor
from paddle_tpu.executor import scope_guard as jax_scope_guard
from paddle_tpu.framework import CPUPlace as JaxCPUPlace
from paddle_tpu_torch.registry import LowerContext
from test_torch_demos import (LOSS_TOL, PARAM_TOL, close,  # noqa: F401
                              one_torch_thread, program_dict)
from test_torch_image_models import ops_on_the_jax_values

SMALL_VGG = dict(groups=((4, 4), (8, 8), (8,) * 3, (16,) * 3, (16,) * 3),
                 width=16)
SMALL_SENT = dict(vocab=200, emb=16, hid=32, stacked=3)
B = 4


def vgg_rows(n, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(3072).astype(np.float32), int(rng.randint(10)))
            for _ in range(n)]


def sent_rows(n, seed=0):
    return chip_smoke.sentiment_rows(np.random.RandomState(seed), n,
                                     SMALL_SENT["vocab"], lens=(3, 20))


MODELS = {
    "vgg": (lambda p, **kw: chip_smoke.build_vgg_bn_drop(
        p, **SMALL_VGG, **kw), chip_smoke.momentum_vgg, vgg_rows),
    "sentiment": (lambda p, **kw: chip_smoke.build_sentiment_lstm(
        p, **SMALL_SENT, **kw), chip_smoke.adam_sentiment, sent_rows),
}


def both(name, **kw):
    """Each package's (output, cost, Parameters, SGD); the port's
    parameters set from the JAX package's after both SGDs ran their
    startup."""
    build, opt, _ = MODELS[name]
    fluid.framework.reset_default_programs()
    jout, jcost = build(jpaddle, **kw)
    jparams = jpaddle.parameters.create(jcost)
    jsgd = jpaddle.trainer.SGD(cost=jcost, parameters=jparams,
                               update_equation=opt(jpaddle))
    pt.framework.reset_default_programs()
    pout, pcost = build(ppaddle, **kw)
    pparams = ppaddle.parameters.create(pcost, place=pt.CPUPlace())
    psgd = ppaddle.trainer.SGD(cost=pcost, parameters=pparams,
                               update_equation=opt(ppaddle))
    for n in jparams.keys():
        pparams.set(n, np.asarray(jparams.get(n)))
    return (jout, jcost, jparams, jsgd), (pout, pcost, pparams, psgd)


def batches(rows):
    return lambda: iter([rows[i:i + B] for i in range(0, len(rows), B)])


def train_costs(paddle, sgd, reader):
    costs = []
    sgd.train(reader, event_handler=lambda e: costs.append(e.cost)
              if isinstance(e, paddle.event.EndIteration) else None)
    return costs


@pytest.mark.parametrize("name", sorted(MODELS))
def test_programs_equal(name):
    (_, _, jparams, jsgd), (_, _, pparams, psgd) = both(name)
    assert (program_dict(psgd.topology.main_program)
            == program_dict(jsgd.topology.main_program))
    assert pparams.keys() == jparams.keys()
    assert psgd.topology.feed_names() == [n for n, _ in
                                          jsgd.topology.feed_types]


def test_sentiment_two_sgd_steps_match_jax():
    (jout, _, jparams, jsgd), (pout, _, pparams, psgd) = both("sentiment")
    reader = batches(sent_rows(2 * B))
    want = train_costs(jpaddle, jsgd, reader)
    got = train_costs(ppaddle, psgd, reader)
    assert len(got) == len(want) == 2
    for i, (g, w) in enumerate(zip(got, want)):
        assert abs(g - w) <= LOSS_TOL * abs(w), (i, g, w)
    for n in jparams.keys():
        close(pparams.get(n), np.asarray(jparams.get(n)), PARAM_TOL, n)


def _is_bias(name):
    return name.endswith(".b_0")


def test_vgg_two_sgd_steps_match_jax():
    (_, _, jparams, jsgd), (_, _, pparams, psgd) = both("vgg", drop=0.0)
    reader = batches(vgg_rows(2 * B))
    want = train_costs(jpaddle, jsgd, reader)
    got = train_costs(ppaddle, psgd, reader)
    assert len(got) == len(want) == 2
    for i, (g, w) in enumerate(zip(got, want)):
        assert abs(g - w) <= LOSS_TOL * abs(w), (i, g, w)
    for n in jparams.keys():
        if not _is_bias(n):
            close(pparams.get(n), np.asarray(jparams.get(n)), PARAM_TOL, n)


def test_vgg_sgd_steps_op_by_op_on_jax_values(monkeypatch):
    """Each of two steps of the SGD's program, every op on the JAX
    package's values of its inputs (the biases' gradients and updates
    among them); the next step from the JAX package's state.  The
    dropouts (rate 0: they keep every element whatever they draw) take a
    generator of their own."""
    monkeypatch.setattr(LowerContext, "generator",
                        lambda self: torch.Generator().manual_seed(0))
    (_, _, jparams, jsgd), (_, _, pparams, psgd) = both("vgg", drop=0.0)
    jtopo, ptopo = jsgd.topology, psgd.topology
    jfeeder = jpaddle.trainer.V2DataFeeder(jtopo.feed_types)
    exe = JaxExecutor(JaxCPUPlace())
    jprog = jtopo.main_program
    names = []
    for op in jprog.global_block().ops:
        names += [n for n in op.output_arg_names if n and n not in names]
    rows = vgg_rows(2 * B, seed=1)
    for step in range(2):
        feed = jfeeder.feed(rows[step * B:(step + 1) * B])
        state = {n: np.asarray(v) for n, v in jparams.scope.values.items()}
        with jax_scope_guard(jparams.scope):
            want = exe.run(jprog, feed=feed, fetch_list=names)
        values = dict(zip(names, want))
        with pt.program_guard(ptopo.main_program):
            ops_on_the_jax_values(feed, state, values)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_infer_matches_jax(name):
    (jout, _, jparams, jsgd), (pout, _, pparams, psgd) = both(name)
    rows = [(r[0],) for r in MODELS[name][2](6, seed=2)]
    want = np.asarray(jpaddle.infer(output_layer=jout, parameters=jparams,
                                    input=rows))
    got = ppaddle.infer(output_layer=pout, parameters=pparams, input=rows)
    close(got, want, PARAM_TOL, f"{name} infer")
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_parameters_tar_crosses_packages(writer):
    (_, jcost, jparams, _), (_, pcost, pparams, _) = both("sentiment")
    rng = np.random.RandomState(3)
    src, dst = (jparams, pparams) if writer == "jax" else (pparams, jparams)
    for n in src.keys():
        src.set(n, rng.randn(*src.get_shape(n)).astype(np.float32))
    buf = io.BytesIO()
    src.to_tar(buf)
    buf.seek(0)
    if writer == "jax":
        loaded = ppaddle.parameters.Parameters.from_tar(
            buf, pparams.topology, place=pt.CPUPlace())
    else:
        loaded = jpaddle.parameters.Parameters.from_tar(buf, jparams.topology)
    assert sorted(loaded.keys()) == sorted(src.keys())
    for n in src.keys():
        np.testing.assert_array_equal(np.asarray(loaded.get(n)),
                                      np.asarray(src.get(n)))
    assert dst.keys() == loaded.keys()
