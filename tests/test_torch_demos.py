"""The reference's v1 demos (``demos/``) trained through the port's v1
loop on the CPU, against the JAX package: the port's copies in
``paddle_tpu_torch/demos/`` parse (``define_py_data_sources2`` included)
into a Program equal to the JAX package's (op types and attrs, variables,
parameter names and shapes, the optimizer's ops), two steps from the
JAX package's initial weights on the same batches of the demo's own
provider match (each cost within LOSS_TOL of its value, every parameter
after them within PARAM_TOL of its largest magnitude), and the port
passes the reference test's own gate at its own pass count
(``tests/test_v1_api.py``, ``tests/test_demos.py``).

This file holds mnist_v1, quick_start, sequence_tagging and
traffic_prediction; ``test_torch_demos_seq2seq.py`` the seq2seq demo's
training half and ``test_torch_demos_fluid.py`` gan, vae and model_zoo.
"""

import json

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.executor import Executor as JaxExecutor
from paddle_tpu.executor import scope_guard as jax_scope_guard
from paddle_tpu.framework import CPUPlace as JaxCPUPlace
from paddle_tpu.trainer.config_parser import parse_config as jax_parse
from paddle_tpu.trainer.trainer import Trainer as JaxTrainer
from paddle_tpu.v2.trainer import V2DataFeeder as JaxFeeder
from paddle_tpu_torch.trainer import train_from_config
from paddle_tpu_torch.trainer.config_parser import parse_config
from paddle_tpu_torch.trainer.trainer import Trainer
from paddle_tpu_torch.v2.trainer import V2DataFeeder

LOSS_TOL, PARAM_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's many small ops: faster alone,
    and parallel test workers (each else with a thread a core) do not
    oversubscribe the cores, which slowed these steps up to a
    hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol, what):
    """max |got - want| <= tol * max |want|."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = float(np.abs(w).max()) if w.size else 0.0
    err = float(np.abs(g - w).max()) if w.size else 0.0
    assert err <= tol * max(scale, 1e-30), (what, err, scale)


def program_dict(prog):
    """A program's dict through JSON, every block reference as
    ``{"__block__": idx}`` (the JAX package leaves Block objects in a
    grad op's ``__fwd_attrs__``)."""
    return json.loads(json.dumps(prog.to_dict(), default=lambda o: (
        {"__block__": o.idx} if hasattr(o, "ops") else str(o))))


def assert_programs_equal(pprog, jprog):
    assert program_dict(pprog) == program_dict(jprog)
    assert ([(p.name, tuple(p.shape)) for p in pprog.all_parameters()]
            == [(p.name, tuple(p.shape)) for p in jprog.all_parameters()])


def v1_pair(name):
    """(JAX Trainer, port Trainer on the CPU) of the demo's config, the
    port's parameters set from the JAX package's."""
    fluid.framework.reset_default_programs()
    jt = JaxTrainer(jax_parse(f"demos/{name}/trainer_config.py"))
    pt.framework.reset_default_programs()
    port = Trainer(parse_config(
        f"paddle_tpu_torch/demos/{name}/trainer_config.py"), pt.CPUPlace())
    for pname in jt.parameters.keys():
        port.parameters.set(pname, np.asarray(jt.parameters.get(pname)))
    return jt, port


def check_v1_pair(jt, port, steps=2):
    """The programs equal; ``steps`` steps of both on the provider's
    first batches (each package's own reader and feeder) match."""
    jtopo, ptopo = jt._sgd.topology, port._sgd.topology
    assert_programs_equal(ptopo.main_program, jtopo.main_program)
    assert port._sgd.topology.feed_names() == [n for n, _ in
                                               jtopo.feed_types]
    jfeeder, pfeeder = JaxFeeder(jtopo.feed_types), V2DataFeeder(
        ptopo.feed_types)
    jbatches = list(jt._reader_from_sources()())[:steps]
    pbatches = list(port._reader_from_sources()())[:steps]
    jexe, pexe = JaxExecutor(JaxCPUPlace()), pt.Executor(pt.CPUPlace())
    for i, (jb, pb) in enumerate(zip(jbatches, pbatches)):
        with jax_scope_guard(jt.parameters.scope):
            (want,) = jexe.run(jtopo.main_program, feed=jfeeder.feed(jb),
                               fetch_list=[jtopo.cost_var])
        (got,) = pexe.run(ptopo.main_program, feed=pfeeder.feed(pb),
                          fetch_list=[ptopo.cost_var],
                          scope=port.parameters.scope)
        want, got = float(np.asarray(want).reshape(-1)[0]), float(
            np.asarray(got).reshape(-1)[0])
        assert abs(got - want) <= LOSS_TOL * abs(want), (i, got, want)
    for pname in jt.parameters.keys():
        close(port.parameters.get(pname), np.asarray(
            jt.parameters.get(pname)), PARAM_TOL, pname)


def train_gate(name, passes):
    pt.framework.reset_default_programs()
    _, costs = train_from_config(
        f"paddle_tpu_torch/demos/{name}/trainer_config.py",
        num_passes=passes, log_period=100, place=pt.CPUPlace())
    assert np.isfinite(costs).all()
    return costs


V1_DEMOS = ["mnist_v1", "quick_start", "sequence_tagging",
            "traffic_prediction"]


@pytest.mark.parametrize("name", V1_DEMOS)
def test_v1_demo_program_and_two_steps_match_the_jax_package(name):
    check_v1_pair(*v1_pair(name))


def test_v1_mnist_trains():
    costs = train_gate("mnist_v1", 2)
    assert costs[0] > 1.5
    assert np.mean(costs[-3:]) < costs[0] * 0.7


def test_v1_quick_start_text_trains():
    costs = train_gate("quick_start", 6)
    assert np.mean(costs[-3:]) < 0.45, costs[-3:]


def test_sequence_tagging_crf_trains():
    costs = train_gate("sequence_tagging", 3)
    assert np.mean(costs[-3:]) < 0.5 * costs[0], (costs[0], costs[-3:])


def test_traffic_prediction_trains():
    costs = train_gate("traffic_prediction", 4)
    assert np.mean(costs[-3:]) < 0.3 * costs[0], (costs[0], costs[-3:])
