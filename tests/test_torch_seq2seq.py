"""benchmark/run.py's seq2seq cell (a GRU encoder, a recurrent_group
decoder with simple_attention, the vocab softmax hoisted out of the
loop, Adam(1e-3)) built through its v1 config and trained by the port
against the JAX package, on the CPU, at a small size (vocab 100, emb =
hid 16, S 6, B 4, ragged lengths).

Both packages run the same config function (``cell_config``) through
``parse_config`` -> ``Trainer``; the JAX Trainer's weights go to the
port's Parameters by name.  Tolerances: the programs equal (op types and
attrs per block, parameter names and shapes); f32 the loss within 1e-5
relative and every gradient within 1e-4 of its largest magnitude, each
of two Adam steps, and every parameter after them within 1e-4; AMP the
loss within 1e-2 relative and every gradient within 1e-2 of max, each
step, and every parameter after them within 1e-2 of max or AMP_FLOOR
times the JAX package's own bf16 effect on it (its AMP steps against
its float32 steps from the same start), where that is larger: Adam's
first steps move an element by about the learning rate whatever its
gradient's size, so a gradient near zero that bf16 flips moves a
zero-initialised bias by up to twice that.
"""

import json

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu.trainer_config_helpers as jax_tch
import paddle_tpu_torch as pt
import paddle_tpu_torch.trainer_config_helpers as port_tch
from paddle_tpu import amp as jax_amp
from paddle_tpu import executor as jax_executor
from paddle_tpu.executor import Executor as JaxExecutor
from paddle_tpu.executor import scope_guard as jax_scope_guard
from paddle_tpu.framework import CPUPlace as JaxCPUPlace
from paddle_tpu.trainer.config_parser import parse_config as jax_parse
from paddle_tpu.trainer.trainer import Trainer as JaxTrainer
from paddle_tpu.v2.data_type import integer_value_sequence as jax_ivs
from paddle_tpu_torch.trainer.config_parser import parse_config
from paddle_tpu_torch.trainer.trainer import Trainer
from paddle_tpu_torch.v2.data_type import integer_value_sequence
from test_torch_gru import close, jax_dict

VOCAB, EMB, HID, S, B = 100, 16, 16, 6, 4
F32_LOSS, F32_TOL, AMP_TOL = 1e-5, 1e-4, 1e-2
AMP_FLOOR = 4.0


def cell_config(tch, vocab=VOCAB, emb=EMB, hid=HID, batch=B):
    """The config of benchmark/run.py:175-216 over either package's
    trainer_config_helpers."""

    def config():
        tch.settings(batch_size=batch, learning_rate=1e-3,
                     learning_method=tch.AdamOptimizer())
        src = tch.data_layer(name="src", size=vocab)
        src_emb = tch.embedding_layer(input=src, size=emb,
                                      param_attr=tch.ParamAttr(name="src_emb"))
        enc_proj = tch.fc_layer(input=src_emb, size=3 * hid,
                                act=tch.LinearActivation(), bias_attr=False)
        enc = tch.grumemory(input=enc_proj, size=hid, name="enc_seq")
        trg_in = tch.data_layer(name="trg_in", size=vocab)
        trg_out = tch.data_layer(name="trg_out", size=vocab)
        trg_emb = tch.embedding_layer(input=trg_in, size=emb,
                                      param_attr=tch.ParamAttr(name="trg_emb"))

        def step(word, enc_states):
            dec_mem = tch.memory(name="dec_state", size=hid)
            ctx = tch.simple_attention(encoded_sequence=enc_states,
                                       encoded_proj=enc_states,
                                       decoder_state=dec_mem)
            inp = tch.fc_layer(input=[word, ctx], size=3 * hid,
                               act=tch.LinearActivation(), bias_attr=False)
            dec = tch.gru_step_layer(input=inp, output_mem=dec_mem, size=hid,
                                     name="dec_state")
            return tch.fc_layer(input=dec, size=vocab,
                                act=tch.SoftmaxActivation())

        probs = tch.recurrent_group(
            step=step, input=[trg_emb, tch.StaticInput(enc, is_seq=True,
                                                       size=hid)])
        tch.outputs(tch.classification_cost(input=probs, label=trg_out))

    return config


def jax_trainer():
    fluid.framework.reset_default_programs()
    conf = jax_parse(cell_config(jax_tch))
    for name in ("src", "trg_in", "trg_out"):
        conf.data_layers[name].input_type = jax_ivs(VOCAB)
    return JaxTrainer(conf)


def port_trainer(place=None):
    # as jax_trainer: the optimizer names its learning-rate var from the
    # global generator, which Topology's build-time reset does not cover
    pt.framework.reset_default_programs()
    conf = parse_config(cell_config(port_tch))
    for name in ("src", "trg_in", "trg_out"):
        conf.data_layers[name].input_type = integer_value_sequence(VOCAB)
    return Trainer(conf, pt.CPUPlace() if place is None else place)


def feeds(seed, steps=2):
    """run.py's six feeds at this size, with ragged lengths."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        src_len = rng.randint(1, S + 1, B).astype(np.int32)
        trg_len = rng.randint(1, S + 1, B).astype(np.int32)
        src_len[0] = trg_len[1] = S
        out.append({
            "src": rng.randint(2, VOCAB, (B, S)).astype(np.int64),
            "src@len": src_len,
            "trg_in": rng.randint(2, VOCAB, (B, S)).astype(np.int64),
            "trg_in@len": trg_len,
            "trg_out": rng.randint(2, VOCAB, (B, S)).astype(np.int64),
            "trg_out@len": trg_len})
    return out


def _dict(prog):
    """A program's dict with every block reference as ``{"__block__"}``
    (the JAX package leaves the Block object inside a grad op's
    ``__fwd_attrs__``)."""
    return json.loads(json.dumps(prog.to_dict(), default=lambda o: (
        {"__block__": o.idx} if hasattr(o, "ops") else str(o))))


@pytest.fixture(scope="module")
def both():
    jt = jax_trainer()
    port = port_trainer()
    for name in jt.parameters.keys():
        port.parameters.set(name, np.asarray(jt.parameters.get(name)))
    return jt, port


def test_cell_program_equals_the_jax_package(both):
    jt, port = both
    jprog, pprog = jt._sgd.topology.main_program, port._sgd.topology.main_program
    assert len(pprog.blocks) == 2
    assert [o.type for o in pprog.blocks[1].ops] == [
        "expand_as_steps", "elementwise_add", "tanh", "mul",
        "padded_sequence_softmax", "elementwise_mul", "padded_sequence_pool",
        "mul", "mul", "sum", "gru_unit"]
    # the vocab projection runs once after the loop, not in it
    assert [o.type for o in pprog.global_block().ops[:12]] == [
        "reshape", "lookup_table", "reshape", "lookup_table", "mul", "gru",
        "fill_constant_batch_size_like", "recurrent", "mul",
        "elementwise_add", "softmax", "padded_sequence_cross_entropy"]
    assert _dict(pprog) == _dict(jprog)
    assert ([(p.name, p.shape) for p in pprog.all_parameters()]
            == [(p.name, p.shape) for p in jprog.all_parameters()])
    assert (port._sgd.topology.feed_names()
            == [n for n, _ in jt._sgd.topology.feed_types])


def _steps(jt, port, feed_list, amp, program=None):
    """Each feed: one step of both packages (the JAX program, the port's
    own or ``program``), fetching the loss and every gradient; returns
    [(got, want)] per step and the fetch names."""
    names = jt.parameters.keys()
    fetch = [jt._sgd.topology.cost_var.name] + [n + "@GRAD" for n in names]
    jprog = jt._sgd.topology.main_program
    pprog = program or port._sgd.topology.main_program
    jexe, pexe = JaxExecutor(JaxCPUPlace()), pt.Executor(pt.CPUPlace())
    out = []
    for feed in feed_list:
        with jax_scope_guard(jt.parameters.scope), jax_amp.amp_guard(amp):
            want = jexe.run(jprog, feed=feed, fetch_list=fetch)
        with pt.scope_guard(port.parameters.scope), pt.amp.amp_guard(amp):
            got = pexe.run(pprog, feed=feed, fetch_list=fetch)
        out.append((got, want))
    return out, fetch


def _check_steps(steps, fetch, loss_tol, tol):
    for i, (got, want) in enumerate(steps):
        rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
        assert rel <= loss_tol, (i, got[0], want[0])
        for name, g, w in zip(fetch[1:], got[1:], want[1:]):
            assert g.dtype == np.float32, name
            close(g, w, tol, f"step {i}: {name}")


def _check_params(jt, port, tol, f32_scope=None):
    """Every parameter within ``tol`` of max; with ``f32_scope`` (the JAX
    package's float32 steps) or within AMP_FLOOR times the JAX package's
    own bf16 effect on it."""
    for name in jt.parameters.keys():
        got = np.asarray(port.parameters.get(name), np.float64)
        want = np.asarray(jt.parameters.get(name), np.float64)
        allowed = tol * np.abs(want).max()
        if f32_scope is not None:
            effect = np.abs(want - np.asarray(f32_scope.get(name))).max()
            allowed = max(allowed, AMP_FLOOR * effect)
        assert np.abs(got - want).max() <= allowed, name


def test_two_adam_steps_match_jax():
    jt = jax_trainer()
    port = port_trainer()
    for name in jt.parameters.keys():
        port.parameters.set(name, np.asarray(jt.parameters.get(name)))
    steps, fetch = _steps(jt, port, feeds(1), amp=False)
    _check_steps(steps, fetch, F32_LOSS, F32_TOL)
    _check_params(jt, port, F32_TOL)
    assert float(steps[1][0][0]) != float(steps[0][0][0])


def test_two_amp_adam_steps_match_jax():
    jt = jax_trainer()
    port = port_trainer()
    for name in jt.parameters.keys():
        port.parameters.set(name, np.asarray(jt.parameters.get(name)))
    f32_scope = jax_executor.Scope()
    f32_scope.values.update(jt.parameters.scope.values)
    jprog = jt._sgd.topology.main_program
    for feed in feeds(2):
        JaxExecutor(JaxCPUPlace()).run(jprog, feed=feed, fetch_list=[],
                                       scope=f32_scope)
    steps, fetch = _steps(jt, port, feeds(2), amp=True)
    _check_steps(steps, fetch, AMP_TOL, AMP_TOL)
    _check_params(jt, port, AMP_TOL, f32_scope)
    # under AMP the encoder's products and its hidden are bf16, the
    # decoder's memory float32
    with pt.scope_guard(port.parameters.scope), pt.amp.amp_guard(True):
        hidden, dec = pt.Executor(pt.CPUPlace()).run(
            port._sgd.topology.main_program, feed=feeds(3, 1)[0],
            fetch_list=["v2_gru_0.tmp_0", "static_rnn_0.out_0"])
    assert hidden.dtype.name == "bfloat16" and dec.dtype == np.float32


def test_the_jax_program_dict_runs_equal_in_the_port(both):
    """The JAX Trainer's program, through its own ``to_dict`` as JSON,
    loaded by the port's ``Program.from_dict`` (the grad op's forward
    sub-block resolved to the port's block), runs one step equal to the
    JAX one."""
    jt, port = both
    jprog = jt._sgd.topology.main_program
    loaded = pt.Program.from_dict(jax_dict(jprog))
    gop = next(o for o in loaded.global_block().ops
               if o.type == "recurrent_grad")
    assert gop.attr("__fwd_attrs__")["sub_block"] is loaded.blocks[1]
    assert _dict(loaded) == _dict(jprog)
    steps, fetch = _steps(jt, port, feeds(4, 1), amp=False, program=loaded)
    _check_steps(steps, fetch, F32_LOSS, F32_TOL)


def test_entry_points_take_the_card_unless_asked():
    """The Trainer (and the Executors its Parameters and SGD make) runs on
    CUDAPlace(0) by default and raises without a card; trainer_count > 1
    raises."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_trainer(place=pt.CUDAPlace(0))
        conf = parse_config(cell_config(port_tch))
        for name in ("src", "trg_in", "trg_out"):
            conf.data_layers[name].input_type = integer_value_sequence(VOCAB)
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(conf)
    from paddle_tpu_torch import v2

    with pytest.raises(NotImplementedError):
        v2.init(trainer_count=2)
    v2.init(trainer_count=1)


_PROBE = r"""
import sys
import numpy as np
import paddle_tpu_torch as pt
import paddle_tpu_torch.trainer_config_helpers as tch
from paddle_tpu_torch.trainer.config_parser import parse_config
from paddle_tpu_torch.trainer.trainer import Trainer
from paddle_tpu_torch.v2.data_type import integer_value_sequence
VOCAB, EMB, HID, B = 50, 8, 8, 2
{source}
conf = parse_config(cell_config(tch))
for name in ("src", "trg_in", "trg_out"):
    conf.data_layers[name].input_type = integer_value_sequence(VOCAB)
t = Trainer(conf, pt.CPUPlace())
ids = np.arange(6, dtype=np.int64).reshape(B, 3) + 2
lens = np.array([3, 2], np.int32)
feed = {{"src": ids, "src@len": lens, "trg_in": ids, "trg_in@len": lens,
         "trg_out": ids, "trg_out@len": lens}}
with pt.scope_guard(t.parameters.scope):
    (loss,) = pt.Executor(pt.CPUPlace()).run(
        t._sgd.topology.main_program, feed=feed,
        fetch_list=[t._sgd.topology.cost_var])
assert np.isfinite(loss)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "paddle_tpu" or m.startswith("paddle_tpu."))
print("LOADED", bad)
"""


def test_the_v1_stack_never_loads_jax_or_paddle_tpu():
    """parse_config -> Trainer -> Executor.run of the cell in a fresh
    process loads no module of jax or of the JAX package."""
    import inspect
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    probe = _PROBE.format(source=inspect.getsource(cell_config))
    out = subprocess.run([sys.executable, "-c", probe], cwd=repo,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout


def test_v2_layer_names_resolve_to_the_v1_constructors():
    """The v1 constructors under their v2 names (``v2.layer``'s
    ``__getattr__``), and the names it defines itself first."""
    from paddle_tpu_torch.v2 import layer as v2_layer

    assert v2_layer.grumemory is port_tch.grumemory
    assert v2_layer.recurrent_group is port_tch.recurrent_group
    assert v2_layer.gru_step is port_tch.gru_step_layer
    assert v2_layer.classification_cost is not port_tch.classification_cost
    with pytest.raises(AttributeError):
        v2_layer.no_such_layer
