"""Sub-blocks and the ``recurrent`` op (paddle_tpu_torch: ``Block.
prepend_op`` / ``insert_op``, ``Program.create_block`` / ``rollback``,
the sub-block reads of ``prune`` and of the Executor's plan,
``layers.StaticRNN`` / ``DynamicRNN``, ``recurrent`` and its gradient)
against the JAX package, on the CPU.

A StaticRNN program (a step block with its own fc parameters, two
memories, two outputs) runs in both packages from the same weights and
feeds; its outputs and every gradient (the sequence, the initial state,
the in-block parameters) must agree within 1e-5 of the JAX tensor's
largest magnitude, within 1e-4 at 32 steps.  The replay guard: a raw
kernel launch on a tensor autograd records raises, and ``mul`` under
recording goes through ``kernels.matmul.Matmul``.
"""

import json

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.analysis import dataflow as jdataflow
from paddle_tpu_torch.analysis import dataflow
from paddle_tpu_torch.kernels import _build
from test_torch_gru import SEQ_TOL, close, data, run_both

B, D, H = 3, 5, 4


def _rnn_layers(lib, x, h0, steps, reverse):
    """Two memories (one from ``h0``, one filled from the batch of the
    step input), an fc over [x_t, h] inside the block, two outputs."""
    rnn = lib.layers.StaticRNN()
    rnn._reverse = reverse
    with rnn.step():
        xt = rnn.step_input(x)
        h = rnn.memory(init=h0)
        c = rnn.memory(batch_ref=xt, shape=[-1, H], init_value=0.5)
        nh = lib.layers.fc(input=[xt, h], size=H, act="tanh")
        nc = lib.layers.elementwise_add(c, nh)
        rnn.update_memory(h, nh)
        rnn.update_memory(c, nc)
        rnn.step_output(nh)
        rnn.step_output(nc)
    return rnn()


def _rnn_case(rng, steps, reverse=False):
    feeds = {"x": rng.randn(B, steps, D).astype(np.float32),
             "h0": rng.randn(B, H).astype(np.float32) * 0.5}

    def build():
        x = data("x", (B, steps, D), grad=True)
        h0 = data("h0", (B, H), grad=True)
        outs = _rnn_layers(fluid, x, h0, steps, reverse)
        return [fluid.layers.reshape(o, shape=[B, steps, H]) for o in outs]

    return build, feeds


@pytest.mark.parametrize("reverse", [False, True])
def test_static_rnn_outputs_and_gradients(rng, reverse):
    build, feeds = _rnn_case(rng, 5, reverse)
    got = run_both(build, feeds, ["x", "h0"])
    assert "fc_0.w_0@GRAD" in got and "fc_0.w_1@GRAD" in got


def test_static_rnn_32_steps(rng):
    build, feeds = _rnn_case(rng, 32)
    run_both(build, feeds, ["x", "h0"], tol=SEQ_TOL)


def _port_rnn_program(steps=4):
    """The StaticRNN program built with the port's layers (forward only)."""
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[B, steps, D],
                           append_batch_size=False)
        h0 = pt.layers.data(name="h0", shape=[B, H], append_batch_size=False)
        outs = _rnn_layers(pt, x, h0, steps, False)
    return main, startup, outs


def test_block_machinery_matches_jax():
    """create_block / rollback, prepend_op / insert_op build the same
    program dict in both packages."""
    progs = []
    for lib in (fluid, pt):
        lib.framework.reset_default_programs()
        p = lib.Program()
        g = p.global_block()
        g.create_var(name="a", shape=[2], dtype="float32")
        g.append_op(type="scale", inputs={"X": ["a"]},
                    outputs={"Out": ["a"]}, attrs={"scale": 2.0})
        sub = p.create_block()
        assert p.current_block() is sub and sub.parent_idx == 0
        sub.append_op(type="scale", inputs={"X": ["a"]},
                      outputs={"Out": ["a"]}, attrs={"scale": 3.0})
        p.rollback()
        assert p.current_block() is g
        g.prepend_op(type="scale", inputs={"X": ["a"]},
                     outputs={"Out": ["a"]}, attrs={"scale": 5.0})
        g.insert_op(1, type="sign", inputs={"X": ["a"]},
                    outputs={"Out": ["b"]})
        g.append_op(type="while", inputs={"X": ["a"], "Condition": ["a"]},
                    outputs={"Out": ["a"]}, attrs={"sub_block": sub})
        progs.append(p.to_dict())
    assert progs[0] == progs[1]


def test_program_with_sub_block_round_trips_both_ways(rng):
    """The port's StaticRNN program through JSON and back runs the same;
    its dict loads in the JAX package and runs equal there."""
    main, startup, outs = _port_rnn_program()
    d = main.to_dict()
    again = pt.Program.from_dict(json.loads(json.dumps(d)))
    assert again.to_dict() == d
    assert again.blocks[1].parent_idx == 0
    op = again.global_block().ops[-1]
    assert op.type == "recurrent" and op.attr("sub_block") is again.blocks[1]
    feeds = {"x": rng.randn(B, 4, D).astype(np.float32),
             "h0": rng.randn(B, H).astype(np.float32)}
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    fetch = [o.name for o in outs]
    want = exe.run(main, feed=feeds, fetch_list=fetch, scope=scope)
    got = exe.run(again, feed=feeds, fetch_list=fetch, scope=scope)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    jprog = fluid.Program.from_dict(d)
    jscope = fluid.executor.Scope()
    jscope.values.update({n: np.asarray(v.numpy())
                          for n, v in scope.values.items()})
    jgot = fluid.Executor(fluid.CPUPlace()).run(jprog, feed=feeds,
                                                fetch_list=fetch,
                                                scope=jscope)
    for g, w in zip(jgot, want):
        close(g, w, 1e-5, "JAX run of the port's program")


def test_sub_block_external_reads_and_prune():
    """The step block reads the fc weights from the enclosing scope, and
    not its own memory, which the op binds (``analysis.dataflow``, the
    port's one answer, as the JAX package's analysis gives it); prune
    keeps the recurrent op and every var its block reads, as the JAX
    package's prune does."""
    main, _, outs = _port_rnn_program()
    op = main.global_block().ops[-1]
    reads = dataflow.sub_block_external_reads(op)
    assert {"fc_0.w_0", "fc_0.w_1", "fc_0.b_0"} <= reads
    assert "static_rnn_0.mem_0" not in reads    # the block's own memory
    assert reads == jdataflow.sub_block_external_reads(
        fluid.Program.from_dict(main.to_dict()).global_block().ops[-1])
    jprog = fluid.Program.from_dict(main.to_dict())
    kept = [o.type for o in main.prune([outs[0]]).global_block().ops]
    jkept = [o.type for o in jprog.prune([outs[0].name]).global_block().ops]
    assert kept == jkept and kept[-1] == "recurrent"


def test_plan_reads_what_the_sub_block_reads(rng):
    """A recurrent op whose Params leave out a parameter its step block
    reads still gets it from the scope (the plan counts the sub-block's
    reads as the op's), and gives the same outputs."""
    main, startup, outs = _port_rnn_program()
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    feeds = {"x": rng.randn(B, 4, D).astype(np.float32),
             "h0": rng.randn(B, H).astype(np.float32)}
    fetch = [o.name for o in outs]
    want = exe.run(main, feed=feeds, fetch_list=fetch, scope=scope)
    op = main.global_block().ops[-1]
    op.inputs["Params"] = [n for n in op.inputs["Params"] if n != "fc_0.w_1"]
    main._version += 1
    got = exe.run(main, feed=feeds, fetch_list=fetch, scope=scope)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_raw_kernel_launch_under_recording_raises():
    """``refuse_recording`` (every kernel wrapper calls it before a
    launch): a tensor that requires grad while autograd records raises;
    with recording off, or through the autograd Function (whose forward
    runs with it off), it passes."""
    x = torch.ones(2, 2, requires_grad=True)
    with pytest.raises(RuntimeError, match="autograd"):
        _build.refuse_recording("matmul", x)
    with torch.no_grad():
        _build.refuse_recording("matmul", x)
    _build.refuse_recording("matmul", x.detach())
    assert _build.recording(x) and not _build.recording(x.detach())


def test_mul_under_recording_goes_through_matmul_function(rng):
    """The ``mul`` op replayed under autograd (a step block's, by
    recurrent_grad) builds its product with ``Matmul``: the gradient
    autograd pulls through it is ``matmul_backward``'s."""
    from paddle_tpu_torch.registry import LowerContext, OpRegistry

    class _Op:
        type = "mul"
        inputs = {"X": ["x"], "Y": ["y"]}
        outputs = {"Out": ["out"]}
        attrs = {"x_num_col_dims": 2}

        def input(self, slot):
            return self.inputs.get(slot, [])

        def output(self, slot):
            return self.outputs.get(slot, [])

        def attr(self, name, default=None):
            return self.attrs.get(name, default)

    x = torch.tensor(rng.randn(2, 3, 4), dtype=torch.float32,
                     requires_grad=True)
    y = torch.tensor(rng.randn(4, 5), dtype=torch.float32,
                     requires_grad=True)
    values = {"x": x, "y": y}
    with torch.enable_grad():
        OpRegistry.get("mul").lower(LowerContext(_Op(), values,
                                                 torch.device("cpu")))
    out = values["out"]
    assert "Matmul" in type(out.grad_fn.next_functions[0][0]).__name__ or \
        "Matmul" in type(out.grad_fn).__name__
    g = torch.tensor(rng.randn(2, 3, 5), dtype=torch.float32)
    dx, dy = torch.autograd.grad(out, (x, y), g)
    close(dx.numpy(), (g @ y.detach().T).numpy(), 1e-6, "dx")
    close(dy.numpy(), torch.einsum("abk,abn->kn", x.detach(), g).numpy(),
          1e-6, "dy")


def test_dynamic_rnn_is_the_static_rnn(rng):
    """DynamicRNN builds the same recurrent op as StaticRNN over padded
    batches (the caller masks by length)."""
    progs = []
    for cls in (pt.layers.StaticRNN, pt.layers.DynamicRNN):
        pt.framework.reset_default_programs()
        main = pt.Program()
        with pt.program_guard(main, pt.Program()):
            x = pt.layers.data(name="x", shape=[B, 4, D],
                               append_batch_size=False)
            rnn = cls()
            with rnn.step():
                xt = rnn.step_input(x)
                h = rnn.memory(batch_ref=xt, shape=[-1, D])
                nh = pt.layers.elementwise_add(h, xt)
                rnn.update_memory(h, nh)
                rnn.step_output(nh)
            rnn()
        progs.append(json.dumps(main.to_dict(), sort_keys=True)
                     .replace("dynamic_rnn", "static_rnn"))
    assert progs[0] == progs[1]
