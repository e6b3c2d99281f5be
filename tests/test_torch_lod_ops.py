"""The LoD structure ops on the port (paddle_tpu_torch/ops/lod_ops.py:
``lod_rank_table``, ``lod_tensor_to_array``, ``array_to_lod_tensor``,
``shrink_rnn_memory``, ``rnn_memory_helper``, ``split_lod_tensor``,
``merge_lod_tensor``; ``max_sequence_len`` and the array reads) against
the JAX package, on the CPU.

The LoD input is 4 sequences of lengths [3, 5, 1, 2] packed into 11 rows
and 2 padding rows past the last offset, as the JAX package's own
fixture carries a padding row (``tests/test_op_wave3.py:97-100``);
``test_rank_table_and_max_len`` also takes lengths [3, 1, 3, 2], a tie.
Each program is built twice, with both packages' layers, and the two
must be equal; the port runs it from the JAX package's state
(``test_torch_control_flow.both``).  Tolerance as there: floats within
1e-5 of the JAX tensor's largest magnitude, integers exactly.
"""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu_torch.lod import LoDRankTable
from paddle_tpu_torch.tensor_array import TensorArray
from test_torch_control_flow import both, data, run_op
from test_torch_demos import one_torch_thread  # noqa: F401

LENS = [3, 5, 1, 2]
D = 4
PAD = 2


def lod_x(rng, lens=LENS, pad=PAD, d=D):
    off = np.concatenate([[0], np.cumsum(lens)]).tolist()
    return rng.randn(off[-1] + pad, d).astype(np.float32), [off]


def x_layer(fl):
    return fl.layers.data(name="x", shape=[D], dtype="float32", lod_level=1)


@pytest.mark.parametrize("lens", [LENS, [3, 1, 3, 2]])
def test_rank_table_and_max_len(rng, lens):
    """The longest length through ``max_sequence_len``; the rank table's
    own order and lengths on the port's fetch (ties keep input order,
    as the stable argsort of ``-lens``)."""
    feed = {"x": lod_x(rng, lens)}

    def case(fl):
        return [fl.layers.max_sequence_len(fl.layers.lod_rank_table(
            x_layer(fl)))]

    (mlen,), _, _ = both(case, feed)
    assert int(mlen) == max(lens)
    pt.framework.reset_default_programs()
    table = pt.layers.lod_rank_table(x_layer(pt))
    (got,) = pt.Executor(pt.CPUPlace()).run(feed=feed, fetch_list=[table])
    assert isinstance(got, LoDRankTable)
    order = np.argsort(-np.asarray(lens), kind="stable")
    np.testing.assert_array_equal(got.index, order)
    np.testing.assert_array_equal(got.lengths, np.asarray(lens)[order])
    assert got.src_rows == sum(lens) + PAD


@pytest.mark.parametrize("max_len", [None, 5, 3])
def test_lod_tensor_to_array_round_trip(rng, max_len):
    """lod_tensor_to_array -> every slot read back -> array_to_lod_tensor:
    the slots hold the rank-ordered steps (zeros past each sequence), the
    length is the longest sequence (cut at max_len), and the round trip
    restores the rows up to max_len and the packed row count (at most
    the array's max_len x n_seq slots, as the JAX op cuts it), padding
    rows zero."""
    x, lod = lod_x(rng)
    cap = max_len or x.shape[0]

    def case(fl):
        L = fl.layers
        xv = x_layer(fl)
        table = L.lod_rank_table(xv)
        arr = L.lod_tensor_to_array(xv, table, max_len=max_len)
        slots = [L.array_read(arr, L.fill_constant(shape=[1], dtype="int64",
                                                   value=t))
                 for t in range(min(cap, 6))]
        back = L.array_to_lod_tensor(arr, table)
        return slots + [L.array_length(arr), back]

    got, _, _ = both(case, {"x": (x, lod)})
    *slots, length, back = got
    t_max = min(max(LENS), cap)
    assert int(length[0]) == t_max
    order = np.argsort(-np.asarray(LENS), kind="stable")
    off = lod[0]
    for t, slot in enumerate(slots):
        for rank, s in enumerate(order):
            want = x[off[s] + t] if t < LENS[s] else np.zeros(D)
            np.testing.assert_array_equal(slot[rank], want)
    assert back.data.shape == (min(x.shape[0], cap * len(LENS)), D)
    for s, n in enumerate(LENS):
        kept = min(n, t_max)
        np.testing.assert_array_equal(back.data[off[s]:off[s] + kept],
                                      x[off[s]:off[s] + kept])
    assert not back.data[off[-1]:].any()


def test_shrink_memory(rng):
    """At step i the memory rows of the (rank-ordered) sequences shorter
    than i + 1 are zero; the op's gradient masks the same rows."""
    feed = {"x": lod_x(rng), "m": rng.randn(4, 3).astype(np.float32),
            "i": np.array([2], np.int64)}

    def build():
        L = fluid.layers
        table = L.lod_rank_table(x_layer(fluid))
        mem = data(fluid, "m", (4, 3), grad=True)
        return [L.shrink_memory(mem, data(fluid, "i", (1,), "int64"), table)]

    got = run_op(build, feed, grads_of=["m"])
    out = next(iter(got.values()))
    # rank order of lengths [3, 5, 1, 2]: [5, 3, 2, 1]; alive at step 2: 2
    np.testing.assert_array_equal(out[2:], 0)
    np.testing.assert_array_equal(out[:2], feed["m"][:2])


def test_split_merge_lod_tensor(rng):
    """split_lod_tensor zeroes the complementary rows of each half;
    merge_lod_tensor takes them back by the mask; gradients flow to X
    through both and to the two merged inputs."""
    x = rng.randn(6, 3).astype(np.float32)
    feed = {"x": x, "mask": (rng.rand(6, 1) < 0.5),
            "t": rng.randn(6, 3).astype(np.float32)}

    def build():
        L = fluid.layers
        xv = data(fluid, "x", (6, 3), grad=True)
        mask = data(fluid, "mask", (6, 1), "bool")
        t, f = L.split_lod_tensor(xv, mask)
        tv = data(fluid, "t", (6, 3), grad=True)
        merged = L.merge_lod_tensor(L.scale(t, scale=2.0), tv, xv, mask)
        return [t, f, merged]

    run_op(build, feed, grads_of=["x", "t"])


def test_rnn_memory_helper(rng):
    """The identity hand-off op, and its gradient."""
    feed = {"x": rng.randn(3, 2).astype(np.float32)}

    def build():
        from paddle_tpu.layer_helper import LayerHelper

        xv = data(fluid, "x", (3, 2), grad=True)
        helper = LayerHelper("mem")
        out = helper.create_tmp_variable("float32", (3, 2))
        helper.append_op(type="rnn_memory_helper", inputs={"X": [xv]},
                         outputs={"Out": [out]})
        return [out]

    got = run_op(build, feed, grads_of=["x"])
    np.testing.assert_array_equal(next(iter(got.values())), feed["x"])


def test_tensor_array_fetch_and_functional_write():
    """A fetched TensorArray comes back with numpy fields; a write leaves
    the array it was made from as it was."""
    pt.framework.reset_default_programs()
    L = pt.layers
    arr = L.create_array("float32", elem_shape=(2,), capacity=3)
    L.array_write(L.fill_constant(shape=[2], dtype="float32", value=1.0),
                  L.fill_constant(shape=[1], dtype="int64", value=1), arr)
    (got,) = pt.Executor(pt.CPUPlace()).run(fetch_list=[arr])
    assert isinstance(got, TensorArray) and isinstance(got.stack, np.ndarray)
    np.testing.assert_array_equal(got.stack, [[0, 0], [1, 1], [0, 0]])
    assert int(got.length) == 2
    a = TensorArray.create(2, (1,))
    b = a.write(torch.tensor([0]), torch.ones(1))
    assert float(a.stack.sum()) == 0.0 and float(b.stack.sum()) == 1.0
    assert int(a.length) == 0 and int(b.length) == 1
