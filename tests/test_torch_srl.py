"""The sequence-tagging slice on the port against the JAX package, on the
CPU: ``crf_decoding`` and ``chunk_eval`` (every scheme, LoD and padded
input), ``sequence_conv`` (the LoD op, the padded layer) and
``nets.sequence_conv_pool``, ``cos_sim``, the fluid book's semantic-role
tagger (``chip_smoke.build_srl``) at 2 layers and narrow widths, and the
book programs of ``tests/test_book_wave2.py:25, 58``.

Programs built with both packages' layers must be equal (``both`` of
``tests/test_torch_control_flow.py``); the port then runs from the JAX
package's state.  A LoD ``sequence_conv_pool`` has no JAX-built program
(the JAX layer unpacks three dims and raises), so the JAX Executor runs
the port's program there, read back through ``Program.from_dict``.

Tolerance: costs, gradients and parameters within 1e-5 of the JAX
tensor's largest magnitude for one op, 1e-4 through a whole tagger
(two Adam steps); paths and chunk counts exactly.
"""

import json

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest

import chip_smoke
import paddle_tpu as fluid
import paddle_tpu_torch as pt
from test_torch_control_flow import both, compare, data, run_op
from test_torch_demos import one_torch_thread  # noqa: F401
from test_torch_sequence_tail import op

SMALL = dict(depth=2, word_dict=50, pred_dict=20, mark_dict=2, word_dim=8,
             mark_dim=3, hidden=16, labels=9)
PROGRAM_TOL = 1e-4


def emission_feeds(rng, B=4, T=6, D=5, ties=False):
    em = np.zeros((B, T, D), np.float32) if ties else \
        rng.randn(B, T, D).astype(np.float32)
    tr = np.zeros((D + 2, D), np.float32) if ties else \
        rng.randn(D + 2, D).astype(np.float32)
    return {"em": em, "tr": tr,
            "n": np.asarray([[6], [3], [1], [5]], np.int64)[:B]}


@pytest.mark.parametrize("ties", [False, True])
def test_crf_decoding(rng, ties):
    """The Viterbi path (B, T), a row's tag held past its length; on
    exact ties (all scores equal) the first maximum everywhere."""
    feeds = emission_feeds(rng, ties=ties)

    def build():
        return op("crf_decoding",
                  {"Emission": [data(fluid, "em", feeds["em"].shape)],
                   "Transition": [data(fluid, "tr", feeds["tr"].shape)],
                   "Length": [data(fluid, "n", (4, 1), "int64")]},
                  {"ViterbiPath": ("int64", (4, 6))})

    got = run_op(build, feeds, diff=False)
    path = next(iter(got.values()))
    if ties:
        assert not path.any()
    else:
        # held past the length: the row of length 1 repeats its tag
        assert (path[2] == path[2, 0]).all()


def random_tags(rng, n, scheme, n_types=3):
    n_tag = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[scheme]
    outside = n_types * n_tag
    return rng.randint(0, outside + 1, n).astype(np.int64)


@pytest.mark.parametrize("scheme", ["IOB", "IOE", "IOBES", "plain"])
@pytest.mark.parametrize("lod", [True, False])
def test_chunk_eval(rng, scheme, lod):
    """Precision, recall, F1 and the three counts; a LoD input scored
    sequence by sequence, a padded one as one run (as the JAX op has it);
    excluded_chunk_types is read by neither package.  The labels copy
    the inference at most places, so correct chunks occur."""
    lens = [5, 1, 7, 3]
    n = sum(lens)
    inf = random_tags(rng, n, scheme)
    lab = np.where(rng.rand(n) < 0.7, inf, random_tags(rng, n, scheme))
    off = np.concatenate([[0], np.cumsum(lens)]).tolist()
    if lod:
        feeds = {"i": (inf.reshape(-1, 1), [off]),
                 "l": (lab.reshape(-1, 1), [off])}
    else:
        feeds = {"i": inf.reshape(2, -1), "l": lab.reshape(2, -1)}

    def case(fl):
        if lod:
            i = fl.layers.data(name="i", shape=[1], dtype="int64",
                               lod_level=1)
            lb = fl.layers.data(name="l", shape=[1], dtype="int64",
                                lod_level=1)
        else:
            i, lb = (data(fl, k, feeds[k].shape, "int64") for k in "il")
        return list(fl.layers.chunk_eval(i, lb, scheme, 3,
                                         excluded_chunk_types=[1]))

    got, _, _ = both(case, feeds)
    assert int(np.asarray(got[5]).reshape(-1)[0]) > 0


@pytest.mark.parametrize("inf,lab,scheme,types,counts", [
    ([0, 1, 2, 0, 1], [0, 1, 2, 0, 2], "IOB", 1, (2, 2, 1)),
    ([0, 1, 2, 8, 3, 7], [0, 1, 2, 8, 3, 7], "IOBES", 2, (3, 3, 3)),
    ([0, 2], [0, 0], "IOB", 1, (1, 2, 1))])
def test_chunk_eval_pinned(inf, lab, scheme, types, counts):
    """tests/test_op_wave3.py's chunk_eval cases on both packages: an IOB
    partial match, an IOBES exact match, and trailing O tags that must
    not poison a chunk's minimum."""
    feeds = {"i": np.asarray(inf, np.int64), "l": np.asarray(lab, np.int64)}

    def case(fl):
        i, lb = (data(fl, k, feeds[k].shape, "int64") for k in "il")
        return list(fl.layers.chunk_eval(i, lb, scheme, types))

    got, _, _ = both(case, feeds)
    assert tuple(int(np.asarray(v)[0]) for v in got[3:]) == counts


def test_conv2d_transpose_layer(rng):
    """The layer (filter, bias, act) on both packages, two Adam steps:
    its transposed filter and bias cross through the JAX package's
    state."""
    feeds = {"x": rng.randn(2, 3, 5, 5).astype(np.float32)}

    def case(fl):
        out = fl.layers.conv2d_transpose(data(fl, "x", (2, 3, 5, 5)), 4,
                                         filter_size=3, stride=2, padding=1,
                                         act="relu")
        loss = fl.layers.mean(out)
        fl.optimizer.Adam(learning_rate=0.01).minimize(loss)
        return [out, loss]

    both(case, feeds, steps=2, tol=PROGRAM_TOL)


def test_sequence_conv_op(rng):
    """The LoD op: each row's window zeroed across sequence boundaries
    and past the packed rows, times the filter; X's and the filter's
    gradients.  Two padding rows past the last offset."""
    lens = [3, 1, 4]
    off = np.concatenate([[0], np.cumsum(lens)]).tolist()
    feeds = {"x": (rng.randn(off[-1] + 2, 3).astype(np.float32), [off]),
             "w": rng.randn(4 * 3, 5).astype(np.float32)}

    def build():
        x = fluid.layers.data(name="x", shape=[3], dtype="float32",
                              lod_level=1)
        x.stop_gradient = False
        return op("sequence_conv",
                  {"X": [x], "Filter": [data(fluid, "w", (12, 5), grad=True)]},
                  {"Out": ("float32", (-1, 5))},
                  {"contextLength": 4, "contextStart": -2})

    run_op(build, feeds, grads_of=["x", "w"])


@pytest.mark.parametrize("lengths", [False, True])
def test_sequence_conv_padded_layer(rng, lengths):
    """The padded layer: context_project (rows past the lengths zeroed)
    and a position-wise fc, the JAX layer's program, two Adam steps."""
    feeds = {"x": rng.randn(3, 5, 4).astype(np.float32),
             "n": np.asarray([[5], [2], [3]], np.int64)}

    def case(fl):
        x = data(fl, "x", (3, 5, 4))
        n = data(fl, "n", (3, 1), "int64") if lengths else None
        out = fl.layers.sequence_conv(x, num_filters=6, filter_size=3,
                                      act="tanh", lengths=n)
        loss = fl.layers.mean(out)
        fl.optimizer.Adam(learning_rate=0.01).minimize(loss)
        return [out, loss]

    both(case, feeds, steps=2, tol=PROGRAM_TOL)


def test_cos_sim_layer(rng):
    feeds = {"x": rng.randn(4, 5).astype(np.float32),
             "y": rng.randn(4, 5).astype(np.float32)}

    def case(fl):
        x, y = data(fl, "x", (4, 5)), data(fl, "y", (4, 5))
        return [fl.layers.cos_sim(x, y)]

    both(case, feeds)


# ---------------------------------------------------------------------------
# whole programs
# ---------------------------------------------------------------------------


def param_grads(fl):
    block = fl.default_main_program().global_block()
    return [block.var(p.name + "@GRAD")
            for p in fl.default_main_program().all_parameters()]


def test_srl_program(rng):
    """build_srl at 2 layers and narrow widths on both packages: the
    Programs equal; over two Adam steps the cost, every parameter's
    gradient and the decoded paths agree, and so do the chunk counts of
    the paths against the targets (LoD rows, padding left out)."""
    feeds = chip_smoke.srl_feed(rng, 4, lens=(2, 7), word_dict=50,
                                pred_dict=20, labels=9, words=30)

    def case(fl):
        _, _, cost, decode = chip_smoke.build_srl(fl, **SMALL)
        return [cost, decode] + param_grads(fl)

    got, _, _ = both(case, feeds, steps=2, tol=PROGRAM_TOL)
    paths = np.asarray(got[1])
    for fl in (fluid, pt):
        main, outs = chip_smoke.build_chunk_eval(fl, labels=9)
        if fl is fluid:
            want = fluid.Executor(fluid.CPUPlace()).run(
                main, feed=chip_smoke.chunk_feed(paths, feeds),
                fetch_list=outs)
        else:
            got_c = pt.Executor(pt.CPUPlace()).run(
                main, feed=chip_smoke.chunk_feed(paths, feeds),
                fetch_list=outs, scope=pt.Scope())
    for name, g, w in zip("prfilc", got_c, want):
        compare(name, g, w)
    margins = chip_smoke.viterbi_margins(np.zeros((1, 3, 9)),
                                         np.zeros((11, 9)), [3])
    assert margins[0] == 0.0   # every path ties: no margin at all


def test_srl_learns():
    """The tagger at 2 layers and narrow widths learns the tagging rule
    of srl_feed on the port's CPU path: 40 Adam(0.01) steps halve the
    cost."""
    main, startup, cost, _ = chip_smoke.build_srl(pt, lr=0.01, **SMALL)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    batches = [chip_smoke.srl_feed(np.random.RandomState(s), 16,
                                   lens=(3, 12), word_dict=50, pred_dict=20,
                                   labels=9, words=30) for s in range(4)]
    costs = [float(exe.run(main, feed=batches[i % 4], fetch_list=[cost],
                           scope=scope)[0]) for i in range(40)]
    assert np.mean(costs[-3:]) <= 0.5 * costs[0], costs


def test_book_understand_sentiment_conv(rng):
    """tests/test_book_wave2.py:25's program (padded sequence_conv, a
    max over time, fc softmax, Adam) on both packages, two steps."""
    T = 8
    feeds = {"ids": rng.randint(0, 30, (6, T, 1)).astype(np.int64),
             "label": rng.randint(0, 2, (6, 1)).astype(np.int64)}

    def case(fl):
        ids = fl.layers.data(name="ids", shape=[T, 1], dtype="int64")
        label = fl.layers.data(name="label", shape=[1], dtype="int64")
        emb = fl.layers.embedding(ids, size=[30, 8])
        conv = fl.layers.sequence_conv(emb, num_filters=6, filter_size=3,
                                       act="tanh")
        pooled = fl.layers.reduce_max(conv, dim=1)
        pred = fl.layers.fc(input=pooled, size=2, act="softmax")
        loss = fl.layers.mean(fl.layers.cross_entropy(input=pred,
                                                      label=label))
        fl.optimizer.Adam(learning_rate=0.01).minimize(loss)
        return [loss, pred]

    both(case, feeds, steps=2, tol=PROGRAM_TOL)


def test_book_label_semantic_roles_crf(rng):
    """tests/test_book_wave2.py:58's program (emission fc, CRF cost, the
    shared transition decoded) on both packages, two steps."""
    T = 6
    feeds = {"ids": rng.randint(0, 20, (5, T, 1)).astype(np.int64),
             "tag": rng.randint(0, 4, (5, T)).astype(np.int64),
             "len": np.asarray([[6], [2], [4], [6], [1]], np.int64)}

    def case(fl):
        ids = fl.layers.data(name="ids", shape=[T, 1], dtype="int64")
        tag = fl.layers.data(name="tag", shape=[T], dtype="int64")
        length = fl.layers.data(name="len", shape=[1], dtype="int64")
        emb = fl.layers.embedding(ids, size=[20, 8])
        emission = fl.layers.fc(input=emb, size=4, num_flatten_dims=2)
        crf = fl.layers.linear_chain_crf(
            emission, tag, length=length,
            param_attr=fl.ParamAttr(name="crf_w"))
        avg = fl.layers.mean(crf)
        decode = fl.layers.crf_decoding(
            emission, param_attr=fl.ParamAttr(name="crf_w"), length=length)
        fl.optimizer.Adam(learning_rate=0.05).minimize(avg)
        return [avg, decode]

    both(case, feeds, steps=2, tol=PROGRAM_TOL)


def test_text_conv_lod(rng):
    """build_text_conv at narrow widths over LoD ids: the port's program
    (LoD sequence_conv_pools, which the JAX layer cannot build) run by
    both Executors from the same state over two Adam steps: the loss and
    every parameter's gradient agree."""
    main, startup, loss = chip_smoke.build_text_conv(pt, vocab=40, emb=6,
                                                     filters=5)
    fetch = [loss.name] + [p.name + "@GRAD" for p in main.all_parameters()]
    lens = [4, 1, 6, 2]
    off = np.concatenate([[0], np.cumsum(lens)]).tolist()
    feed = {"ids": (rng.randint(0, 40, (off[-1], 1)).astype(np.int64),
                    [off]),
            "label": rng.randint(0, 2, (4, 1)).astype(np.int64)}
    scope = pt.Scope()
    port = pt.Executor(pt.CPUPlace())
    port.run(startup, scope=scope)

    def as_json(p):
        return json.loads(json.dumps(p.to_dict(),
                                     default=lambda b: {"__block__": b.idx}))

    jmain = fluid.Program.from_dict(as_json(main))
    jexe = fluid.Executor(fluid.CPUPlace())
    jscope = fluid.global_scope()
    for n, v in scope.values.items():
        jscope.values[n] = jax.numpy.asarray(v.numpy())
    for _ in range(2):
        want = jexe.run(jmain, feed=feed, fetch_list=fetch)
        got = port.run(main, feed=feed, fetch_list=fetch, scope=scope)
        for n, g, w in zip(fetch, got, want):
            compare(n, g, w, PROGRAM_TOL)
