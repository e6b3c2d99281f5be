"""v1 generation on the port (``paddle_tpu_torch/generation.py``,
``decode/seq2seq.py``, ``GenerationEngine.for_seq2seq``, ``load_generator``
with a ``make_generator()`` script, ``paddle.infer`` on a ``beam_search``
output, ``api.SequenceGenerator``) against the JAX package, on the CPU.

Each spec is built with either package's ``trainer_config_helpers`` (the
same function, given the package) after both packages' programs and
layer counters are reset.  The JAX package's generator initialises the
weights; the port's reads them as numpy (``Scope.load_numpy``), so its
startup programs find every name and run nothing.

Tolerances: the programs equal (``to_dict`` through JSON); token ids and
beams exactly equal, beam scores within SCORE_TOL (float32 log
probabilities summed over up to 9 steps, the ops in another order).
"""

import json
import os
import tarfile

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.trainer_config_helpers as jtch
import paddle_tpu.v2 as jpaddle
import paddle_tpu_torch as pt
import paddle_tpu_torch.api  # noqa: F401
import paddle_tpu_torch.decode  # noqa: F401
import paddle_tpu_torch.trainer_config_helpers as ptch
import paddle_tpu_torch.v2 as ppaddle
from test_torch_demos import one_torch_thread, program_dict  # noqa: F401

SCORE_TOL = 1e-5
BOS, EOS = 0, 1
SRCS = [[4, 7, 2], [3, 9, 5, 6], [2, 2, 11, 8, 1], [5, 5],
        [9, 8, 7, 6, 5, 4], [1, 12, 13], [6, 3, 14, 2, 9, 10, 4]]


def _reset(paddle):
    paddle.layer._counter[0] = 0


def demo_spec(tch, paddle, beam_size=3, max_length=7):
    """The NMT demo's spec (``demos/seq2seq/gen_config.py``) of either
    package."""
    if tch is jtch:
        from demos.seq2seq.gen_config import make_beam_gen
    else:
        from paddle_tpu_torch.demos.seq2seq.gen_config import make_beam_gen
    return make_beam_gen(beam_size=beam_size, max_length=max_length)


def group_spec(tch, paddle, boot=False, beam_size=3, max_length=6):
    """``tests/test_recurrent_group.py:179``'s decoder step over a static
    context vector; with ``boot`` its memory starts from a projection of
    that context."""
    V, E, H = 8, 12, 16
    ctxv = paddle.layer.data(name="ctx",
                             type=paddle.data_type.dense_vector(H))

    def decoder_step(word_emb, c):
        mem = tch.memory(name="dec_h", size=H, boot_layer=(
            paddle.layer.fc(input=ctxv, size=H, act=paddle.activation.Tanh(),
                            param_attr=paddle.attr.Param(name="w_boot"),
                            bias_attr=False) if boot else None))
        h = paddle.layer.fc(input=[word_emb, mem, c], size=H, act="tanh",
                            name="dec_h",
                            param_attr=[paddle.attr.Param(name="w_in"),
                                        paddle.attr.Param(name="w_rec"),
                                        paddle.attr.Param(name="w_ctx")],
                            bias_attr=False)
        return paddle.layer.fc(input=h, size=V, act="softmax",
                               name="dec_out",
                               param_attr=paddle.attr.Param(name="w_out"),
                               bias_attr=False)

    return tch.beam_search(
        step=decoder_step,
        input=[tch.GeneratedInput(size=V, embedding_name="tgt_emb",
                                  embedding_size=E),
               tch.StaticInput(ctxv, size=H)],
        bos_id=BOS, eos_id=EOS, beam_size=beam_size, max_length=max_length)


SPECS = {"demo": demo_spec, "group": group_spec,
         "group_boot": lambda t, p: group_spec(t, p, boot=True)}


class JaxParams:
    def __init__(self):
        from paddle_tpu.executor import Scope

        self.scope = Scope()


class PortParams:
    """Parameters on the CPU holding the JAX package's values."""

    def __init__(self, jparams):
        from paddle_tpu_torch.executor import Scope

        self.place = pt.CPUPlace()
        self.scope = Scope()
        self.scope.load_numpy(weights_of(jparams),
                              self.place.device())


def weights_of(jparams):
    return {n: np.asarray(v) for n, v in jparams.scope.values.items()}


def build_pair(spec, make):
    """(JAX object, its params, port object, its params): ``make(bg,
    params)`` of ``spec`` in both packages, the JAX one first (it
    initialises the weights), the port's on the CPU from them."""
    fluid.framework.reset_default_programs()
    _reset(jpaddle)
    jparams = JaxParams()
    jobj = make(spec(jtch, jpaddle), jparams, None)
    pt.framework.reset_default_programs()
    _reset(ppaddle)
    pparams = PortParams(jparams)
    pobj = make(spec(ptch, ppaddle), pparams, pt.CPUPlace())
    assert set(pparams.scope.keys()) == set(jparams.scope.keys())
    return jobj, jparams, pobj, pparams


def jax_generator_class():
    """The JAX package's SequenceGenerator, its boot run given zero step
    feeds: its Executor runs every op of the step program, so fetching a
    memory's boot with the static feeds alone raises there (the port's
    generator feeds the zeros itself; no boot expression reads them)."""
    from paddle_tpu.generation import SequenceGenerator

    class BootFed(SequenceGenerator):
        def _run(self, feed, fetch):
            if "@gen_word" not in feed:
                feed = dict(feed)
                feed["@gen_word"] = np.zeros((1, 1), np.int64)
                for n, m in zip(self._state_names, self.bg.memories):
                    feed[n] = np.zeros((1, m.size), np.float32)
            return super()._run(feed, fetch)

    return BootFed


def generator(bg, params, place):
    if place is None:
        return jax_generator_class()(bg, params)
    from paddle_tpu_torch.generation import SequenceGenerator

    return SequenceGenerator(bg, params, place=place)


def rows_of(name, n=4):
    """Input rows of a spec: source ids for the demo, context vectors
    for the group steps."""
    if name == "demo":
        return [[s] for s in SRCS[:n]]
    r = np.random.RandomState(3)
    return [[(2.0 * r.randn(16)).astype(np.float32).tolist()]
            for _ in range(n)]


def same_beams(got, want):
    assert [ids for _, ids in got] == [ids for _, ids in want], (got, want)
    for (gs, _), (ws, _) in zip(got, want):
        assert abs(gs - ws) <= SCORE_TOL, (gs, ws)


@pytest.fixture(scope="module", params=sorted(SPECS))
def gen_pair(request):
    name = request.param
    jg, jparams, pg, pparams = build_pair(SPECS[name], generator)
    return name, jg, jparams, pg, pparams


# ---------------------------------------------------------------------------
# the spec, SequenceGenerator
# ---------------------------------------------------------------------------


def test_beam_search_spec_builds_the_jax_step_program(gen_pair):
    name, jg, _, pg, _ = gen_pair
    assert program_dict(pg._main) == program_dict(jg._main)
    assert pg._state_names == jg._state_names
    assert ([v.name for v in pg._new_state_vars]
            == [v.name for v in jg._new_state_vars])
    assert pg._probs_var.name == jg._probs_var.name
    assert [type(v).__name__ for v in pg._boot_vars] == [
        type(v).__name__ for v in jg._boot_vars]
    assert (pg.bg.bos_id, pg.bg.eos_id, pg.bg.beam_size, pg.bg.max_length) \
        == (jg.bg.bos_id, jg.bg.eos_id, jg.bg.beam_size, jg.bg.max_length)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_generate_matches_jax(gen_pair, k):
    name, jg, _, pg, _ = gen_pair
    for row in rows_of(name):
        want = jg.generate(row, beam_size=k)
        got = pg.generate(row, beam_size=k)
        assert want, (name, row)
        same_beams(got, want)


def test_generate_greedy_matches_jax(gen_pair):
    name, jg, _, pg, _ = gen_pair
    for row in rows_of(name):
        assert pg.generate_greedy(row) == jg.generate_greedy(row)
        assert (pg.generate_greedy(row, max_length=3)
                == jg.generate_greedy(row, max_length=3))


def test_generate_refuses_what_jax_refuses(gen_pair):
    name, _, _, pg, _ = gen_pair
    with pytest.raises(ValueError, match="beam_size"):
        pg.generate(rows_of(name)[0], beam_size=0)
    assert pg.place == pt.CPUPlace()


def test_startup_runs_only_for_missing_names():
    """A scope holding some of the names keeps them; the startup fills
    the rest (``run_startup_for_missing``)."""
    from paddle_tpu_torch.executor import Scope
    from paddle_tpu_torch.generation import SequenceGenerator

    pt.framework.reset_default_programs()
    _reset(ppaddle)

    class P:
        scope = Scope()

    w = np.full((16, 24), 0.25, np.float32)
    P.scope.load_numpy({"trg_emb": w}, "cpu")
    SequenceGenerator(demo_spec(ptch, ppaddle), P, place=pt.CPUPlace())
    np.testing.assert_array_equal(P.scope.get("trg_emb").numpy(), w)
    assert {"src_emb", "enc_gru_w", "dec_w_out", "attn_w"} <= set(
        P.scope.keys())


def test_spec_surface():
    from paddle_tpu_torch.generation import BeamGen, GeneratedInput
    from paddle_tpu_torch.trainer_config_helpers import layers as pl

    assert {"beam_search", "GeneratedInput"} <= set(pl.__all__)
    assert ptch.GeneratedInput is GeneratedInput
    assert ppaddle.layer.beam_search is ptch.beam_search
    assert ppaddle.layer.GeneratedInput is GeneratedInput
    assert ptch.BaseGeneratedInput.__name__ == "BaseGeneratedInput"
    pt.framework.reset_default_programs()
    bg = group_spec(ptch, ppaddle)
    assert isinstance(bg, BeamGen)
    assert [p.name for p in bg.parents] == ["ctx"]
    assert len(bg.memories) == 1 and bg.step_out.size == 8
    with pytest.raises(ValueError, match="exactly one GeneratedInput"):
        ptch.beam_search(step=lambda c: c,
                         input=[ptch.StaticInput(bg.parents[0], size=16)],
                         bos_id=0, eos_id=1)


def test_card_is_the_default_place():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this checks the refusal without a CUDA device")
    from paddle_tpu_torch.executor import Scope
    from paddle_tpu_torch.generation import SequenceGenerator

    class P:
        scope = Scope()

    pt.framework.reset_default_programs()
    bg = group_spec(ptch, ppaddle)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        SequenceGenerator(bg, P)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        pt.api.SequenceGenerator(bg, P)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        pt.decode.GenerationEngine.for_seq2seq(demo_spec(ptch, ppaddle), P)


# ---------------------------------------------------------------------------
# paddle.infer on a BeamGen, api.SequenceGenerator
# ---------------------------------------------------------------------------


class _Infer:
    def __init__(self, field):
        self.field = field

    def __call__(self, bg, params, place):
        # the Inference built now: its generator initialises the JAX
        # package's weights before the port reads them
        paddle = jpaddle if place is None else ppaddle
        inference = paddle.inference.Inference(bg, params)
        return lambda rows: inference.infer(rows, field=self.field)


@pytest.mark.parametrize("field", ["id", "value"])
def test_infer_on_a_beam_gen_matches_jax(field):
    jinfer, _, pinfer, _ = build_pair(group_spec, _Infer(field))
    rows = rows_of("group", 3)
    want, got = jinfer(rows), pinfer(rows)
    assert len(got) == len(want) == 3
    if field == "id":
        assert got == want
        assert all(0 <= t < 8 for ids in got for t in ids)
    else:
        for g, w in zip(got, want):
            same_beams(g, w)


def test_infer_of_a_generation_output_runs_where_its_parameters_live():
    """The parameters' place is the generator's."""
    from paddle_tpu_torch.v2.inference import Inference

    pt.framework.reset_default_programs()
    params = PortParams(JaxParams())
    inference = Inference(group_spec(ptch, ppaddle), params)
    assert inference._gen.place == params.place == pt.CPUPlace()
    assert {"w_in", "w_out", "tgt_emb"} <= set(params.scope.keys())


def test_api_sequence_generator_matches_jax():
    def make(bg, params, place):
        if place is None:
            from paddle_tpu import api

            return api.SequenceGenerator(bg, params)
        return pt.api.SequenceGenerator(bg, params, place=place)

    jgen, _, pgen, _ = build_pair(demo_spec, make)
    for row in rows_of("demo"):
        same_beams(pgen.generate(row), jgen.generate(row))


# ---------------------------------------------------------------------------
# the paged engine: GenerationEngine.for_seq2seq on CPUPlace()
# ---------------------------------------------------------------------------

ENGINE = dict(num_pages=24, page_size=8, pages_per_seq=2, max_slots=3,
              max_new_tokens=7, beam_max=3)


@pytest.fixture(scope="module")
def engines():
    """(JAX oracle, JAX engine, port oracle, port engine) over one set of
    weights: the demo's spec with beam 1, max_length 7."""
    from paddle_tpu.decode.engine import GenerationEngine as JaxEngine
    from paddle_tpu_torch.decode import GenerationEngine

    def make(bg, params, place):
        spec = (jtch, jpaddle) if place is None else (ptch, ppaddle)
        oracle = generator(bg, params, place)
        bg2 = demo_spec(*spec, beam_size=1, max_length=7)
        if place is None:
            return oracle, JaxEngine.for_seq2seq(bg2, params, **ENGINE)
        return oracle, GenerationEngine.for_seq2seq(bg2, params, place=place,
                                                    **ENGINE)

    (jo, je), _, (po, pe), _ = build_pair(
        lambda t, p: demo_spec(t, p, beam_size=1, max_length=7), make)
    yield jo, je, po, pe
    je.stop()
    pe.stop()


def test_paged_programs_match_jax(engines):
    _, je, _, pe = engines
    for attr in ("_prefill_main", "_step_main"):
        assert (program_dict(getattr(pe.model, attr))
                == program_dict(getattr(je.model, attr))), attr
    assert pe.model.state_specs == je.model.state_specs
    assert pe.model.pool.data.shape == tuple(je.model.pool.data.shape)


def test_for_seq2seq_greedy_matches_jax_and_the_dense_oracle(engines):
    """Ragged requests, more than the slots: every reply equals the JAX
    engine's and the port's own dense oracle's, streamed in order, and
    every page goes back to the pool."""
    jo, je, po, pe = engines
    want = [po.generate_greedy([s]) for s in SRCS]
    assert want == [jo.generate_greedy([s]) for s in SRCS]
    streamed = {i: [] for i in range(len(SRCS))}
    reqs = [pe.submit(s, on_token=lambda t, i=i: streamed[i].append(t))
            for i, s in enumerate(SRCS)]
    got = [r.result(timeout=300) for r in reqs]
    jreqs = [je.submit(s) for s in SRCS]
    assert got == want == [r.result(timeout=300) for r in jreqs]
    assert [streamed[i] for i in range(len(SRCS))] == want
    assert pe.model.allocator.pages_in_use == 0
    assert je.model.allocator.pages_in_use == 0


@pytest.mark.parametrize("k", [1, 2, 3])
def test_for_seq2seq_beams_match_jax_and_the_dense_oracle(engines, k):
    jo, je, po, pe = engines
    for src in SRCS[:3]:
        want = po.generate([src], beam_size=k)
        same_beams(want, jo.generate([src], beam_size=k))
        req, jreq = pe.submit_beam(src, beam_size=k), je.submit_beam(
            src, beam_size=k)
        req.wait(300)
        jreq.wait(300)
        assert req.beams is not None, (src, k, req.finish_reason)
        same_beams(req.beams, want)
        same_beams(req.beams, jreq.beams)
    assert pe.model.allocator.pages_in_use == 0


def test_for_seq2seq_refusals_match_jax(engines):
    from paddle_tpu_torch.decode import AdmissionRefused

    _, je, _, pe = engines
    too_long = list(range(2, 12)) + [2] * 7     # pads to 32 > 16 rows
    with pytest.raises(AdmissionRefused) as ei:
        pe.submit(too_long)
    assert ei.value.reason == "too_long"
    with pytest.raises(AdmissionRefused) as ei:
        pe.submit_beam([4, 7, 2], beam_size=4)
    assert ei.value.reason == "beam_too_wide"
    assert pe.info() == je.info()


def test_paged_pool_is_the_device_tensor_fed_each_step(engines):
    """The decode step is fed the pool's own tensor (no host copy), and
    the encoder's rows land in the pages the prefill was given."""
    _, _, po, pe = engines
    m = pe.model
    seen = []
    run = m._exe.run

    def spy(program, feed=None, **kw):
        if program is m._step_main:
            seen.append(feed["@dec_pool"])
        return run(program, feed=feed, **kw)

    m._exe.run = spy
    try:
        pe.submit([4, 7, 2]).result(timeout=300)
    finally:
        m._exe.run = run
    assert seen and all(t is m.pool.data for t in seen)
    pages = m.allocator.alloc(2)
    try:
        m.prefill([[4, 7, 2]], pages)
        base = m._feeder.feed([[[4, 7, 2]]])
        enc = m._exe.run(m._prefill_main, feed=base,
                         fetch_list=[m._enc_var], scope=m._scope)[0]
        np.testing.assert_array_equal(
            m.pool.data[pages].reshape(-1, enc.shape[-1]).numpy(), enc[0])
    finally:
        m.allocator.free(pages)


# ---------------------------------------------------------------------------
# load_generator with a make_generator() script, the demo's gen config
# ---------------------------------------------------------------------------

GEN_SCRIPT = """\
import paddle_tpu_torch as pt
import paddle_tpu_torch.api  # noqa: F401
import paddle_tpu_torch.decode  # noqa: F401
from paddle_tpu_torch.demos.seq2seq.gen_config import make_beam_gen
from paddle_tpu_torch.executor import Scope


class Params:
    scope = Scope()
    place = pt.CPUPlace()


def make_generator():
    return make_beam_gen(beam_size=1, max_length=6), Params()
"""


def _args(script, **kw):
    from paddle_tpu_torch.serving.__main__ import serve_parser

    flags = [f"--gen_config={script}", "--cpu"] + [
        f"--{k}={v}" for k, v in kw.items()]
    return serve_parser("test").parse_args(flags)


def test_load_generator_serves_a_make_generator_script(tmp_path):
    from paddle_tpu_torch.generation import SequenceGenerator
    from paddle_tpu_torch.serving.__main__ import load_generator

    script = tmp_path / "gen.py"
    script.write_text(GEN_SCRIPT)
    pt.framework.reset_default_programs()
    engine = load_generator(_args(script, gen_pages=12, gen_page_size=4,
                                  gen_pages_per_seq=5, gen_slots=2,
                                  beam_max=2))
    try:
        m = engine.model
        assert (m.pool.num_pages, m.page_size, m.pages_per_seq) == (12, 4, 5)
        info = engine.info()
        assert (info["slots"], info["beam_max"]) == (2, 2)
        assert info["max_new_tokens"] == 6       # the spec's max_length
        assert m.place == pt.CPUPlace()
        oracle = SequenceGenerator(m.bg, type("P", (), {
            "scope": m._scope})(), place=pt.CPUPlace())
        reqs = [engine.submit(s) for s in SRCS[:4]]
        assert ([r.result(timeout=300) for r in reqs]
                == [oracle.generate_greedy([s]) for s in SRCS[:4]])
        assert m.allocator.pages_in_use == 0
    finally:
        engine.stop()
    engine = load_generator(_args(script, gen_max_tokens=3))
    try:
        m = engine.model
        assert (m.pool.num_pages, m.page_size, m.pages_per_seq) == (64, 8, 2)
        assert engine.info()["max_new_tokens"] == 3
    finally:
        engine.stop()


def test_serve_flags_match_the_reference_cli(tmp_path):
    """The reference's defaults: 64 pages of 8, 2 a sequence; without
    ``--gen_max_tokens`` a make_decode_model() engine's budget is 32."""
    from paddle_tpu_torch.serving.__main__ import load_generator, serve_parser

    args = serve_parser("test").parse_args(["--gen_config=x.py"])
    assert (args.gen_pages, args.gen_page_size, args.gen_pages_per_seq,
            args.gen_max_tokens) == (64, 8, 2, None)
    script = tmp_path / "lm.py"
    script.write_text(
        "import paddle_tpu_torch as pt\n"
        "from paddle_tpu_torch.decode.model import TinyDecoderLM\n"
        "def make_decode_model():\n"
        "    return TinyDecoderLM(vocab=16, d_model=8, num_heads=2, "
        "num_layers=1, num_pages=8, page_size=4, pages_per_seq=2, "
        "place=pt.CPUPlace())\n")
    engine = load_generator(_args(script))
    try:
        assert engine.info()["max_new_tokens"] == 32
    finally:
        engine.stop()


def test_demo_gen_config_serves_a_tar_like_the_jax_demo(tmp_path,
                                                        monkeypatch):
    """``PADDLE_GEN_PARAMS`` names a Parameters tar of the JAX package's
    weights: the port's demo config serves the JAX demo generator's
    greedy tokens, and ``PADDLE_GEN_MAXLEN`` is the budget."""
    from paddle_tpu_torch.serving.__main__ import load_generator
    from paddle_tpu_torch.v2.parameters import write_npy_tar

    jg, jparams, _, _ = build_pair(
        lambda t, p: demo_spec(t, p, beam_size=1, max_length=5),
        lambda bg, params, place: generator(bg, params, place))
    tar = tmp_path / "params.tar"
    with open(tar, "wb") as f:
        write_npy_tar(sorted(weights_of(jparams).items()), f)
    with tarfile.open(tar) as t:
        assert len(t.getmembers()) == len(jparams.scope.values)
    monkeypatch.setenv("PADDLE_GEN_PARAMS", str(tar))
    monkeypatch.setenv("PADDLE_GEN_MAXLEN", "5")
    config = os.path.join(os.path.dirname(pt.__file__), "demos", "seq2seq",
                          "gen_config.py")
    pt.framework.reset_default_programs()
    engine = load_generator(_args(config, gen_slots=2))
    try:
        assert engine.info()["max_new_tokens"] == 5
        reqs = [engine.submit(s) for s in SRCS[:4]]
        assert ([r.result(timeout=300) for r in reqs]
                == [jg.generate_greedy([s]) for s in SRCS[:4]])
    finally:
        engine.stop()


def test_generate_over_http_matches_jax(engines):
    """``POST /generate`` on the port's server over the seq2seq engine:
    the ndjson token lines equal the JAX engine's tokens."""
    import urllib.request

    from paddle_tpu_torch.serving import InferenceServer

    jo, _, _, pe = engines
    srv = InferenceServer(None, generator=pe, place=pt.CPUPlace())
    try:
        for src in SRCS[:3]:
            req = urllib.request.Request(
                f"http://{srv.address}/generate",
                data=json.dumps({"src": src, "max_new_tokens": 7}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                lines = [json.loads(ln) for ln in r.read().splitlines()
                         if ln.strip()]
            toks = [ln["token"] for ln in lines[:-1]]
            assert toks == lines[-1]["ids"] == jo.generate_greedy([src])
    finally:
        srv._httpd.shutdown()


def test_paddle_compile_exports_the_seq2seq_plans(tmp_path, capsys):
    """``paddle compile --gen_config`` over a make_generator() script
    (``--cpu``): the prefill and decode plans go into the artifact, both
    capturable (fixed shapes, no random op, no host read)."""
    from paddle_tpu_torch.aot.compile_cli import main

    script = tmp_path / "gen.py"
    script.write_text(GEN_SCRIPT)
    out = tmp_path / "art"
    pt.framework.reset_default_programs()
    assert main([f"--gen_config={script}", f"--out={out}", "--cpu"]) == 0
    with open(out / "MANIFEST.json") as f:
        manifest = json.load(f)
    sigs = [json.dumps(e) for e in manifest["entries"]]
    assert len(sigs) == 2
    assert any("@dec_pool" in s for s in sigs)
    assert any("src@len" in s for s in sigs)
    assert "captures=True" in capsys.readouterr().out
