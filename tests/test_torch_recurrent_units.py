"""``trainer/recurrent_units.py`` and the small v1 helper modules
(``trainer/PyDataProviderWrapper.py``, ``trainer/config_parser_extension.py``,
``trainer_config_helpers/{default_decorators,utils,config_parser_utils}.py``)
on the port, against the JAX package, on the CPU, on the cases of
``tests/test_recurrent_units.py`` and ``tests/test_v1_api.py``.

Each net is built with either package's modules (``check_case`` of
``test_torch_v2_surface.py``: the Programs equal, every parameter set to
the same seeded values, ``paddle.infer`` within FWD_TOL of the JAX
package's outputs).  The reference's own equivalences (a layer group
against the proven group of the same weights, shared ``para_prefix``)
then hold on the port's outputs, to EQUIV_TOL as there.  A GRU unit as
the decoder step of a ``beam_search`` spec generates the JAX package's
beams (ids equal, scores within 1e-5).
"""

import importlib
import logging

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest

import paddle_tpu_torch as pt
import paddle_tpu_torch.trainer_config_helpers as ptch
import paddle_tpu_torch.v2 as ppaddle
from test_torch_demos import one_torch_thread  # noqa: F401
from test_torch_generation import build_pair, generator, same_beams
from test_torch_v2_surface import check_case

EQUIV_TOL = dict(rtol=1e-5, atol=1e-6)


def _pkg(tch):
    """The package (``paddle_tpu`` or ``paddle_tpu_torch``) of ``tch``."""
    return tch.__name__.split(".")[0]


def _ru(tch):
    return importlib.import_module(_pkg(tch) + ".trainer.recurrent_units")


def _attr(tch, name, zero=False):
    pa = importlib.import_module(_pkg(tch) + ".param_attr").ParamAttr
    if not zero:
        return pa(name=name)
    init = importlib.import_module(_pkg(tch) + ".initializer")
    return pa(name=name, initializer=init.ConstantInitializer(0.0))


def _rows(n, lens, dim, seed=9):
    rng = np.random.RandomState(seed)
    return [[[rng.randn(dim).astype("float32").tolist()
              for _ in range(ln)]] for ln in lens[:n]]


def _x(paddle, d):
    return paddle.layer.data(
        name="x", type=paddle.data_type.dense_vector_sequence(d))


def lstm_groups(tch, paddle, D=4, H=6):
    x = _x(paddle, D)
    a = _ru(tch).LstmRecurrentLayerGroup(
        name="lstmA", size=H, active_type="tanh",
        state_active_type="tanh", gate_active_type="sigmoid",
        inputs=[tch.full_matrix_projection(input=x,
                                           param_attr=_attr(tch, "W_x"))],
        para_prefix="shared")
    with tch.mixed_layer(size=4 * H, bias_attr=_attr(
            tch, "shared_input_recurrent.b", zero=True)) as proj:
        proj += tch.full_matrix_projection(input=x,
                                           param_attr=_attr(tch, "W_x"))
    b = tch.networks.lstmemory_group(
        input=proj._lo, size=H,
        param_attr=_attr(tch, "shared_input_recurrent.w"),
        lstm_bias_attr=_attr(tch, "shared_check.b"),
        input_proj_bias_attr=False)
    return tch.concat_layer(input=[tch.last_seq(input=a),
                                   tch.last_seq(input=b)])


def gru_groups(tch, paddle, D=4, H=5):
    x = _x(paddle, D)
    a = _ru(tch).GatedRecurrentLayerGroup(
        name="gruA", size=H, active_type="tanh",
        gate_active_type="sigmoid",
        inputs=[tch.full_matrix_projection(input=x,
                                           param_attr=_attr(tch, "Wg_x"))],
        para_prefix="gshare")
    with tch.mixed_layer(size=3 * H, bias_attr=_attr(
            tch, "gshare_input_proj.b", zero=True)) as proj:
        proj += tch.full_matrix_projection(input=x,
                                           param_attr=_attr(tch, "Wg_x"))
    b = tch.networks.gru_group(
        input=proj._lo, size=H,
        gru_param_attr=_attr(tch, "gshare_gate_weight"),
        gru_bias_attr=_attr(tch, "gshare_gate_bias"))
    return tch.concat_layer(input=[tch.last_seq(input=a),
                                   tch.last_seq(input=b)])


def test_lstm_layer_group_matches_lstmemory_group():
    """LstmRecurrentLayerGroup == lstmemory_group when every parameter is
    shared by name."""
    got = _equal_halves(lstm_groups, _rows(3, [5, 3, 4], 4), 6)
    assert np.abs(got[:, :6]).max() > 1e-4


def test_gru_layer_group_matches_gru_group():
    got = _equal_halves(gru_groups, _rows(3, [4, 2, 6], 4), 5)
    assert np.abs(got[:, :5]).max() > 1e-4


def run_both(case, rows):
    """``case`` on both packages (``build_both``: the Programs equal,
    seeded weights), the mixed layers' biases at their initial zeros
    (``mixed_layer`` names its bias ``mixed_bias_N.b_0`` in both packages,
    whatever its ``bias_attr`` says, so towers do not share it); the
    port's output within FWD_TOL of the JAX package's."""
    import test_torch_v2_surface as surface

    (jouts, jparams), (pouts, pparams) = surface.build_both(case)
    for n in jparams.keys():
        if n.startswith("mixed_bias"):
            w = np.zeros(jparams.get_shape(n), np.float32)
            jparams.set(n, w)
            pparams.set(n, w)
    want = np.asarray(jpaddle_infer(jouts, jparams, rows))
    got = np.asarray(ppaddle.infer(output_layer=pouts, parameters=pparams,
                                   input=rows))
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=surface.FWD_TOL,
                               atol=surface.FWD_TOL * np.abs(want).max())
    return got, pparams


def _equal_halves(case, rows, H):
    """The port's two towers equal on the same weights."""
    got, _ = run_both(case, rows)
    assert got.shape == (len(rows), 2 * H)
    np.testing.assert_allclose(got[:, :H], got[:, H:], **EQUIV_TOL)
    return got


def jpaddle_infer(outs, params, rows):
    import paddle_tpu.v2 as jpaddle

    return jpaddle.infer(output_layer=outs, parameters=params, input=rows)


def test_unit_inside_user_recurrent_group():
    """GatedRecurrentUnit inside a user step function, the reference's
    calling convention."""

    def case(tch, paddle):
        x = _x(paddle, 3)

        def step(x_t):
            return _ru(tch).GatedRecurrentUnit(
                name="g1", size=4, active_type="tanh",
                gate_active_type="sigmoid",
                inputs=[tch.full_matrix_projection(input=x_t)])

        return tch.last_seq(input=tch.recurrent_group(step=step, input=x))

    got = check_case(case, _rows(2, [3, 5], 3))
    assert got[0].shape == (2, 4)


def test_lstm_unit_inside_user_recurrent_group():
    def case(tch, paddle):
        x = _x(paddle, 3)

        def step(x_t):
            return _ru(tch).LstmRecurrentUnit(
                name="l1", size=4, active_type="tanh",
                state_active_type="tanh", gate_active_type="sigmoid",
                inputs=[tch.full_matrix_projection(input=x_t)])

        return tch.last_seq(input=tch.recurrent_group(step=step, input=x))

    got = check_case(case, _rows(3, [2, 5, 4], 3))
    assert got[0].shape == (3, 4)


def test_para_prefix_shares_parameters():
    """Two layer groups with one para_prefix share weights; distinct
    prefixes do not."""

    def case(tch, paddle):
        x = _x(paddle, 3)

        def mk(nm, pp):
            return _ru(tch).LstmRecurrentLayerGroup(
                name=nm, size=4, active_type="tanh",
                state_active_type="tanh", gate_active_type="sigmoid",
                inputs=[tch.full_matrix_projection(
                    input=x, param_attr=_attr(tch, "W_shared_in"))],
                para_prefix=pp)

        return tch.concat_layer(input=[tch.last_seq(input=mk(*a)) for a in (
            ("u1", "pfx"), ("u2", "pfx"), ("u3", "other"))])

    got, pparams = run_both(case, _rows(2, [4, 3], 3))
    assert {"pfx_input_recurrent.w", "other_input_recurrent.w"} <= set(
        pparams.keys())
    np.testing.assert_allclose(got[:, :4], got[:, 4:8], rtol=1e-6)
    assert not np.allclose(got[:, :4], got[:, 8:])


@pytest.mark.parametrize("act", ["", "linear", "relu", "softmax"])
def test_active_type_strings(act):
    def case(tch, paddle):
        x = _x(paddle, 3)
        return tch.last_seq(input=_ru(tch).GatedRecurrentLayerGroup(
            name="gs", size=4, active_type=act, gate_active_type="sigmoid",
            inputs=[tch.full_matrix_projection(input=x)]))

    check_case(case, _rows(2, [3, 2], 3))


def test_unknown_active_type_raises_like_jax():
    from paddle_tpu.trainer import recurrent_units as jru
    from paddle_tpu_torch.trainer import recurrent_units as pru

    for ru in (jru, pru):
        with pytest.raises(ValueError, match="unknown active_type"):
            ru._act("swish")


def test_gru_unit_as_a_generation_step_matches_jax():
    """A GatedRecurrentUnit decoder inside ``beam_search``: the port's
    SequenceGenerator gives the JAX package's beams."""
    V, E, H = 8, 6, 10

    def spec(tch, paddle):
        ctxv = paddle.layer.data(name="ctx",
                                 type=paddle.data_type.dense_vector(H))

        def step(word, c):
            h = _ru(tch).GatedRecurrentUnit(
                name="dec", size=H, active_type="tanh",
                gate_active_type="sigmoid",
                inputs=[tch.full_matrix_projection(input=word),
                        tch.full_matrix_projection(input=c)])
            return paddle.layer.fc(input=h, size=V, act="softmax",
                                   param_attr=paddle.attr.Param(name="w_o"),
                                   bias_attr=False)

        return tch.beam_search(
            step=step,
            input=[tch.GeneratedInput(size=V, embedding_name="emb",
                                      embedding_size=E),
                   tch.StaticInput(ctxv, size=H)],
            bos_id=0, eos_id=1, beam_size=3, max_length=6)

    jg, _, pg, _ = build_pair(spec, generator)
    rng = np.random.RandomState(5)
    for _ in range(3):
        row = [(2.0 * rng.randn(H)).astype(np.float32).tolist()]
        for k in (1, 3):
            same_beams(pg.generate(row, beam_size=k),
                       jg.generate(row, beam_size=k))
        assert pg.generate_greedy(row) == jg.generate_greedy(row)


# ---------------------------------------------------------------------------
# PyDataProviderWrapper, config_parser_extension
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["paddle_tpu", "paddle_tpu_torch"])
def test_pydataprovider_wrapper_shim(pkg):
    w = importlib.import_module(pkg + ".trainer.PyDataProviderWrapper")

    with pytest.warns(DeprecationWarning):
        @w.provider(slots=[w.DenseSlot(4), w.IndexSlot(3)],
                    pool_size=w.PoolSize(16))
        def process(obj, filename):
            for i in range(3):
                yield [float(i)] * 4, i % 3

    types = process.input_types
    assert (types[0].dim, types[1].dim) == (4, 3)
    rows = list(process(None))
    assert len(rows) == 3 and rows[1][1] == 1
    assert w.SparseNonValueSlot(7).to_input_type().dim == 7
    assert w.SparseValueSlot(5).to_input_type().dim == 5
    with pytest.raises(TypeError):
        w.StringSlot().to_input_type()
    seen = {}
    hook = w.init_hook_wrapper(lambda s, file_list, **kw: seen.update(
        files=file_list, **kw))
    hook(None, ["a"], k=1)
    assert seen == {"files": ["a"], "k": 1}


def test_pydataprovider_wrapper_types_match_jax():
    from paddle_tpu.trainer import PyDataProviderWrapper as jw
    from paddle_tpu_torch.trainer import PyDataProviderWrapper as pw

    for cls, dim in (("DenseSlot", 4), ("SparseNonValueSlot", 9),
                     ("SparseValueSlot", 6), ("IndexSlot", 3)):
        jt = getattr(jw, cls)(dim).to_input_type()
        pt_ = getattr(pw, cls)(dim).to_input_type()
        assert (type(pt_).__name__, vars(pt_)) == (type(jt).__name__,
                                                   vars(jt)), cls
    assert pw.__all__ == jw.__all__


@pytest.mark.parametrize("pkg", ["paddle_tpu", "paddle_tpu_torch"])
def test_config_parser_extension(pkg):
    ext = importlib.import_module(pkg + ".trainer.config_parser_extension")
    funcs = ext.get_config_funcs("cfg")
    d = funcs["SimpleData"](files="f.list", feat_dim=10)
    assert d["type"] == "simple" and d["feat_dim"] == 10
    assert ext.g_config == "cfg"


def test_config_parser_extension_matches_jax():
    from paddle_tpu.trainer import config_parser_extension as je
    from paddle_tpu_torch.trainer import config_parser_extension as pe

    args = dict(files="f.list", feat_dim=10, context_len=2,
                buffer_capacity=8)
    assert pe.SimpleData(**args) == je.SimpleData(**args)
    assert pe.__all__ == je.__all__


# ---------------------------------------------------------------------------
# default_decorators, utils, config_parser_utils
# ---------------------------------------------------------------------------


def test_helper_module_tail():
    """``tests/test_v1_api.py::test_helper_module_tail`` on the port."""
    import io

    from paddle_tpu_torch.param_attr import ParamAttr
    from paddle_tpu_torch.trainer_config_helpers.config_parser_utils import (
        parse_network_config, parse_optimizer_config, reset_parser)
    from paddle_tpu_torch.trainer_config_helpers.default_decorators import (
        wrap_bias_attr_default, wrap_name_default)
    from paddle_tpu_torch.trainer_config_helpers.utils import deprecated

    @deprecated("new_thing")
    def old_thing():
        return 42

    buf = io.StringIO()
    log = logging.getLogger("paddle_tpu_torch.trainer_config_helpers.utils")
    h = logging.StreamHandler(buf)
    log.addHandler(h)
    try:
        assert old_thing() == 42
    finally:
        log.removeHandler(h)
    assert "old_thing is deprecated" in buf.getvalue()
    assert "new_thing" in buf.getvalue()

    @wrap_name_default("mylayer")
    def make(name=None):
        return name

    assert make() == "__mylayer_0__"
    assert make() == "__mylayer_1__"
    assert make(name="explicit") == "explicit"

    @wrap_bias_attr_default()
    def biased(bias_attr=None):
        return bias_attr

    assert isinstance(biased(), ParamAttr)
    assert isinstance(biased(bias_attr=True), ParamAttr)
    assert biased(bias_attr=False) is False

    def net():
        x = ptch.data_layer(name="nx", size=4)
        ptch.outputs(ptch.fc_layer(input=x, size=2))

    view = parse_network_config(net)
    assert view.layer("nx")["type"] == "data"

    def opt():
        ptch.settings(batch_size=16, learning_rate=0.5)

    cfg = parse_optimizer_config(opt)
    assert cfg.get("batch_size") == 16
    reset_parser()
    assert pt.framework.default_main_program().global_block().ops == []


def test_default_decorators_match_jax():
    """Every decorator fills what the JAX package's fills, and the
    helper modules export the same names, also through the package."""
    from paddle_tpu.trainer_config_helpers import config_parser_utils as jcp
    from paddle_tpu.trainer_config_helpers import default_decorators as jd
    from paddle_tpu.trainer_config_helpers import utils as ju
    from paddle_tpu_torch.trainer_config_helpers import \
        config_parser_utils as pcp
    from paddle_tpu_torch.trainer_config_helpers import \
        default_decorators as pd
    from paddle_tpu_torch.trainer_config_helpers import utils as pu

    for j, p in ((jd, pd), (ju, pu), (jcp, pcp)):
        assert p.__all__ == j.__all__
    for n in pd.__all__ + pu.__all__:
        assert getattr(ptch, n) is getattr(pd if n in pd.__all__ else pu, n)
    assert ptch.config_parser_utils is pcp

    results = []
    for d in (jd, pd):
        @d.wrap_act_default()
        def act(act=None):
            return act

        @d.wrap_param_attr_default()
        def param(param_attr=None):
            return param_attr

        @d.wrap_bias_attr_default(has_bias=False)
        def nobias(bias_attr=None):
            return bias_attr

        @d.wrap_name_default()
        def auto_named(name=None):
            return name

        results.append((
            type(act()).__name__, act().name, type(param()).__name__,
            nobias(), type(nobias(bias_attr=True)).__name__,
            nobias(bias_attr=False), auto_named(), auto_named(),
            getattr(param, "argspec").args))
        d.reset_hook()
        results[-1] += (auto_named(),)
    assert results[0] == results[1]
    factory = pd.DefaultNameFactory("p")
    assert (factory(None), factory(None)) == ("__p_0__", "__p_1__")
    factory.reset()
    assert factory(None) == "__p_0__"


def test_lstm_unit_as_a_generation_step():
    """An LstmRecurrentUnit decoder inside ``beam_search``: its cell
    memory links (``set_input``) to a layer no step output reaches, which
    the JAX package's generator cannot find (KeyError) and the port's
    follows.  The port's greedy decode is its beam-1 search."""
    H, V = 6, 7

    def spec(tch, paddle):
        ctxv = paddle.layer.data(name="ctx",
                                 type=paddle.data_type.dense_vector(H))

        def step(word, c):
            h = _ru(tch).LstmRecurrentUnit(
                name="dec", size=H, active_type="tanh",
                state_active_type="tanh", gate_active_type="sigmoid",
                inputs=[tch.full_matrix_projection(input=word),
                        tch.full_matrix_projection(input=c)])
            return paddle.layer.fc(input=h, size=V, act="softmax",
                                   bias_attr=False)

        return tch.beam_search(
            step=step,
            input=[tch.GeneratedInput(size=V, embedding_name="emb",
                                      embedding_size=4),
                   tch.StaticInput(ctxv, size=H)],
            bos_id=0, eos_id=1, beam_size=2, max_length=5)

    with pytest.raises(KeyError, match="memory link"):
        build_pair(spec, generator)
    from paddle_tpu_torch.executor import Scope
    from paddle_tpu_torch.generation import SequenceGenerator

    class P:
        scope = Scope()

    pt.framework.reset_default_programs()
    gen = SequenceGenerator(spec(ptch, ppaddle), P, place=pt.CPUPlace())
    assert len(gen.bg.memories) == 2
    rng = np.random.RandomState(1)
    for _ in range(3):
        row = [(2.0 * rng.randn(H)).astype(np.float32).tolist()]
        beams = gen.generate(row)
        assert 1 <= len(beams) <= 2
        assert gen.generate(row, beam_size=1)[0][1] == gen.generate_greedy(
            row)
