"""The reference's fluid demos (``demos/gan``, ``demos/vae``,
``demos/model_zoo``) as the port's copies run them on the CPU, against
the JAX package: each program equals the JAX package's; gan's and
model_zoo's first two steps from the JAX package's initial state, on the
demo's own feeds, match (each loss within LOSS_TOL of its value,
every persistable after them within PARAM_TOL of its largest
magnitude).  model_zoo's ResNet-20 is held as the image cells' googlenet
and VGG-16 are (``test_torch_image_models.f32_ops_match_jax``): each
step's loss end to end within 1e-4 of its value, and every op of the
step on the JAX package's values of its inputs, since a relu input
within float32 rounding of zero passes its gradient in one package and
not in the other (at batch 32 such a flip in the last residual block
moves every earlier weight gradient by about 1%).  vae
draws its noise in the graph (a torch generator cannot replay JAX's
stream), so it is held by its program and its gate only.  Each passes
the reference test's gate (``tests/test_demos.py``)."""

import os

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.executor import Scope as JaxScope
from paddle_tpu.executor import scope_guard as jax_scope_guard

import demos.gan.train as jgan
import demos.model_zoo.infer as jzoo
import demos.vae.train as jvae
import paddle_tpu_torch.demos.gan.train as pgan
import paddle_tpu_torch.demos.model_zoo.infer as pzoo
import paddle_tpu_torch.demos.vae.train as pvae
from test_torch_demos import (LOSS_TOL, PARAM_TOL,  # noqa: F401
                              assert_programs_equal, close,
                              one_torch_thread)
from test_torch_image_models import _close, ops_on_the_jax_values



def _persistables(prog):
    return [v.name for v in prog.global_block().vars.values()
            if v.persistable]


def _carry(jscope, prog, pscope):
    pscope.load_numpy({n: np.asarray(jscope.get(n))
                       for n in _persistables(prog)
                       if jscope.get(n) is not None}, "cpu")


def _two_steps(jprog, pprog, jscope, pscope, feeds, fetch):
    jexe, pexe = fluid.Executor(fluid.CPUPlace()), pt.Executor(pt.CPUPlace())
    for i, feed in enumerate(feeds):
        with jax_scope_guard(jscope):
            want = jexe.run(jprog, feed=feed, fetch_list=fetch)
        got = pexe.run(pprog, feed=feed, fetch_list=fetch, scope=pscope)
        for name, g, w in zip(fetch, got, want):
            w = float(np.asarray(w).reshape(-1)[0])
            g = float(np.asarray(g).reshape(-1)[0])
            assert abs(g - w) <= LOSS_TOL * abs(w), (i, name, g, w)
    for n in _persistables(pprog):
        if jscope.get(n) is not None:
            close(pscope.get(n).numpy(), np.asarray(jscope.get(n)),
                  PARAM_TOL, n)


def test_gan_program_and_two_steps_match_the_jax_package():
    fluid.framework.reset_default_programs()
    jz, jr, _, jd, jg = jgan.build()
    jprog = fluid.default_main_program()
    jscope = JaxScope()
    with jax_scope_guard(jscope):
        fluid.Executor(fluid.CPUPlace()).run(fluid.default_startup_program())
    pt.framework.reset_default_programs()
    pz, pr, _, pd, pg = pgan.build()
    pprog = pt.default_main_program()
    assert_programs_equal(pprog, jprog)
    pscope = pt.Scope()
    _carry(jscope, pprog, pscope)
    rng = np.random.RandomState(0)
    feeds = [{pz: rng.randn(64, 8).astype(np.float32),
              pr: pgan.real_batch(rng, 64)} for _ in range(2)]
    _two_steps(jprog, pprog, jscope, pscope, feeds, [pd.name, pg.name])


def test_gan_trains_toward_target_distribution():
    dl, gl, samples = pgan.main(steps=300, verbose=False,
                                place=pt.CPUPlace())
    assert np.isfinite(dl) and np.isfinite(gl)
    radii = np.linalg.norm(samples, axis=1)
    assert 1.0 < radii.mean() < 3.5, radii.mean()
    real = pgan.real_batch(np.random.RandomState(0), 256)
    assert abs(radii.mean() - np.linalg.norm(real, axis=1).mean()) < 1.5


def test_vae_program_matches_the_jax_package():
    progs = []
    for pkg, demo in ((fluid, jvae), (pt, pvae)):
        pkg.framework.reset_default_programs()
        *_, loss = demo.build()
        pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
        progs.append(pkg.default_main_program())
    assert_programs_equal(progs[1], progs[0])
    assert "gaussian_random" in [op.type for op in
                                 progs[1].global_block().ops]


def test_vae_reconstruction_improves():
    first, last = pvae.main(steps=300, verbose=False, place=pt.CPUPlace())
    assert last < 0.3 * first, (first, last)


def test_model_zoo_program_and_two_steps_match_the_jax_package(tmp_path):
    """Both packages build (and export, untrained) ResNet-20; then two
    Momentum steps on the demo's own batches from the JAX package's
    initial state: each loss end to end, each op on the JAX package's
    values."""
    jscope, pscope = JaxScope(), pt.Scope()
    with jax_scope_guard(jscope):
        jzoo.export(os.path.join(tmp_path, "j"), steps=0, verbose=False)
    jprog = fluid.default_main_program()
    with pt.scope_guard(pscope):
        protos = pzoo.export(os.path.join(tmp_path, "p"), steps=0,
                             verbose=False, place=pt.CPUPlace())
    pprog = pt.default_main_program()
    assert_programs_equal(pprog, jprog)
    loss = next(op.output("Out")[0] for op in pprog.global_block().ops
                if op.type == "mean")
    names = []
    for op in jprog.global_block().ops:
        names += [n for n in op.output_arg_names if n and n not in names]
    rng = np.random.RandomState(0)
    rng.randn(10, 3, 32, 32)   # the prototypes, drawn first
    exe, port = fluid.Executor(fluid.CPUPlace()), pt.Executor(pt.CPUPlace())
    for step in range(2):
        ys = rng.randint(0, 10, (32,)).astype("int64")
        xs = protos[ys] + 0.1 * rng.randn(32, 3, 32, 32).astype("float32")
        feed = {"img": xs, "label": ys.reshape(-1, 1)}
        state = {n: np.asarray(jscope.get(n)) for n in _persistables(jprog)
                 if jscope.get(n) is not None}
        pscope.load_numpy(state, "cpu")
        with jax_scope_guard(jscope):
            values = dict(zip(names, exe.run(jprog, feed=feed,
                                             fetch_list=names)))
        (got,) = port.run(pprog, feed=feed, fetch_list=[loss], scope=pscope)
        _close(got, values[loss], f"step {step}: loss")
        ops_on_the_jax_values(feed, state, values)


def test_model_zoo_export_reload_classifies():
    probs = pzoo.main(verbose=False, place=pt.CPUPlace())
    assert probs.shape == (10, 10)
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-4)
