"""The GAN demo (``demos/gan/train.py``): generator and discriminator
MLPs trained alternately on a 2-D ring of four Gaussians.  One program
holds G and D; both backward passes are appended before either update,
and each optimizer updates only its own parameters
(``parameter_list``).

Run: python -m paddle_tpu_torch.demos.gan.train [steps]
"""

import numpy as np

import paddle_tpu_torch as fluid


def generator(z, name="g"):
    h = fluid.layers.fc(input=z, size=32, act="relu",
                        param_attr=fluid.ParamAttr(name=f"{name}_w1"),
                        bias_attr=fluid.ParamAttr(name=f"{name}_b1"))
    return fluid.layers.fc(input=h, size=2,
                           param_attr=fluid.ParamAttr(name=f"{name}_w2"),
                           bias_attr=fluid.ParamAttr(name=f"{name}_b2"))


def discriminator(x, name="d"):
    h = fluid.layers.fc(input=x, size=32, act="relu",
                        param_attr=fluid.ParamAttr(name=f"{name}_w1"),
                        bias_attr=fluid.ParamAttr(name=f"{name}_b1"))
    return fluid.layers.fc(input=h, size=1,
                           param_attr=fluid.ParamAttr(name=f"{name}_w2"),
                           bias_attr=fluid.ParamAttr(name=f"{name}_b2"))


def build(batch=64, zdim=8):
    z = fluid.layers.data(name="z", shape=[zdim], dtype="float32")
    real = fluid.layers.data(name="real", shape=[2], dtype="float32")
    fake = generator(z)
    d_real = discriminator(real)
    d_fake = discriminator(fake)  # shared d_* params

    ones = fluid.layers.fill_constant([batch, 1], "float32", 1.0)
    zeros = fluid.layers.fill_constant([batch, 1], "float32", 0.0)
    bce = fluid.layers.sigmoid_cross_entropy_with_logits
    d_loss = fluid.layers.elementwise_add(
        fluid.layers.mean(bce(d_real, ones)),
        fluid.layers.mean(bce(d_fake, zeros)))
    g_loss = fluid.layers.mean(bce(d_fake, ones))

    d_params = [p.name for p in fluid.default_main_program().all_parameters()
                if p.name.startswith("d_")]
    g_params = [p.name for p in fluid.default_main_program().all_parameters()
                if p.name.startswith("g_")]
    # both backward passes before either update, so G's gradient flows
    # through the D weights the forward used (minimize() would put D's
    # update before G's backward)
    d_pg = fluid.backward.append_backward(d_loss, parameter_list=d_params)
    g_pg = fluid.backward.append_backward(g_loss, parameter_list=g_params)
    opt_d = fluid.optimizer.Adam(learning_rate=2e-3)
    opt_g = fluid.optimizer.Adam(learning_rate=1e-3)
    opt_d._create_optimization_pass(d_pg, d_loss)
    opt_g._create_optimization_pass(g_pg, g_loss)
    return z.name, real.name, fake, d_loss, g_loss


def real_batch(rng, n):
    """Target distribution: ring of 4 Gaussians (gan_conf's 2-D toy)."""
    centers = np.array([[2, 0], [-2, 0], [0, 2], [0, -2]], np.float32)
    c = centers[rng.randint(0, 4, n)]
    return (c + 0.1 * rng.randn(n, 2)).astype(np.float32)


def main(steps=400, batch=64, zdim=8, seed=0, verbose=True, place=None):
    """Train ``steps`` steps on ``place`` (the card unless given); the
    last d and g losses and 256 samples of G."""
    fluid.framework.reset_default_programs()
    rng = np.random.RandomState(seed)
    zname, rname, fake, d_loss, g_loss = build(batch, zdim)
    exe = fluid.Executor(place)
    exe.run(fluid.default_startup_program())
    dl = gl = None
    for step in range(steps):
        feed = {zname: rng.randn(batch, zdim).astype(np.float32),
                rname: real_batch(rng, batch)}
        dl, gl = exe.run(feed=feed, fetch_list=[d_loss, g_loss])
        if verbose and step % 100 == 0:
            print(f"step {step}: d_loss={float(dl):.4f} g_loss={float(gl):.4f}")
    # sample G on a test clone, which does not train
    test_prog = fluid.default_main_program().clone(for_test=True)
    chunks = []
    for _ in range(4):
        s, = exe.run(test_prog,
                     feed={zname: rng.randn(batch, zdim).astype(np.float32),
                           rname: real_batch(rng, batch)},
                     fetch_list=[fake])
        chunks.append(np.asarray(s))
    return float(dl), float(gl), np.concatenate(chunks, 0)


if __name__ == "__main__":
    import sys

    main(int(sys.argv[1]) if len(sys.argv) > 1 else 400)
