"""The VAE demo (``demos/vae/train.py``): encoder and decoder MLPs with
the reparameterization trick on two-factor synthetic images.  The noise
comes from the in-graph gaussian_random op, drawn from the executor's
generator.

Run: python -m paddle_tpu_torch.demos.vae.train [steps]
"""

import numpy as np

import paddle_tpu_torch as fluid


def build(xdim=64, hdim=32, zdim=4, batch=64):
    x = fluid.layers.data(name="x", shape=[xdim], dtype="float32")
    h = fluid.layers.fc(input=x, size=hdim, act="tanh")
    mu = fluid.layers.fc(input=h, size=zdim)
    logvar = fluid.layers.fc(input=h, size=zdim)

    eps = fluid.layers.gaussian_random(shape=[batch, zdim], mean=0.0, std=1.0)
    half_logvar = fluid.layers.scale(logvar, scale=0.5)
    std = fluid.layers.exp(half_logvar)
    z = fluid.layers.elementwise_add(mu,
                                     fluid.layers.elementwise_mul(eps, std))

    dh = fluid.layers.fc(input=z, size=hdim, act="tanh")
    recon = fluid.layers.fc(input=dh, size=xdim)

    rec_loss = fluid.layers.mean(
        fluid.layers.square_error_cost(input=recon, label=x))
    # KL(q||N(0,1)) = -0.5 * sum(1 + logvar - mu^2 - exp(logvar))
    kl_terms = fluid.layers.elementwise_sub(
        fluid.layers.elementwise_add(
            fluid.layers.scale(logvar, scale=1.0, bias=1.0),   # 1 + logvar
            fluid.layers.scale(fluid.layers.square(mu), scale=-1.0)),
        fluid.layers.exp(logvar))
    kl = fluid.layers.scale(
        fluid.layers.mean(fluid.layers.reduce_sum(kl_terms, dim=1)),
        scale=-0.5)
    loss = fluid.layers.elementwise_add(rec_loss,
                                        fluid.layers.scale(kl, scale=0.1))
    return x.name, recon, rec_loss, kl, loss


def data_batch(rng, n, xdim=64):
    """Two-factor synthetic images: each sample is a mix of two fixed
    patterns with random weights (a true 2-D latent)."""
    basis = np.stack([np.sin(np.linspace(0, 6, xdim)),
                      np.cos(np.linspace(0, 9, xdim))]).astype(np.float32)
    w = rng.randn(n, 2).astype(np.float32)
    return w @ basis + 0.05 * rng.randn(n, xdim).astype(np.float32)


def main(steps=400, batch=64, seed=0, verbose=True, place=None):
    """Train ``steps`` steps on ``place`` (the card unless given); the
    first and last reconstruction losses."""
    fluid.framework.reset_default_programs()
    rng = np.random.RandomState(seed)
    xname, recon, rec_loss, kl, loss = build(batch=batch)
    fluid.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    exe = fluid.Executor(place)
    exe.run(fluid.default_startup_program())
    first = last = None
    for step in range(steps):
        rl, k = exe.run(feed={xname: data_batch(rng, batch)},
                        fetch_list=[rec_loss, kl])
        first = first if first is not None else float(rl)
        last = float(rl)
        if verbose and step % 100 == 0:
            print(f"step {step}: recon={float(rl):.4f} kl={float(k):.4f}")
    return first, last


if __name__ == "__main__":
    import sys

    main(int(sys.argv[1]) if len(sys.argv) > 1 else 400)
