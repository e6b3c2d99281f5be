"""The model-zoo inference demo (``demos/model_zoo/infer.py``): train a
ResNet-20 for a few steps, export it with save_inference_model, reload
it into a fresh scope and classify the ten class prototypes.

Run: python -m paddle_tpu_torch.demos.model_zoo.infer
"""

import os
import tempfile

import numpy as np

import paddle_tpu_torch as fluid
from paddle_tpu_torch.models import resnet_cifar10


def export(model_dir, steps=10, seed=0, verbose=True, place=None):
    """Train a few steps, then export the pruned inference slice."""
    fluid.framework.reset_default_programs()
    rng = np.random.RandomState(seed)
    img = fluid.layers.data(name="img", shape=[3, 32, 32], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    pred = resnet_cifar10(img, depth=20, class_dim=10)
    loss = fluid.layers.mean(fluid.layers.cross_entropy(input=pred,
                                                        label=label))
    fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    exe = fluid.Executor(place)
    exe.run(fluid.default_startup_program())
    protos = rng.randn(10, 3, 32, 32).astype("float32")
    for step in range(steps):
        ys = rng.randint(0, 10, (32,)).astype("int64")
        xs = protos[ys] + 0.1 * rng.randn(32, 3, 32, 32).astype("float32")
        (l,) = exe.run(feed={"img": xs, "label": ys.reshape(-1, 1)},
                       fetch_list=[loss])
        if verbose and step % 5 == 0:
            print(f"train step {step}: loss={float(l):.4f}")
    fluid.io.save_inference_model(model_dir, ["img"], [pred], exe)
    return protos


def infer(model_dir, images, place=None):
    """Fresh-scope reload + forward (what a deployment process does)."""
    fluid.framework.reset_default_programs()
    scope = fluid.executor.Scope()
    exe = fluid.Executor(place)
    with fluid.executor.scope_guard(scope):
        program, feeds, fetches = fluid.io.load_inference_model(model_dir, exe)
        (probs,) = exe.run(program, feed={feeds[0]: images},
                           fetch_list=fetches)
    return np.asarray(probs)


def main(verbose=True, place=None):
    """Export on ``place`` (the card unless given), reload there and
    classify the prototypes: the (10, 10) probabilities."""
    with tempfile.TemporaryDirectory() as d:
        model_dir = os.path.join(d, "resnet20")
        protos = export(model_dir, verbose=verbose, place=place)
        probs = infer(model_dir, protos, place)  # the 10 class prototypes
        top1 = probs.argmax(1)
        if verbose:
            print("prototype top-1:", top1.tolist())
        return probs


if __name__ == "__main__":
    main()
