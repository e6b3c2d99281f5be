"""MNIST (reference: python/paddle/v2/dataset/mnist.py).  Records:
(image float32[784] scaled to [-1, 1], label int in [0, 10))."""

import gzip
import os

import numpy as np

from paddle_tpu_torch.v2.dataset import common


def _real_reader(img_path, lbl_path):
    def reader():
        with gzip.open(img_path, "rb") as fi, gzip.open(lbl_path, "rb") as fl:
            fi.read(16)
            fl.read(8)
            while True:
                lab = fl.read(1)
                if not lab:
                    break
                img = np.frombuffer(fi.read(784), np.uint8).astype(np.float32)
                yield (img / 127.5 - 1.0, int(lab[0]))

    return reader


def _synth_reader(split, n):
    def reader():
        rng = common.synth_rng("mnist", split)
        protos = rng.randn(10, 784).astype(np.float32)
        for _ in range(n):
            y = int(rng.randint(0, 10))
            x = np.clip(protos[y] * 0.5 + 0.3 * rng.randn(784), -1, 1)
            yield (x.astype(np.float32), y)

    return reader


def train():
    ip = common.cache_path("mnist", "train-images-idx3-ubyte.gz")
    lp = common.cache_path("mnist", "train-labels-idx1-ubyte.gz")
    if os.path.exists(ip) and os.path.exists(lp):
        return _real_reader(ip, lp)
    return _synth_reader("train", 8192)


def test():
    ip = common.cache_path("mnist", "t10k-images-idx3-ubyte.gz")
    lp = common.cache_path("mnist", "t10k-labels-idx1-ubyte.gz")
    if os.path.exists(ip) and os.path.exists(lp):
        return _real_reader(ip, lp)
    return _synth_reader("test", 1024)
