"""CIFAR-10/100 (reference: python/paddle/v2/dataset/cifar.py).

Real path: the cifar-python tarballs (pickled batch dicts with 'data'
+ 'labels'/'fine_labels', parsed with latin1 pickles — same members the
reference streams, cifar.py:47-64).  Records: (float32[3072] in [0,1],
label).  Offline fallback: deterministic synthetic prototypes.
"""

import pickle
import tarfile

import numpy as np

from paddle_tpu_torch.v2.dataset import common

__all__ = ["train10", "test10", "train100", "test100"]

URL_PREFIX = "https://www.cs.toronto.edu/~kriz/"
CIFAR10_URL = URL_PREFIX + "cifar-10-python.tar.gz"
CIFAR10_MD5 = "c58f30108f718f92721af3b95e74349a"
CIFAR100_URL = URL_PREFIX + "cifar-100-python.tar.gz"
CIFAR100_MD5 = "eb9058c3a382ffc7106e4002c42a8d85"


def _real_reader(tar_path, sub_name):
    def reader():
        with tarfile.open(tar_path, mode="r") as f:
            names = sorted(m.name for m in f
                           if m.isfile() and sub_name in m.name)
            for name in names:
                batch = pickle.load(f.extractfile(name), encoding="latin1")
                data = batch["data"]
                labels = batch.get("labels", batch.get("fine_labels"))
                assert labels is not None
                for sample, label in zip(data, labels):
                    yield (np.asarray(sample, np.float32) / 255.0,
                           int(label))

    return reader


def _synth(split, n, nclass):
    def reader():
        rng = common.synth_rng(f"cifar{nclass}", split)
        protos = rng.rand(nclass, 3072).astype(np.float32)
        for _ in range(n):
            y = int(rng.randint(0, nclass))
            x = np.clip(protos[y] + 0.1 * rng.randn(3072), 0, 1)
            yield (x.astype(np.float32), y)

    return reader


def _reader(url, md5, sub_name, split, n_synth, nclass):
    tar_path = common.maybe_download(url, "cifar", md5)
    if tar_path is not None:
        return _real_reader(tar_path, sub_name)
    return _synth(split, n_synth, nclass)


def train10():
    return _reader(CIFAR10_URL, CIFAR10_MD5, "data_batch", "train", 8192, 10)


def test10():
    return _reader(CIFAR10_URL, CIFAR10_MD5, "test_batch", "test", 1024, 10)


def train100():
    return _reader(CIFAR100_URL, CIFAR100_MD5, "train", "train", 8192, 100)


def test100():
    return _reader(CIFAR100_URL, CIFAR100_MD5, "test", "test", 1024, 100)
