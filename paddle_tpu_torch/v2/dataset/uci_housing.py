"""UCI housing (reference: python/paddle/v2/dataset/uci_housing.py).

Real path: the whitespace-separated housing.data table, normalized per
feature by (x - mean) / (max - min) and 80/20 split (reference
uci_housing.py:61-74, minus its matplotlib bar chart).  Records:
(float32[13] features, float32[1] price).  Offline fallback: a linear
synthetic task.
"""

import numpy as np

from paddle_tpu_torch.v2.dataset import common

__all__ = ["train", "test", "feature_names"]

URL = ("https://archive.ics.uci.edu/ml/machine-learning-databases/"
       "housing/housing.data")
MD5 = "d4accdce7a25600298819f8e28e8d593"

feature_names = [
    "CRIM", "ZN", "INDUS", "CHAS", "NOX", "RM", "AGE", "DIS", "RAD", "TAX",
    "PTRATIO", "B", "LSTAT",
]

_FEATURE_NUM = 14
_DATA = {}


def load_data(filename, feature_num=_FEATURE_NUM, ratio=0.8):
    if filename in _DATA:
        return _DATA[filename]
    data = np.fromfile(filename, sep=" ")
    data = data.reshape(data.shape[0] // feature_num, feature_num)
    maximums = data.max(axis=0)
    minimums = data.min(axis=0)
    avgs = data.mean(axis=0)
    for i in range(feature_num - 1):
        data[:, i] = (data[:, i] - avgs[i]) / (maximums[i] - minimums[i])
    offset = int(data.shape[0] * ratio)
    _DATA[filename] = (data[:offset], data[offset:])
    return _DATA[filename]


def _weights():
    rng = common.synth_rng("uci_housing", "w")
    return rng.randn(13).astype(np.float32)


def _synth(split, n):
    def reader():
        rng = common.synth_rng("uci_housing", split)
        w = _weights()
        for _ in range(n):
            x = rng.randn(13).astype(np.float32)
            y = float(x @ w + 0.1 * rng.randn())
            yield (x, np.asarray([y], np.float32))

    return reader


def _real(split):
    path = common.maybe_download(URL, "uci_housing", MD5)
    if path is None:
        return None
    train_data, test_data = load_data(path)
    rows = train_data if split == "train" else test_data

    def reader():
        for d in rows:
            yield (d[:-1].astype(np.float32),
                   d[-1:].astype(np.float32))

    return reader


def train():
    return _real("train") or _synth("train", 4096)


def test():
    return _real("test") or _synth("test", 512)
