"""DataFeeder: minibatch rows -> feed dict (``paddle_tpu/data_feeder.py``).

A LoD input (``lod_level > 0``) is packed into one array of rows and an
offset vector, its row count padded with zero rows to a multiple of
``lod_bucket`` past the last offset, as the JAX package pads it so
compiled shapes repeat; the port's LoD ops read rows up to the last
offset only.  The feed holds numpy arrays and ``LoDArray``s of numpy
data, and the Executor moves them to its place."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from paddle_tpu_torch.framework import Variable
from paddle_tpu_torch.io import numpy_dtype
from paddle_tpu_torch.lod import LoDArray, create_lod_array


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


class DataFeeder:
    def __init__(self, feed_list: Sequence[Variable], place=None,
                 lod_bucket: int = 128):
        self.feed_list = list(feed_list)
        self.place = place
        self.lod_bucket = lod_bucket

    def feed(self, minibatch: Sequence[Sequence]) -> Dict[str, object]:
        """minibatch: list of examples, each a tuple aligned with feed_list."""
        out: Dict[str, object] = {}
        for i, var in enumerate(self.feed_list):
            column = [row[i] for row in minibatch]
            if var.lod_level > 0:
                out[var.name] = self._pack_lod(column, var)
            else:
                arr = np.asarray(column)
                if arr.ndim == 1:
                    # a column of scalars feeds a (batch, 1) variable
                    arr = arr.reshape(-1, 1)
                out[var.name] = arr.astype(numpy_dtype(var.dtype))
        return out

    def _pack_lod(self, column: List, var: Variable) -> LoDArray:
        seqs = [np.asarray(s) for s in column]
        total = sum(s.shape[0] for s in seqs)
        padded_total = _round_up(max(total, 1), self.lod_bucket)
        data = np.zeros((padded_total,) + tuple(seqs[0].shape[1:]),
                        dtype=numpy_dtype(var.dtype))
        off = 0
        offsets = [0]
        for s in seqs:
            data[off: off + s.shape[0]] = s
            off += s.shape[0]
            offsets.append(off)
        if var.dtype in ("int64", "int32") and data.ndim == 1:
            data = data.reshape(-1, 1)
        return create_lod_array(data, [offsets])
