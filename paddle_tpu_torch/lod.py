"""LoD (level-of-detail) ragged tensors: the port of ``paddle_tpu/lod.py``.

The reference packs a batch of variable-length sequences into one dense
tensor plus multi-level offset tables (paddle/framework/lod_tensor.h).
``LoDArray`` keeps that layout: ``data`` is the packed (sum_len, ...)
tensor and ``lod`` a tuple of int32 offset tensors on the data's device,
one per level (level 0 outermost).  LoD-aware ops work by masking and
segment arithmetic over the offsets; every other op sees the packed rows
through ``unwrap`` and hands its result back through ``rewrap``.

``unwrap`` also densifies a ``SparseGrad`` (``paddle_tpu/lod.py:128-138``):
an op with no sparse branch (a clip, a regularizer) sees the dense
gradient.  ``LoDRankTable`` orders the sequences of a LoD value by
length for the dynamic RNNs of ``ops/lod_ops.py``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from paddle_tpu_torch.sparse import SparseGrad


class LoDArray:
    """Packed ragged tensor: dense ``data`` + offset tables ``lod``."""

    def __init__(self, data, lod=()):
        self.data = data
        self.lod = tuple(lod)

    @property
    def lod_level(self) -> int:
        return len(self.lod)

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    def last_level(self):
        """Finest-grained offsets (sequence boundaries into ``data`` rows)."""
        return self.lod[-1]

    def num_sequences(self) -> int:
        return self.lod[-1].shape[0] - 1

    def seq_lens(self):
        off = self.lod[-1]
        return off[1:] - off[:-1]

    def __repr__(self):
        return f"LoDArray(data={tuple(self.data.shape)}, lod_level={self.lod_level})"


def create_lod_array(data, lod: Sequence[Sequence[int]] = (),
                     device=None) -> LoDArray:
    """A LoDArray from array data and offset lists (the reference's
    ``create_lod_tensor``): torch tensors on ``device`` (the data's own
    device for a tensor, else the CPU), offsets int32."""
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.ascontiguousarray(np.asarray(data)))
    data = data.to(device) if device is not None else data
    offs = tuple(torch.as_tensor(np.asarray(level, dtype=np.int32),
                                 device=data.device) for level in lod)
    return LoDArray(data, offs)


def lod_from_seq_lens(seq_lens: Sequence[int]) -> np.ndarray:
    out = np.zeros(len(seq_lens) + 1, dtype=np.int32)
    np.cumsum(np.asarray(seq_lens, dtype=np.int32), out=out[1:])
    return out


def row_segment_ids(offsets, num_rows: int):
    """Segment id (int64) of every packed row given offsets (n_seq+1,);
    rows past the last offset get id == n_seq (a bucket for padding)."""
    rows = torch.arange(num_rows, dtype=offsets.dtype, device=offsets.device)
    return torch.searchsorted(offsets[1:].contiguous(), rows, right=True)


class LoDRankTable:
    """Sequences sorted by length, longest first, ties in input order
    (``paddle_tpu/lod.py:97-127``): ``index[k]`` is the input index of
    the rank-k sequence and ``lengths[k]`` its length (int32 tensors);
    ``offsets`` keeps the source's last LoD level and ``src_rows`` its
    packed row count, so ``array_to_lod_tensor`` rebuilds the source's
    layout and buffer size."""

    def __init__(self, index, lengths, offsets, src_rows=None):
        self.index = index
        self.lengths = lengths
        self.offsets = offsets
        self.src_rows = src_rows

    def num_sequences(self) -> int:
        return self.index.shape[0]

    def __repr__(self):
        return f"LoDRankTable(n={self.index.shape[0]})"


def unwrap(x):
    if isinstance(x, LoDArray):
        return x.data
    if isinstance(x, SparseGrad):
        return x.to_dense()
    return x


def rewrap(template, data):
    if isinstance(template, LoDArray):
        return LoDArray(data, template.lod)
    return data
