"""SelectedRows gradients with a static length (the port of
``paddle_tpu/sparse.py``).

``lookup_table`` with ``is_sparse`` hands its table a ``SparseGrad``: the
N looked-up row ids, un-deduplicated, and the matching (N, D) cotangent
rows over a notional dense height.  Its consumers (the ``sum`` op's row
concatenation, the sparse branches of the optimizer ops) never build the
(height, D) gradient; only ``lod.unwrap``'s safety net densifies one for
an op without a sparse branch.

``merged`` keeps the JAX package's encoding: N slots, the distinct rows
sorted in front, the unused slots filled with ``height``.  It finds the
distinct rows without ``torch.unique``, whose output size is data
dependent and would cost a device-to-host sync on every step: a stable
sort of the rows, a mark on each first occurrence and a cumulative sum of
the marks give every lookup its segment, and ``index_add_`` sums the
values into N slots.  On CUDA ``index_add_`` adds with atomics, so a row
that several lookups hit is summed in no fixed order: equal to the CPU
to rounding, not bit for bit.
"""

from __future__ import annotations

import torch


class SparseGrad:
    """``rows`` (N,) int64 indices into a dense (height, D) tensor,
    ``values`` (N, D) rows.  Rows may repeat: the gradient is the
    scatter-add of ``values`` at ``rows``."""

    __slots__ = ("rows", "values", "height")

    def __init__(self, rows, values, height: int):
        self.rows = rows
        self.values = values
        self.height = int(height)

    @property
    def shape(self):
        return (self.height,) + tuple(self.values.shape[1:])

    @property
    def dtype(self):
        return self.values.dtype

    def to_dense(self):
        """The scatter-add of the values at the rows; a row outside
        [0, height) adds nothing (``mode="drop"``)."""
        valid = (self.rows >= 0) & (self.rows < self.height)
        vals = self.values * valid.reshape(
            (-1,) + (1,) * (self.values.ndim - 1)).to(self.values.dtype)
        dense = torch.zeros(self.shape, dtype=self.values.dtype,
                            device=self.values.device)
        return dense.index_add_(0, self.rows.clamp(0, self.height - 1), vals)

    def merged(self):
        """(urows, uvalues), both of length N: the distinct rows in
        ascending order, then ``height`` in every unused slot; each
        distinct row's values summed, zeros in the unused slots."""
        n = self.rows.shape[0]
        srows, order = torch.sort(self.rows, stable=True)
        first = torch.ones(n, dtype=torch.bool, device=srows.device)
        first[1:] = srows[1:] != srows[:-1]
        seg = torch.cumsum(first, 0) - 1
        urows = torch.full((n,), self.height, dtype=srows.dtype,
                           device=srows.device)
        # every lookup of a segment writes the same row id
        urows.scatter_(0, seg, srows)
        uvalues = torch.zeros_like(self.values).index_add_(
            0, seg, self.values[order])
        return urows, uvalues

    def __repr__(self):
        return (f"SparseGrad(rows={tuple(self.rows.shape)}, "
                f"values={tuple(self.values.shape)}, height={self.height})")


def is_sparse_grad(x) -> bool:
    return isinstance(x, SparseGrad)


def concat_sparse(grads) -> SparseGrad:
    """A sum of SelectedRows is the concatenation of their rows."""
    return SparseGrad(torch.cat([g.rows for g in grads]),
                      torch.cat([g.values for g in grads]), grads[0].height)


def rowwise_update(param, sparse_grad: SparseGrad, update_rows, *states):
    """``update_rows(p_rows, g_rows, *state_rows) -> (p_rows_new,
    *state_rows_new)`` on the distinct touched rows only; every other row
    of ``param`` and of each dense (height, ...) state keeps its value bit
    for bit (the lazy row-wise updates of the sparse optimizers).

    The gradient rows stay in their own dtype (the float32 cotangent), so
    the update's float32 math is the dense branch's.  The unused slots of
    ``merged`` must not write: each of them writes the last distinct
    row's new values, so that every write to one row carries the same
    values.  (Writing back row ``height - 1``'s old values instead would
    race with that row's own update when the batch touches it.)  The
    count of distinct rows stays on the device.

    Returns ``(param_new, *states_new)``, new tensors."""
    urows, uvalues = sparse_grad.merged()
    n = urows.shape[0]
    last = (urows < sparse_grad.height).sum() - 1
    src = torch.minimum(torch.arange(n, device=urows.device), last)
    safe = urows.clamp(max=sparse_grad.height - 1)
    out = update_rows(param[safe], uvalues, *[s[safe] for s in states])
    if not isinstance(out, tuple):
        out = (out,)
    rows = urows[src]
    new = []
    for dense, rows_new in zip((param,) + states, out):
        t = dense.clone()
        t[rows] = rows_new[src].to(dense.dtype)
        new.append(t)
    return tuple(new)
