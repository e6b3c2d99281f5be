"""LoD structure ops (``paddle_tpu/ops/lod_ops.py``): the rank table, a
LoD tensor to and from a tensor array, and the RNN memory plumbing,
the machinery of fluid's length-sorted dynamic RNN.

The layout is the JAX package's: ``lod_tensor_to_array`` stacks the
packed rows into a fixed ``(max_len, n_seq, ...)`` buffer in rank order
(longest sequence first), zeros past each sequence's end, and
``shrink_rnn_memory`` masks the rows of the sequences that have ended
instead of slicing them off, so every step of a ``while`` works on all
``n_seq`` rows.  The scatters and gathers take their indices as
tensors: none of these ops reads a value to the host.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.lod import LoDArray, LoDRankTable, row_segment_ids, unwrap
from paddle_tpu_torch.ops.sequence_ops import _trailing
from paddle_tpu_torch.registry import register_op
from paddle_tpu_torch.tensor_array import TensorArray


@register_op("lod_rank_table", inputs=("X",), stop_gradient=True)
def _lod_rank_table(ctx):
    """The sequences of LoD level ``level``, longest first; a stable sort,
    so ties keep their input order (``:30-40``)."""
    x = ctx.input("X")
    if not isinstance(x, LoDArray):
        raise TypeError("lod_rank_table needs a LoD input")
    off = x.lod[int(ctx.attr("level", 0))]
    lens = off[1:] - off[:-1]
    order = torch.sort(-lens, stable=True).indices.to(torch.int32)
    ctx.set_output("Out", LoDRankTable(order, lens[order.long()],
                                       x.last_level(),
                                       src_rows=x.data.shape[0]))


def _rank_of(table: LoDRankTable, nseq: int, device):
    """The rank of each sequence: the inverse permutation of the index."""
    rank = torch.zeros(nseq, dtype=torch.long, device=device)
    return rank.index_copy(0, table.index.long(),
                           torch.arange(nseq, dtype=torch.long, device=device))


def _time_slots(off, nseq: int, rows: int, table: LoDRankTable):
    """(sequence, step, rank column) of each of ``rows`` packed rows under
    offsets ``off``; a row past ``off[-1]`` gets sequence ``nseq``."""
    off = off.long()
    seq = row_segment_ids(off, rows)
    clamped = seq.clamp(max=max(nseq - 1, 0))
    pos = torch.arange(rows, device=off.device) - off[clamped]
    col = _rank_of(table, nseq, off.device)[clamped]
    return seq, pos, col


def _batch_major(x: LoDArray, table: LoDRankTable, max_len=None):
    """Packed rows -> (max_len, n_seq, ...) in rank order (``:43-70``).
    Without ``max_len`` the time bound is the packed row count (one
    sequence could own every row); steps at or past ``max_len`` are cut."""
    data = x.data
    off = x.last_level()
    nseq = off.shape[0] - 1
    rows = data.shape[0]
    max_len = int(max_len) if max_len else rows
    seq, pos, col = _time_slots(off, nseq, rows, table)
    valid = (seq < nseq) & (pos < max_len)
    # an invalid row goes to one extra slot, dropped at the end
    flat = torch.where(valid, pos * nseq + col,
                       torch.full_like(pos, max_len * nseq))
    buf = data.new_zeros((max_len * nseq + 1,) + tuple(data.shape[1:]))
    buf = buf.index_copy(0, flat, data * _trailing(valid, data.ndim).to(
        data.dtype))
    return buf[:-1].reshape((max_len, nseq) + tuple(data.shape[1:]))


@register_op("lod_tensor_to_array", inputs=("X", "RankTable"))
def _lod_tensor_to_array(ctx):
    """A TensorArray of the rank-ordered steps, its length the longest
    sequence's (bounded by ``max_len``)."""
    x = ctx.input("X")
    table = ctx.input("RankTable")
    if not (isinstance(x, LoDArray) and isinstance(table, LoDRankTable)):
        raise TypeError("lod_tensor_to_array needs a LoD X and a rank table")
    max_len = ctx.attr("max_len")
    size = table.lengths.max().to(torch.int32)
    if max_len:
        size = size.clamp(max=int(max_len))
    ctx.set_output("Out", TensorArray(_batch_major(x, table, max_len), size))


@register_op("array_to_lod_tensor", inputs=("X", "RankTable"))
def _array_to_lod_tensor(ctx):
    """The rank-ordered steps back into packed rows with the table's
    offsets, the source's packed row count of them (``:88-112``): rows
    past the last offset, the padding the source carried, are zeros."""
    bm = ctx.input("X").stack                         # (max_len, n_seq, ...)
    table = ctx.input("RankTable")
    nseq = bm.shape[1]
    total = bm.shape[0] * nseq
    seq, pos, col = _time_slots(table.offsets, nseq, total, table)
    valid = seq < nseq
    src = torch.where(valid, pos * nseq + col, torch.zeros_like(pos))
    flat = bm.reshape((total,) + tuple(bm.shape[2:]))
    rows = flat[src.clamp(0, total - 1)]
    rows = rows * _trailing(valid, rows.ndim).to(rows.dtype)
    n_rows = ctx.attr("max_rows", table.src_rows) or total
    ctx.set_output("Out", LoDArray(rows[:n_rows], (table.offsets,)))


@register_op("shrink_rnn_memory", inputs=("X", "RankTable", "I"))
def _shrink_rnn_memory(ctx):
    """Memory rows of the sequences that ended before step I zeroed (the
    reference slices them off; the rows stay here, rank-ordered)."""
    x = unwrap(ctx.input("X"))
    table = ctx.input("RankTable")
    i = unwrap(ctx.input("I")).reshape(())
    alive = (table.lengths > i).to(x.dtype)
    ctx.set_output("Out", x * _trailing(alive, x.ndim))


@register_op("rnn_memory_helper", inputs=("X",))
def _rnn_memory_helper(ctx):
    """The identity: a memory's hand-off between steps."""
    ctx.set_output("Out", ctx.input("X"))


def _row_mask(ctx, ndim):
    mask = unwrap(ctx.input("Mask")).bool().reshape(-1)
    return _trailing(mask, ndim)


@register_op("split_lod_tensor", inputs=("X", "Mask"),
             outputs=("OutTrue", "OutFalse"), diff_inputs=("X",))
def _split_lod_tensor(ctx):
    """X's rows where Mask holds, and where it does not, each at X's
    shape with the other rows zeroed (the reference partitions them)."""
    x = unwrap(ctx.input("X"))
    m = _row_mask(ctx, x.ndim)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    ctx.set_output("OutTrue", torch.where(m, x, zero))
    ctx.set_output("OutFalse", torch.where(m, zero, x))


@register_op("merge_lod_tensor", inputs=("X", "Mask", "InTrue", "InFalse"),
             diff_inputs=("InTrue", "InFalse"))
def _merge_lod_tensor(ctx):
    """InTrue's rows where Mask holds, InFalse's elsewhere."""
    t = unwrap(ctx.input("InTrue"))
    f = unwrap(ctx.input("InFalse"))
    ctx.set_output("Out", torch.where(_row_mask(ctx, t.ndim), t, f))
