"""Input type declarations (``paddle_tpu/v2/data_type.py``)."""

from __future__ import annotations


class InputType:
    def __init__(self, dim, seq_type, dtype):
        self.dim = dim
        self.seq_type = seq_type  # 0: no seq, 1: seq, 2: nested seq
        self.dtype = dtype

    @property
    def is_seq(self):
        return self.seq_type > 0


def dense_vector(dim, seq_type=0):
    return InputType(dim, seq_type, "float32")


def dense_array(dim, seq_type=0):
    return InputType(dim, seq_type, "float32")


def dense_vector_sequence(dim):
    return dense_vector(dim, 1)


def dense_vector_sub_sequence(dim):
    """A 2-level nested sequence (seq_type 2)."""
    return dense_vector(dim, 2)


def integer_value(range_, seq_type=0):
    return InputType(range_, seq_type, "int64")


def integer_value_sequence(range_):
    return integer_value(range_, 1)


def integer_value_sub_sequence(range_):
    return integer_value(range_, 2)


def sparse_binary_vector(dim, seq_type=0):
    """Sparse indices, fed densely (indices -> multi-hot)."""
    t = InputType(dim, seq_type, "float32")
    t.sparse = True
    return t


def sparse_vector(dim, seq_type=0):
    t = InputType(dim, seq_type, "float32")
    t.sparse = True
    return t
