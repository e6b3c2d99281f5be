"""The deprecated pre-PyDataProvider2 provider API
(``paddle_tpu/trainer/PyDataProviderWrapper.py``): Slot types map onto
PyDataProvider2 input types and the decorator delegates to the
PyDataProvider2 protocol, so old configs keep parsing; new code uses
``paddle_tpu_torch.trainer.PyDataProvider2``."""

import functools
import warnings

from paddle_tpu_torch.trainer import PyDataProvider2 as _p2

__all__ = ["DenseSlot", "SparseNonValueSlot", "SparseValueSlot",
           "IndexSlot", "StringSlot", "PoolSize", "provider",
           "init_hook_wrapper"]


class SlotType:
    def to_input_type(self):
        raise NotImplementedError


class DenseSlot(SlotType):
    def __init__(self, dim):
        self.dim = dim

    def to_input_type(self):
        return _p2.dense_vector(self.dim)


class SparseNonValueSlot(SlotType):
    def __init__(self, dim):
        self.dim = dim

    def to_input_type(self):
        return _p2.sparse_binary_vector(self.dim)


class SparseValueSlot(SlotType):
    def __init__(self, dim):
        self.dim = dim

    def to_input_type(self):
        return _p2.sparse_vector(self.dim)


class IndexSlot(SlotType):
    def __init__(self, dim):
        self.dim = dim

    def to_input_type(self):
        return _p2.integer_value(self.dim)


class StringSlot(SlotType):
    def __init__(self, dim=0):
        self.dim = dim

    def to_input_type(self):
        raise TypeError("StringSlot has no dense feed; use ids via "
                        "IndexSlot (the reference kept it for printing only)")


class PoolSize:
    """The shuffle pool's size."""

    def __init__(self, pool_size):
        self.size = pool_size


def provider(slots=None, use_seq=False, should_shuffle=True,
             pool_size=-1, can_over_batch_size=True, calc_batch_size=None,
             init_hook=None, **kwargs):
    """The old decorator: ``slots`` (a SlotType list or callable(obj))
    becomes PyDataProvider2 ``input_types``; the wrapped generator keeps
    its ``(obj, filename)`` signature."""
    warnings.warn("PyDataProviderWrapper is the deprecated v0 provider "
                  "API; use trainer.PyDataProvider2.provider",
                  DeprecationWarning, stacklevel=2)
    if isinstance(pool_size, PoolSize):
        pool_size = pool_size.size

    def deco(fn):
        slot_list = slots(None) if callable(slots) else slots
        input_types = [s.to_input_type() for s in (slot_list or [])]
        p2 = _p2.provider(input_types=input_types,
                          should_shuffle=should_shuffle,
                          pool_size=pool_size,
                          can_over_batch_size=can_over_batch_size,
                          calc_batch_size=calc_batch_size,
                          init_hook=init_hook, **kwargs)(fn)
        return functools.wraps(fn)(p2)

    return deco


def init_hook_wrapper(func):
    """Keyword filtering for init hooks: the file list by name."""

    @functools.wraps(func)
    def hook(settings, file_list, **kwargs):
        return func(settings, file_list=file_list, **kwargs)

    return hook
