"""The PyDataProvider2 protocol (``paddle_tpu/trainer/PyDataProvider2.py``).

A provider is a generator ``fn(settings, filename)`` that yields samples,
decorated with ``@provider(input_types=...)``.  The trainer calls it in
process, file by file, and the data feeder assembles each batch on the
host.  The input types are those of ``paddle_tpu_torch.v2.data_type``."""

from __future__ import annotations

import functools
import logging

from paddle_tpu_torch.v2.data_type import (  # noqa: F401  (re-exported API)
    dense_array, dense_vector, dense_vector_sequence, integer_value,
    integer_value_sequence, sparse_binary_vector, sparse_vector)

__all__ = [
    "provider", "CacheType", "dense_vector", "dense_vector_sequence",
    "integer_value", "integer_value_sequence", "sparse_binary_vector",
    "sparse_vector", "dense_array",
]


class CacheType:
    NO_CACHE = 0
    CACHE_PASS_IN_MEM = 1


class _ProviderSettings:
    """The ``settings`` object a provider function receives: its
    input_types and the decorator's extra keyword arguments."""

    def __init__(self, input_types, **kwargs):
        self.input_types = input_types
        self.logger = logging.getLogger("provider")
        for k, v in kwargs.items():
            setattr(self, k, v)


def provider(input_types=None, cache=CacheType.NO_CACHE,
             should_shuffle=None, min_pool_size=-1, pool_size=-1,
             can_over_batch_size=True, calc_batch_size=None,
             init_hook=None, **outter_kwargs):
    """Decorate a sample generator.  The result is called as
    ``fn(filename, **args)``; ``fn.input_types`` is what
    ``define_py_data_sources2`` reads to type the config's data layers."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(filename=None, *args, **kwargs):
            settings = _ProviderSettings(input_types, **outter_kwargs)
            if init_hook is not None:
                init_hook(settings, file_list=[filename], **kwargs)
                kwargs = {}
            return fn(settings, filename, *args, **kwargs)

        wrapper.input_types = input_types
        wrapper.cache = cache
        wrapper.is_provider = True
        return wrapper

    return deco
