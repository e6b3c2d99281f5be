"""The v2 DataFeeder (``paddle_tpu/v2/data_feeder.py``): ``data_types``
[(name, InputType), ...] and an optional ``feeding`` name -> column map
over ``V2DataFeeder``'s padded layout (sequences as (B, T, ...) arrays
beside ``<name>@len`` vectors)."""

from paddle_tpu_torch.v2.trainer import V2DataFeeder

__all__ = ["DataFeeder"]


class DataFeeder(V2DataFeeder):
    def __init__(self, data_types, feeding=None, **kwargs):
        super().__init__(data_types, feeding, **kwargs)
