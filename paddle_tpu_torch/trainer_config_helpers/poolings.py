"""v1 pooling objects (``paddle_tpu/trainer_config_helpers/poolings.py``)."""

from paddle_tpu_torch.v2 import pooling as _p

__all__ = ["BasePoolingType", "MaxPooling", "AvgPooling", "SumPooling",
           "SquareRootNPooling"]

BasePoolingType = _p.BasePoolingType
MaxPooling = _p.Max
AvgPooling = _p.Avg
SumPooling = _p.Sum
SquareRootNPooling = _p.SquareRootN
