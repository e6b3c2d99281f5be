"""Training curves (``paddle_tpu/v2/plot/``)."""

from paddle_tpu_torch.v2.plot.plot import Ploter

__all__ = ["Ploter"]
