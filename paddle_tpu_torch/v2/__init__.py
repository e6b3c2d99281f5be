"""The paddle.v2 surface of the port (``paddle_tpu/v2/``), the part the
v1 trainer reaches: layers build a lazy ``LayerOutput`` DAG,
``Topology`` traces it into a Program, ``Parameters`` holds the weights
in a Scope, ``SGD`` appends the optimizer and trains, ``batch`` and
``reader`` make the data stream.  Sequences are padded (B, T, ...)
values beside a ``<name>@len`` length vector.  Inference, the datasets
and the rest of the surface wait for ROADMAP Queue 1 item 3 step 3."""

from paddle_tpu_torch.v2 import (activation, attr, data_type, layer,
                                 minibatch, parameters, pooling, reader,
                                 topology, trainer)
from paddle_tpu_torch.v2.minibatch import batch

_trainer_count = 1


def init(use_gpu: bool = True, trainer_count: int = 1, **kwargs):
    """Process init: records ``trainer_count`` and ``use_gpu`` into
    ``FLAGS``, as ``paddle_tpu/v2/__init__.py:55-64`` does.
    ``trainer_count`` above 1 (data parallelism over that many cards)
    waits for the parallel slice and raises."""
    global _trainer_count
    if int(trainer_count) > 1:
        raise NotImplementedError(
            "paddle_tpu_torch: trainer_count > 1 (data parallelism) comes "
            "with the parallel slice")
    _trainer_count = int(trainer_count)
    from paddle_tpu_torch.flags import FLAGS

    FLAGS.set("trainer_count", int(trainer_count))
    FLAGS.set("use_gpu", bool(use_gpu))


__all__ = ["activation", "attr", "batch", "data_type", "init", "layer",
           "minibatch", "parameters", "pooling", "reader", "topology",
           "trainer"]
