"""The paddle.v2 surface of the port (``paddle_tpu/v2/``), the part the
v1 trainer reaches: layers build a lazy ``LayerOutput`` DAG,
``Topology`` traces it into a Program, ``Parameters`` holds the weights
in a Scope, ``SGD`` appends the optimizer.  Sequences are padded
(B, T, ...) values beside a ``<name>@len`` length vector.  The data
feeder, ``SGD.train``, checkpoints, inference and the datasets wait for
the v2 slice."""

from paddle_tpu_torch.v2 import (activation, attr, data_type, layer,
                                 parameters, pooling, topology, trainer)

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


__all__ = ["activation", "attr", "data_type", "init", "layer", "parameters",
           "pooling", "topology", "trainer"]
