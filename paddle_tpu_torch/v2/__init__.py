"""The paddle.v2 surface of the port (``paddle_tpu/v2/``): layers
(``layer``) and networks build a lazy ``LayerOutput`` DAG, ``Topology``
traces it into a Program, ``parameters.create`` holds the weights in a
Scope on ``CUDAPlace(0)`` (or a given place), ``trainer.SGD`` appends an
``optimizer`` and trains over a ``reader`` batched by ``batch``, with
``event``s, and ``infer`` runs the output layers where the parameters
live; ``dataset`` holds the readers of the public corpora, ``image``
and ``plot`` their helpers.  Sequences are padded (B, T, ...) values
beside a ``<name>@len`` length vector, nested ones (B, S, T, ...) beside
``@len`` and ``@sublen``.  ``evaluator``, ``op``, ``data_feeder``,
``config_base`` and ``fluid`` load on first use."""

from paddle_tpu_torch.v2 import (activation, attr, data_type, dataset, event,
                                 image, inference, layer, minibatch,
                                 networks, optimizer, parameters, pooling,
                                 reader, topology, trainer)
from paddle_tpu_torch.v2.inference import infer
from paddle_tpu_torch.v2.minibatch import batch


def __getattr__(name):
    # these import trainer_config_helpers, whose modules import this
    # package: loaded on first use, the import graph stays acyclic
    if name in ("evaluator", "op", "data_feeder", "config_base", "fluid"):
        import importlib

        mod = importlib.import_module(f"paddle_tpu_torch.v2.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(
        f"module 'paddle_tpu_torch.v2' has no attribute {name!r}")


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


__all__ = ["activation", "attr", "batch", "data_type", "dataset", "event",
           "image", "infer", "inference", "init", "layer", "minibatch",
           "networks", "optimizer", "parameters", "pooling", "reader",
           "topology", "trainer"]
