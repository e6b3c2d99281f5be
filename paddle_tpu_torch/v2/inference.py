"""v2 inference (``paddle_tpu/v2/inference.py``): ``Inference`` builds
the output layers' test Topology and runs it on the place its
Parameters live on; ``infer`` is one call of it.  A ``beam_search``
output (``generation.BeamGen``) is decoded instead, by a
``SequenceGenerator`` on that place: ``field="value"`` gives each row's
beams ``[(score, [ids...]), ...]``, ``field="id"`` the best beam's ids."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.executor import Executor
from paddle_tpu_torch.v2.topology import Topology

__all__ = ["Inference", "infer"]


class Inference:
    def __init__(self, output_layer, parameters):
        from paddle_tpu_torch.generation import BeamGen, SequenceGenerator

        self._gen = None
        if isinstance(output_layer, BeamGen):
            self._gen = SequenceGenerator(
                output_layer, parameters,
                place=getattr(parameters, "place", None))
            self.parameters = parameters
            return
        outputs = (output_layer if isinstance(output_layer, (list, tuple))
                   else [output_layer])
        self.topology = Topology(cost=None, output_layers=list(outputs),
                                 is_test=True)
        self.parameters = parameters
        self._exe = Executor(parameters.place)

    def infer(self, input, feeding=None, field="value"):
        """The output layers' values on the rows of ``input`` (one batch),
        as numpy: one array, or a list of them for several outputs; of a
        generation spec, one beam list (or, with ``field="id"``, the best
        beam's ids) a row."""
        if self._gen is not None:
            beams = [self._gen.generate(row) for row in input]
            if field == "id":
                return [b[0][1] if b else [] for b in beams]
            return beams
        from paddle_tpu_torch.v2.trainer import V2DataFeeder

        feed = V2DataFeeder(self.topology.feed_types, feeding).feed(input)
        outs = self._exe.run(self.topology.main_program, feed=feed,
                             fetch_list=self.topology.output_vars,
                             scope=self.parameters.scope)
        outs = [np.asarray(o) for o in outs]
        return outs[0] if len(outs) == 1 else outs


def infer(output_layer, parameters, input, feeding=None, field="value"):
    return Inference(output_layer, parameters).infer(input, feeding, field)
