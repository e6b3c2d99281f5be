"""v2 inference (``paddle_tpu/v2/inference.py``): ``Inference`` builds
the output layers' test Topology and runs it on the place its
Parameters live on; ``infer`` is one call of it.  Generation (a
``beam_search`` output) waits for ROADMAP Queue 1 item 4."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.executor import Executor
from paddle_tpu_torch.v2.topology import Topology

__all__ = ["Inference", "infer"]


class Inference:
    def __init__(self, output_layer, parameters):
        if type(output_layer).__name__ == "BeamGen":
            raise NotImplementedError(
                "paddle_tpu_torch: inference of a beam_search output "
                "(generation) comes with ROADMAP Queue 1 item 4")
        outputs = (output_layer if isinstance(output_layer, (list, tuple))
                   else [output_layer])
        self.topology = Topology(cost=None, output_layers=list(outputs),
                                 is_test=True)
        self.parameters = parameters
        self._exe = Executor(parameters.place)

    def infer(self, input, feeding=None, field="value"):
        """The output layers' values on the rows of ``input`` (one batch),
        as numpy: one array, or a list of them for several outputs."""
        from paddle_tpu_torch.v2.trainer import V2DataFeeder

        feed = V2DataFeeder(self.topology.feed_types, feeding).feed(input)
        outs = self._exe.run(self.topology.main_program, feed=feed,
                             fetch_list=self.topology.output_vars,
                             scope=self.parameters.scope)
        outs = [np.asarray(o) for o in outs]
        return outs[0] if len(outs) == 1 else outs


def infer(output_layer, parameters, input, feeding=None, field="value"):
    return Inference(output_layer, parameters).infer(input, feeding, field)
