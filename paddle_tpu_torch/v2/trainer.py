"""The v2 trainer (``paddle_tpu/v2/trainer.py``): ``SGD.__init__``'s local
path, which appends the optimizer to the topology's program and
initialises what it added.  ``train``, ``test``, the data feeder,
checkpoints and remote (parameter-server) training wait for the v2
slice."""

from __future__ import annotations

from paddle_tpu_torch import framework
from paddle_tpu_torch.executor import Executor
from paddle_tpu_torch.v2.layer import LayerOutput
from paddle_tpu_torch.v2.parameters import Parameters


class SGD:
    """paddle.v2.trainer.SGD: ``update_equation.minimize`` on the
    topology's cost, then the startup program (grown by the learning
    rate and the accumulators) run into ``parameters``' scope on its
    place."""

    def __init__(self, cost: LayerOutput, parameters: Parameters,
                 update_equation, extra_layers=None, is_local: bool = True,
                 pserver_addrs=None, **kwargs):
        if not is_local:
            raise NotImplementedError(
                "paddle_tpu_torch: remote (parameter-server) training comes "
                "with the distributed slice")
        from paddle_tpu_torch import v2

        if v2._trainer_count > 1:
            raise NotImplementedError(
                "paddle_tpu_torch: trainer_count > 1 comes with the parallel "
                "slice")
        self.topology = parameters.topology
        self.parameters = parameters
        self._extra = list(extra_layers or [])
        with framework.program_guard(self.topology.main_program,
                                     self.topology.startup_program):
            update_equation.minimize(
                self.topology.cost_var,
                startup_program=self.topology.startup_program)
        exe = Executor(parameters.place)
        exe.run(self.topology.startup_program, scope=parameters.scope)
        self._exe = exe
