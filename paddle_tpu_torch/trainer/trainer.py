"""The v1 trainer (``paddle_tpu/trainer/trainer.py``):
``Trainer.__init__`` builds a parsed config's topology on the port's v2
stack, its Parameters and its optimizer.  The caller then runs the
topology's program with an ``Executor`` under
``scope_guard(t.parameters.scope)``.  ``train``, ``test``,
``check_gradient`` and the data providers wait for the v2 slice."""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch.framework import Place, resolve_place
from paddle_tpu_torch.trainer.config_parser import TrainerConfig


class Trainer:
    """A parsed v1 config ready to train on ``place`` (``CUDAPlace(0)``
    unless the caller passes another): ``t.parameters`` (its scope holds
    the weights and the optimizer's state), ``t._sgd.topology``
    (``main_program``, ``cost_var``, ``feed_types``)."""

    def __init__(self, conf: TrainerConfig, place: Optional[Place] = None):
        from paddle_tpu_torch.v2 import parameters as v2_params
        from paddle_tpu_torch.v2.topology import Topology
        from paddle_tpu_torch.v2.trainer import SGD

        if conf.cost is None:
            raise ValueError("config declared no outputs(); nothing to train")
        place = resolve_place(place)   # the card's absence raises here
        self.conf = conf
        settings = dict(conf.opt_config or {})
        lr = settings.get("learning_rate", 1e-3)
        method = settings.get("learning_method")
        opt_kwargs = {}
        thr = settings.get("gradient_clipping_threshold")
        if thr:
            from paddle_tpu_torch.clip import GradientClipByGlobalNorm

            opt_kwargs["grad_clip"] = GradientClipByGlobalNorm(thr)
        if settings.get("regularization") is not None:
            opt_kwargs["regularization"] = settings["regularization"]
        optimizer = (method.to_optimizer(lr, **opt_kwargs)
                     if method is not None else None)
        if optimizer is None:
            from paddle_tpu_torch import optimizer as opt

            optimizer = opt.SGD(learning_rate=lr, **opt_kwargs)
        self.batch_size = settings.get("batch_size", 32)
        topo = Topology(conf.cost, extra_layers=conf.evaluators)
        params = v2_params.Parameters(topo, place)
        self._sgd = SGD(cost=conf.cost, parameters=params,
                        update_equation=optimizer)
        self.parameters = params
