"""The v2 optimizers (``paddle_tpu/v2/optimizer.py``): each wraps one of
the port's op-appending optimizers (``paddle_tpu_torch.optimizer``) and
is what ``paddle.trainer.SGD`` takes as ``update_equation``.  A
``gradient_clipping_threshold`` clips by the global norm
(``paddle_tpu_torch.clip``).  ``regularization`` and the learning-rate
decay are kept for ``server_config`` (the string a parameter server's
optimizer is built from) and are not applied in local training, as in
the JAX package."""

from __future__ import annotations

import warnings

from paddle_tpu_torch import optimizer as core_opt
from paddle_tpu_torch import regularizer as core_reg

__all__ = ["Optimizer", "Momentum", "Adam", "Adamax", "AdaGrad",
           "DecayedAdaGrad", "AdaDelta", "RMSProp", "L2Regularization",
           "L1Regularization"]


class Optimizer:
    def __init__(self, learning_rate=0.01, regularization=None,
                 gradient_clipping_threshold=None, learning_rate_decay_a=None,
                 learning_rate_decay_b=None, model_average=None, **kwargs):
        clip = None
        if gradient_clipping_threshold:
            from paddle_tpu_torch.clip import GradientClipByGlobalNorm

            clip = GradientClipByGlobalNorm(gradient_clipping_threshold)
        self._lr = learning_rate
        self._lr_decay_a = learning_rate_decay_a
        self._lr_decay_b = learning_rate_decay_b
        self._clip = clip
        self._core = self._make_core(learning_rate, grad_clip=clip, **kwargs)
        self.regularization = regularization

    def _make_core(self, lr, **kwargs):
        raise NotImplementedError

    def minimize(self, loss, startup_program=None):
        return self._core.minimize(loss, startup_program=startup_program)

    def server_config(self) -> str:
        """The config string of the server-side optimizer: the rule, the
        learning-rate decay and an L2 regularization's decay."""
        cfg = self._server_config_body()
        if self._lr_decay_a is not None:
            cfg += (f" lr_policy=linear lr_decay_a={self._lr_decay_a}"
                    f" lr_decay_b={self._lr_decay_b or 0.0}")
        if self.regularization is not None:
            if isinstance(self.regularization, core_reg.L2DecayRegularizer):
                cfg += f" decay={self.regularization._coeff}"
            else:
                raise ValueError(
                    "remote training supports only L2 regularization "
                    "(server-side decay); got "
                    f"{type(self.regularization).__name__}")
        if self._clip is not None:
            warnings.warn(
                "gradient_clipping_threshold is not applied in remote "
                "training; gradients are sent unclipped", stacklevel=2)
        return cfg

    def _server_config_body(self) -> str:
        return f"type=sgd lr={self._lr}"


class Momentum(Optimizer):
    def __init__(self, momentum=0.9, sparse=False, **kwargs):
        self._momentum = momentum
        super().__init__(**kwargs)

    def _make_core(self, lr, **kwargs):
        return core_opt.MomentumOptimizer(lr, self._momentum, **kwargs)

    def _server_config_body(self):
        return f"type=sgd lr={self._lr} momentum={self._momentum}"


class Adam(Optimizer):
    def __init__(self, beta1=0.9, beta2=0.999, epsilon=1e-8, **kwargs):
        self._b1, self._b2, self._eps = beta1, beta2, epsilon
        super().__init__(**kwargs)

    def _make_core(self, lr, **kwargs):
        return core_opt.AdamOptimizer(lr, beta1=self._b1, beta2=self._b2,
                                      epsilon=self._eps, **kwargs)

    def _server_config_body(self):
        return (f"type=adam lr={self._lr} beta1={self._b1} beta2={self._b2}"
                f" epsilon={self._eps}")


class Adamax(Optimizer):
    def __init__(self, beta1=0.9, beta2=0.999, **kwargs):
        self._b1, self._b2 = beta1, beta2
        super().__init__(**kwargs)

    def _make_core(self, lr, **kwargs):
        return core_opt.AdamaxOptimizer(lr, beta1=self._b1, beta2=self._b2,
                                        **kwargs)

    def _server_config_body(self):
        return f"type=adamax lr={self._lr} beta1={self._b1} beta2={self._b2}"


class AdaGrad(Optimizer):
    def _make_core(self, lr, **kwargs):
        return core_opt.AdagradOptimizer(lr, **kwargs)

    def _server_config_body(self):
        return f"type=adagrad lr={self._lr}"


class DecayedAdaGrad(Optimizer):
    def __init__(self, rho=0.95, epsilon=1e-6, **kwargs):
        self._rho, self._eps = rho, epsilon
        super().__init__(**kwargs)

    def _make_core(self, lr, **kwargs):
        return core_opt.DecayedAdagradOptimizer(lr, decay=self._rho,
                                                epsilon=self._eps, **kwargs)

    def _server_config_body(self):
        return (f"type=decayed_adagrad lr={self._lr} rho={self._rho}"
                f" epsilon={self._eps}")


class AdaDelta(Optimizer):
    def __init__(self, rho=0.95, epsilon=1e-6, **kwargs):
        self._rho, self._eps = rho, epsilon
        super().__init__(**kwargs)

    def _make_core(self, lr, **kwargs):
        return core_opt.AdadeltaOptimizer(lr, rho=self._rho,
                                          epsilon=self._eps, **kwargs)

    def _server_config_body(self):
        return (f"type=adadelta lr={self._lr} rho={self._rho}"
                f" epsilon={self._eps}")


class RMSProp(Optimizer):
    def __init__(self, rho=0.95, epsilon=1e-6, **kwargs):
        self._rho, self._eps = rho, epsilon
        super().__init__(**kwargs)

    def _make_core(self, lr, **kwargs):
        return core_opt.RMSPropOptimizer(lr, rho=self._rho, epsilon=self._eps,
                                         **kwargs)

    def _server_config_body(self):
        return (f"type=rmsprop lr={self._lr} rho={self._rho}"
                f" epsilon={self._eps}")


L2Regularization = core_reg.L2DecayRegularizer
L1Regularization = core_reg.L1DecayRegularizer
