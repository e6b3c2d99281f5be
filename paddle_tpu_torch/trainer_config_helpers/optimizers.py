"""v1 ``settings()`` and the optimizer and regularization declarations
(``paddle_tpu/trainer_config_helpers/optimizers.py``): each method names
the ``paddle_tpu_torch.optimizer`` class the trainer builds."""

from __future__ import annotations

__all__ = [
    "settings", "BaseSGDOptimizer", "MomentumOptimizer", "AdamOptimizer",
    "AdamaxOptimizer", "AdaGradOptimizer", "DecayedAdaGradOptimizer",
    "AdaDeltaOptimizer", "RMSPropOptimizer", "L1Regularization",
    "L2Regularization",
]

# the active config capture lives in layers.py
from paddle_tpu_torch.trainer_config_helpers import layers as _layers


def L2Regularization(rate: float):
    """settings(regularization=L2Regularization(rate)): the decay is
    applied at every update."""
    from paddle_tpu_torch.regularizer import L2DecayRegularizer

    return L2DecayRegularizer(regularization_coeff=rate)


def L1Regularization(rate: float):
    from paddle_tpu_torch.regularizer import L1DecayRegularizer

    return L1DecayRegularizer(regularization_coeff=rate)


class BaseSGDOptimizer:
    name = "sgd"
    extra = {}

    def to_optimizer(self, learning_rate, **kwargs):
        from paddle_tpu_torch import optimizer as opt

        return opt.SGD(learning_rate=learning_rate, **kwargs)


class MomentumOptimizer(BaseSGDOptimizer):
    name = "momentum"

    def __init__(self, momentum: float = 0.9, sparse: bool = False):
        self.momentum = momentum

    def to_optimizer(self, learning_rate, **kwargs):
        from paddle_tpu_torch import optimizer as opt

        return opt.Momentum(learning_rate=learning_rate,
                            momentum=self.momentum, **kwargs)


class AdamOptimizer(BaseSGDOptimizer):
    name = "adam"

    def __init__(self, beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8):
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def to_optimizer(self, learning_rate, **kwargs):
        from paddle_tpu_torch import optimizer as opt

        return opt.Adam(learning_rate=learning_rate, beta1=self.beta1,
                        beta2=self.beta2, epsilon=self.epsilon, **kwargs)


class AdamaxOptimizer(BaseSGDOptimizer):
    name = "adamax"

    def __init__(self, beta1: float = 0.9, beta2: float = 0.999):
        self.beta1, self.beta2 = beta1, beta2

    def to_optimizer(self, learning_rate, **kwargs):
        from paddle_tpu_torch import optimizer as opt

        return opt.Adamax(learning_rate=learning_rate, beta1=self.beta1,
                          beta2=self.beta2, **kwargs)


class AdaGradOptimizer(BaseSGDOptimizer):
    name = "adagrad"

    def to_optimizer(self, learning_rate, **kwargs):
        from paddle_tpu_torch import optimizer as opt

        return opt.Adagrad(learning_rate=learning_rate, **kwargs)


class DecayedAdaGradOptimizer(BaseSGDOptimizer):
    name = "decayed_adagrad"

    def __init__(self, rho: float = 0.95, epsilon: float = 1e-6):
        self.rho, self.epsilon = rho, epsilon

    def to_optimizer(self, learning_rate, **kwargs):
        from paddle_tpu_torch import optimizer as opt

        return opt.DecayedAdagrad(learning_rate=learning_rate,
                                  decay=self.rho, epsilon=self.epsilon, **kwargs)


class AdaDeltaOptimizer(BaseSGDOptimizer):
    name = "adadelta"

    def __init__(self, rho: float = 0.95, epsilon: float = 1e-6):
        self.rho, self.epsilon = rho, epsilon

    def to_optimizer(self, learning_rate, **kwargs):
        from paddle_tpu_torch import optimizer as opt

        return opt.Adadelta(learning_rate=learning_rate, rho=self.rho,
                            epsilon=self.epsilon, **kwargs)


class RMSPropOptimizer(BaseSGDOptimizer):
    name = "rmsprop"

    def __init__(self, rho: float = 0.95, epsilon: float = 1e-6):
        self.rho, self.epsilon = rho, epsilon

    def to_optimizer(self, learning_rate, **kwargs):
        from paddle_tpu_torch import optimizer as opt

        return opt.RMSProp(learning_rate=learning_rate, rho=self.rho,
                           epsilon=self.epsilon, **kwargs)


def settings(batch_size: int = 32, learning_rate: float = 1e-3,
             learning_method: BaseSGDOptimizer = None,
             regularization=None, gradient_clipping_threshold=None,
             learning_rate_decay_a=0.0, learning_rate_decay_b=0.0,
             learning_rate_schedule=None, model_average=None, **kwargs):
    """Record the global optimization settings (read by the trainer)."""
    cap = _layers._g_capture
    s = {
        "batch_size": batch_size,
        "learning_rate": learning_rate,
        "learning_method": learning_method or BaseSGDOptimizer(),
        "regularization": regularization,
        "gradient_clipping_threshold": gradient_clipping_threshold,
        "learning_rate_decay_a": learning_rate_decay_a,
        "learning_rate_decay_b": learning_rate_decay_b,
        "learning_rate_schedule": learning_rate_schedule,
    }
    s.update(kwargs)
    if cap is not None:
        cap["settings"] = s
    return s
