"""v1 ``settings()`` and the optimizer declarations
(``paddle_tpu/trainer_config_helpers/optimizers.py``), the part the
seq2seq cell reaches: SGD and Adam, each naming the
``paddle_tpu_torch.optimizer`` class the trainer builds.  The other
methods and the regularization declarations wait for the v2 slice."""

from __future__ import annotations

__all__ = ["settings", "BaseSGDOptimizer", "AdamOptimizer"]

# the active config capture lives in layers.py
from paddle_tpu_torch.trainer_config_helpers import layers as _layers


class BaseSGDOptimizer:
    name = "sgd"

    def to_optimizer(self, learning_rate, **kwargs):
        from paddle_tpu_torch import optimizer as opt

        return opt.SGD(learning_rate=learning_rate, **kwargs)


class AdamOptimizer(BaseSGDOptimizer):
    name = "adam"

    def __init__(self, beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8):
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def to_optimizer(self, learning_rate, **kwargs):
        from paddle_tpu_torch import optimizer as opt

        return opt.Adam(learning_rate=learning_rate, beta1=self.beta1,
                        beta2=self.beta2, epsilon=self.epsilon, **kwargs)


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
