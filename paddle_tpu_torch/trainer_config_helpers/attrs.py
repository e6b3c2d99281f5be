"""v1 attribute objects (``paddle_tpu/trainer_config_helpers/attrs.py``)."""

from paddle_tpu_torch.param_attr import ParamAttr as _ParamAttr

__all__ = ["ParameterAttribute", "ExtraLayerAttribute", "ExtraAttr",
           "ParamAttr"]


class ParameterAttribute(_ParamAttr):
    """The v1 spelling of ParamAttr: name, initial_std / initial_mean
    (normal) or initial_max / initial_min (uniform), l1_rate / l2_rate,
    learning_rate, is_static, sparse_update."""

    def __init__(self, name=None, is_static=False, initial_std=None,
                 initial_mean=None, initial_max=None, initial_min=None,
                 l1_rate=None, l2_rate=None, learning_rate=1.0,
                 momentum=None, gradient_clipping_threshold=None,
                 sparse_update=False, **kwargs):
        from paddle_tpu_torch.initializer import (NormalInitializer,
                                                  UniformInitializer)
        from paddle_tpu_torch.regularizer import (L1DecayRegularizer,
                                                  L2DecayRegularizer)

        init = None
        if initial_std is not None or initial_mean is not None:
            init = NormalInitializer(initial_mean or 0.0, initial_std or 0.01)
        elif initial_max is not None or initial_min is not None:
            init = UniformInitializer(initial_min or -1.0, initial_max or 1.0)
        reg = None
        if l2_rate:
            reg = L2DecayRegularizer(l2_rate)
        elif l1_rate:
            reg = L1DecayRegularizer(l1_rate)
        super().__init__(name=name, initializer=init, regularizer=reg,
                         learning_rate=learning_rate,
                         trainable=not is_static)
        self.sparse_update = sparse_update


class ExtraLayerAttribute:
    """Per-layer extras: error_clipping_threshold, drop_rate, device."""

    def __init__(self, error_clipping_threshold=None, drop_rate=None,
                 device=None):
        self.error_clipping_threshold = error_clipping_threshold
        self.drop_rate = drop_rate
        self.device = device


ExtraAttr = ExtraLayerAttribute

# the v1 surface spells ParamAttr with the v1 keywords
ParamAttr = ParameterAttribute
