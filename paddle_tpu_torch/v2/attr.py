"""Parameter and extra attributes (``paddle_tpu/v2/attr.py``)."""

from paddle_tpu_torch.param_attr import ParamAttr


class ParameterAttribute(ParamAttr):
    def __init__(self, name=None, initial_std=None, initial_mean=None,
                 l2_rate=None, l1_rate=None, learning_rate=1.0,
                 is_static=False, **kwargs):
        initializer = None
        if initial_std is not None or initial_mean is not None:
            from paddle_tpu_torch.initializer import NormalInitializer

            initializer = NormalInitializer(initial_mean or 0.0,
                                            initial_std or 1.0)
        regularizer = None
        if l2_rate:
            from paddle_tpu_torch.regularizer import L2DecayRegularizer

            regularizer = L2DecayRegularizer(l2_rate)
        elif l1_rate:
            from paddle_tpu_torch.regularizer import L1DecayRegularizer

            regularizer = L1DecayRegularizer(l1_rate)
        super().__init__(name=name, initializer=initializer,
                         learning_rate=learning_rate,
                         regularizer=regularizer, trainable=not is_static)


class ExtraAttribute:
    def __init__(self, **kwargs):
        self.attrs = kwargs


Param = ParameterAttribute
Extra = ExtraAttribute
