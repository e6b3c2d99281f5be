"""Weight-decay regularizers appended as grad-transform ops (the port of
``paddle_tpu/regularizer.py``): ``append_backward`` calls a parameter's
regularizer when it settles that parameter's gradient."""

from __future__ import annotations

from paddle_tpu_torch.framework import unique_name


class WeightDecayRegularizer:
    def append_regularization_op(self, param, grad, block) -> str:
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    """grad + coeff * param."""

    def __init__(self, regularization_coeff: float = 0.0):
        self._coeff = regularization_coeff

    def append_regularization_op(self, param, grad, block) -> str:
        decay = block.create_var(
            name=unique_name(param.name + "_l2decay"),
            shape=param.shape, dtype=param.dtype, stop_gradient=True)
        block.append_op(type="scale", inputs={"X": [param]},
                        outputs={"Out": [decay]}, attrs={"scale": self._coeff})
        out = block.create_var(
            name=unique_name(grad.name + "_reg"),
            shape=param.shape, dtype=param.dtype, stop_gradient=True)
        block.append_op(type="sum", inputs={"X": [grad, decay]},
                        outputs={"Out": [out]})
        return out.name


class L1DecayRegularizer(WeightDecayRegularizer):
    """grad + coeff * sign(param)."""

    def __init__(self, regularization_coeff: float = 0.0):
        self._coeff = regularization_coeff

    def append_regularization_op(self, param, grad, block) -> str:
        sign = block.create_var(name=unique_name(param.name + "_sign"),
                                shape=param.shape, dtype=param.dtype,
                                stop_gradient=True)
        block.append_op(type="sign", inputs={"X": [param]}, outputs={"Out": [sign]})
        decay = block.create_var(name=unique_name(param.name + "_l1decay"),
                                 shape=param.shape, dtype=param.dtype,
                                 stop_gradient=True)
        block.append_op(type="scale", inputs={"X": [sign]},
                        outputs={"Out": [decay]}, attrs={"scale": self._coeff})
        out = block.create_var(name=unique_name(grad.name + "_reg"),
                               shape=param.shape, dtype=param.dtype,
                               stop_gradient=True)
        block.append_op(type="sum", inputs={"X": [grad, decay]},
                        outputs={"Out": [out]})
        return out.name


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
