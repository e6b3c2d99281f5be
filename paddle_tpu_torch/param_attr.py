"""ParamAttr (``paddle_tpu/param_attr.py``)."""

from __future__ import annotations


class ParamAttr:
    def __init__(
        self,
        name=None,
        initializer=None,
        learning_rate: float = 1.0,
        regularizer=None,
        trainable: bool = True,
        gradient_clip=None,
    ):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip

    @staticmethod
    def to_attr(arg) -> "ParamAttr":
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, dict):
            return ParamAttr(**arg)
        from paddle_tpu_torch.initializer import Initializer

        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        if arg is True:
            # v1 bias_attr=True means "use a default bias"
            return ParamAttr()
        raise TypeError(f"cannot convert {arg!r} to ParamAttr")
