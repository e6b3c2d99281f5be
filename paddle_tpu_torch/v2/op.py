"""The v2 math ops (``paddle_tpu/v2/op.py``): the unary math layers of
``trainer_config_helpers.layer_math``, whose import also installs the
``+``, ``-`` and ``*`` overloads on the one ``LayerOutput`` class the v1
and v2 layers share."""

from paddle_tpu_torch.trainer_config_helpers import layer_math as _m

__all__ = list(_m.__all__)

for _name in __all__:
    globals()[_name] = getattr(_m, _name)

del _name
