"""``paddle.v2.config_base`` (``paddle_tpu/v2/config_base.py``): the v1
and v2 layers are one lazy ``LayerOutput`` class, so ``Layer`` is that
class (resolved on first use, clear of the import of ``v2.layer``) and
``__convert_to_v2__`` returns its constructor as it is."""

__all__ = ["Layer", "__convert_to_v2__"]


def __getattr__(name):
    if name == "Layer":
        from paddle_tpu_torch.v2.layer import LayerOutput

        return LayerOutput
    raise AttributeError(
        f"module 'paddle_tpu_torch.v2.config_base' has no attribute "
        f"{name!r}")


def __convert_to_v2__(f, name=None, module=None):
    return f
