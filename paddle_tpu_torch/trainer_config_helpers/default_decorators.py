"""Default-filling decorators for layer constructors
(``paddle_tpu/trainer_config_helpers/default_decorators.py``): how v1
helpers and user extensions name layers and default their param, bias
and act attributes."""

import functools
import inspect

__all__ = [
    "wrap_name_default", "wrap_param_attr_default",
    "wrap_bias_attr_default", "wrap_act_default", "wrap_param_default",
    "reset_hook", "DefaultNameFactory",
]


def _not_set(kwargs, name):
    return name not in kwargs or kwargs[name] is None


def wrap_param_default(param_names, default_factory,
                       not_set_callback=_not_set):
    """When any of ``param_names`` is unset in kwargs, fill it from
    ``default_factory(func)``."""
    assert isinstance(param_names, (list, tuple)) and param_names

    def __impl__(func):
        @functools.wraps(func)
        def __wrapper__(*args, **kwargs):
            for name in param_names:
                if not_set_callback(kwargs, name):
                    kwargs[name] = default_factory(func)
            return func(*args, **kwargs)

        __wrapper__.argspec = getattr(func, "argspec", None) or \
            inspect.getfullargspec(func)
        return __wrapper__

    return __impl__


class DefaultNameFactory:
    def __init__(self, name_prefix):
        self._counter = 0
        self._prefix = name_prefix

    def __call__(self, func):
        if self._prefix is None:
            self._prefix = func.__name__
        nm = f"__{self._prefix}_{self._counter}__"
        self._counter += 1
        return nm

    def reset(self):
        self._counter = 0


_name_factories = []


def reset_hook():
    for f in _name_factories:
        f.reset()


def wrap_name_default(name_prefix=None, name_param="name"):
    """Auto-name: ``name=None`` becomes ``__prefix_N__``."""
    factory = DefaultNameFactory(name_prefix)
    _name_factories.append(factory)
    return wrap_param_default([name_param], factory)


def wrap_param_attr_default(param_names=None, default_factory=None):
    from paddle_tpu_torch.param_attr import ParamAttr

    if param_names is None:
        param_names = ["param_attr"]
    if default_factory is None:
        default_factory = lambda _: ParamAttr()  # noqa: E731
    return wrap_param_default(param_names, default_factory)


def wrap_bias_attr_default(param_names=None, default_factory=None,
                           has_bias=True):
    from paddle_tpu_torch.initializer import ConstantInitializer
    from paddle_tpu_torch.param_attr import ParamAttr

    if param_names is None:
        param_names = ["bias_attr"]
    if default_factory is None:
        default_factory = lambda _: ParamAttr(  # noqa: E731
            initializer=ConstantInitializer(0.0))

    def __bias_not_set__(kwargs, name):
        if has_bias:
            return (name not in kwargs or kwargs[name] is None
                    or kwargs[name] is True)
        return name in kwargs and kwargs[name] is True

    return wrap_param_default(param_names, default_factory,
                              __bias_not_set__)


def wrap_act_default(param_names=None, act=None):
    from paddle_tpu_torch.trainer_config_helpers.activations import \
        TanhActivation

    if param_names is None:
        param_names = ["act"]
    if act is None:
        act = TanhActivation()
    return wrap_param_default(param_names, lambda _: act)
