"""Parameter initializers (``paddle_tpu/initializer.py``).  Each appends
an init op to the startup program's global block."""

from __future__ import annotations

import math


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op(
            type="fill_constant",
            outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype, "value": self.value},
        )


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op(
            type="uniform_random",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "min": self.low,
                "max": self.high,
                "seed": self.seed,
            },
        )


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            type="gaussian_random",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "mean": self.loc,
                "std": self.scale,
                "seed": self.seed,
            },
        )


def _fan_in_out(var):
    shape = var.shape
    if len(shape) == 2:
        fan_in, fan_out = shape[0], shape[1]
    elif len(shape) >= 3:
        receptive = 1
        for s in shape[2:]:
            receptive *= s
        fan_in = shape[1] * receptive
        fan_out = shape[0] * receptive
    else:
        fan_in = fan_out = shape[0] if shape else 1
    return fan_in, fan_out


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = uniform, fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fi, _ = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / fi)
            NormalInitializer(0.0, std, self.seed)(var, block)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
