"""Activations (``paddle_tpu/v2/activation.py``): each names the op the
layer appends after its product, or none (Linear)."""


class BaseActivation:
    name = None

    def __repr__(self):
        return type(self).__name__


class Linear(BaseActivation):
    name = None


class Relu(BaseActivation):
    name = "relu"


class Sigmoid(BaseActivation):
    name = "sigmoid"


class Tanh(BaseActivation):
    name = "tanh"


class Softmax(BaseActivation):
    name = "softmax"


class Exp(BaseActivation):
    name = "exp"


class Log(BaseActivation):
    name = "log"


class Square(BaseActivation):
    name = "square"


class SoftRelu(BaseActivation):
    name = "soft_relu"


class BRelu(BaseActivation):
    name = "brelu"


class LeakyRelu(BaseActivation):
    name = "leaky_relu"


class STanh(BaseActivation):
    name = "stanh"


class Abs(BaseActivation):
    name = "abs"


class Sqrt(BaseActivation):
    name = "sqrt"


class Reciprocal(BaseActivation):
    name = "reciprocal"
