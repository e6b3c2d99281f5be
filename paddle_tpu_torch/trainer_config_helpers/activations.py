"""v1 activation objects (``paddle_tpu/trainer_config_helpers/
activations.py``), aliases of ``paddle_tpu_torch.v2.activation``."""

from paddle_tpu_torch.v2 import activation as _a

__all__ = [
    "BaseActivation", "LinearActivation", "IdentityActivation",
    "ReluActivation", "SigmoidActivation", "TanhActivation",
    "SoftmaxActivation", "ExpActivation", "LogActivation",
    "SquareActivation", "SoftReluActivation", "BReluActivation",
    "LeakyReluActivation", "STanhActivation", "AbsActivation",
    "SqrtActivation", "ReciprocalActivation",
]

BaseActivation = _a.BaseActivation
LinearActivation = _a.Linear
IdentityActivation = _a.Linear
ReluActivation = _a.Relu
SigmoidActivation = _a.Sigmoid
TanhActivation = _a.Tanh
SoftmaxActivation = _a.Softmax
ExpActivation = _a.Exp
LogActivation = _a.Log
SquareActivation = _a.Square
SoftReluActivation = _a.SoftRelu
BReluActivation = _a.BRelu
LeakyReluActivation = _a.LeakyRelu
STanhActivation = _a.STanh
AbsActivation = _a.Abs
SqrtActivation = _a.Sqrt
ReciprocalActivation = _a.Reciprocal
