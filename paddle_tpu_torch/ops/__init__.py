"""Op lowerings; importing this package registers them."""

from paddle_tpu_torch.ops import (  # noqa: F401
    activation_ops,
    math_ops,
    nn_ops,
    tensor_ops,
)
