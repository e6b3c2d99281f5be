"""Op lowerings; importing this package registers them."""

from paddle_tpu_torch.ops import (  # noqa: F401
    activation_ops,
    attention_ops,
    loss_ops,
    math_ops,
    metric_ops,
    nn_ops,
    optimizer_ops,
    reduce_ops,
    sequence_ops,
    tensor_ops,
)
from paddle_tpu_torch.ops import aliases  # noqa: F401  (must be last)
