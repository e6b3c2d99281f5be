"""Op lowerings; importing this package registers them."""

from paddle_tpu_torch.ops import (  # noqa: F401
    activation_ops,
    attention_ops,
    beam_ops,
    control_flow_ops,
    ctc_ops,
    detection_ops,
    io_ops,
    lod_ops,
    loss_ops,
    math_ops,
    metric_ops,
    nn_extra_ops,
    nn_ops,
    optimizer_ops,
    reduce_ops,
    rnn_unit_ops,
    sequence_ops,
    tensor_ops,
)
from paddle_tpu_torch.ops import aliases  # noqa: F401  (must be last)
