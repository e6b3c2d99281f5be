"""VGG-16 (benchmark/run.py's vgg16 cell) on the port against the JAX
package: two AMP Momentum steps at 32 x 32, batch 2, class_dim 10
(``amp_steps_match_jax``; the loss too within 4x the JAX package's own
bf16 effect on it, 1.1% of its value after one step; see
tests/test_torch_image_models.py)."""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)

from test_torch_image_models import amp_steps


def test_vgg16_amp_steps_match_jax():
    amp_steps("vgg16", 32, 2, loss_floor=True)
