"""AlexNet (benchmark/run.py's alexnet cell) on the port against the JAX
package: two Momentum steps at 64 x 64 (its three unpadded pools need at
least 63 x 63), batch 2, class_dim 10, in float32 and under AMP
(tests/test_torch_image_models.py has the method and tolerances)."""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)

from test_torch_image_models import amp_steps, f32_steps_match_jax


def test_alexnet_f32_steps_match_jax():
    f32_steps_match_jax("alexnet", 64, 2)


def test_alexnet_amp_steps_match_jax():
    amp_steps("alexnet", 64, 2)
