"""VGG-16 (benchmark/run.py's vgg16 cell) on the port against the JAX
package: two float32 Momentum steps at 32 x 32, batch 2, class_dim 10:
each step's loss end to end, every op of each step on the JAX package's
values of its inputs (tests/test_torch_image_models.py has the method and
tolerances; the AMP steps are in test_torch_image_models_vgg_amp.py)."""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)

from test_torch_image_models import f32_ops_match_jax


def test_vgg16_f32_steps_match_jax_op_by_op():
    f32_ops_match_jax("vgg16", 32, 2)
