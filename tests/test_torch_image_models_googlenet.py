"""GoogLeNet (benchmark/run.py's googlenet cell) on the port against the
JAX package: two Momentum steps at 32 x 32, batch 2, class_dim 10, in
float32 (each step's loss end to end, every op of each step on the JAX
package's values of its inputs) and under AMP (tests/test_torch_image_models.py has the method
and tolerances)."""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)

from test_torch_image_models import amp_steps, f32_ops_match_jax


def test_googlenet_f32_steps_match_jax_op_by_op():
    f32_ops_match_jax("googlenet", 32, 2)


def test_googlenet_amp_steps_match_jax():
    amp_steps("googlenet", 32, 2)
