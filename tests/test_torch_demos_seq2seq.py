"""The seq2seq demo's training half (``demos/seq2seq/trainer_config.py``:
a GRU encoder, a recurrent_group decoder with simple_attention) through
the port's v1 loop on the CPU, against the JAX package: the programs
equal, two steps from the same weights match, and the port's copy
passes the reference test's gate at its 30 passes
(``tests/test_demos.py``).  Tolerances: ``test_torch_demos.py``."""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np

from test_torch_demos import (check_v1_pair,  # noqa: F401
                              one_torch_thread, train_gate, v1_pair)


def test_seq2seq_demo_program_and_two_steps_match_the_jax_package():
    check_v1_pair(*v1_pair("seq2seq"))


def test_seq2seq_demo_trains():
    costs = train_gate("seq2seq", 30)
    assert np.mean(costs[-3:]) < 0.25 * costs[0], (costs[0], costs[-3:])
