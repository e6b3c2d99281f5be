"""Synthetic sentiment provider of the quick-start demo
(``demos/quick_start/text_provider.py``): class-1 sequences draw from
the top half of the vocab, class-0 from the bottom half."""

import numpy as np

from paddle_tpu_torch.trainer.PyDataProvider2 import (integer_value,
                                                integer_value_sequence,
                                                provider)


@provider(input_types={"word": integer_value_sequence(200),
                       "label": integer_value(2)})
def process(settings, filename, dict_dim=200):
    rng = np.random.RandomState(11)
    n = int(filename) if filename and str(filename).isdigit() else 256
    half = dict_dim // 2
    for _ in range(n):
        y = int(rng.randint(0, 2))
        length = int(rng.randint(4, 12))
        lo, hi = (half, dict_dim) if y else (1, half)
        words = rng.randint(lo, hi, length).tolist()
        yield {"word": words, "label": y}
