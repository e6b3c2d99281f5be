"""PyDataProvider2 of the seq2seq NMT demo (``demos/seq2seq/
dataprovider.py``): parallel token sequences of a synthetic
shift-by-one translation with EOS."""

import numpy as np

from paddle_tpu_torch.trainer.PyDataProvider2 import (integer_value_sequence,
                                                provider)

VOCAB = 16
BOS, EOS = 0, 1


@provider(input_types={"src": integer_value_sequence(VOCAB),
                       "trg_in": integer_value_sequence(VOCAB),
                       "trg_out": integer_value_sequence(VOCAB)})
def process(settings, filename):
    rng = np.random.RandomState(13)
    n = int(filename) if filename and str(filename).isdigit() else 512
    for _ in range(n):
        T = int(rng.randint(3, 7))
        src = rng.randint(2, VOCAB, T)
        # the 'translation': shift each token by one inside the
        # non-special vocab (monotonic alignment, so the attention has
        # a clean signal to learn), then close with EOS
        trg = ((src - 2 + 1) % (VOCAB - 2)) + 2
        trg = np.concatenate([trg, [EOS]])
        trg_in = np.concatenate([[BOS], trg[:-1]])
        yield {"src": src.tolist(), "trg_in": trg_in.tolist(),
               "trg_out": trg.tolist()}
