"""PyDataProvider2 of the sequence-tagging demo
(``demos/sequence_tagging/dataprovider.py``): word sequences whose tag
is the word's bucket."""

import numpy as np

from paddle_tpu_torch.trainer.PyDataProvider2 import (integer_value_sequence,
                                                provider)

VOCAB = 20
NUM_TAGS = 4


@provider(input_types={"word": integer_value_sequence(VOCAB),
                       "tag": integer_value_sequence(NUM_TAGS)})
def process(settings, filename):
    rng = np.random.RandomState(11)
    n = int(filename) if filename and str(filename).isdigit() else 512
    for _ in range(n):
        T = int(rng.randint(5, 12))
        words = rng.randint(0, VOCAB, T)
        tags = (words // 5).astype(np.int64)  # tag = word bucket
        yield {"word": words.tolist(), "tag": tags.tolist()}
