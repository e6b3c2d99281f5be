"""PyDataProvider2 for the v1 MNIST demo (``demos/mnist_v1/
mnist_provider.py``): 784-pixel rows around ten seeded prototypes."""

import numpy as np

from paddle_tpu_torch.trainer.PyDataProvider2 import (dense_vector, integer_value,
                                                provider)


@provider(input_types={"pixel": dense_vector(784),
                       "label": integer_value(10)})
def process(settings, filename):
    rng = np.random.RandomState(7)
    protos = rng.randn(10, 784).astype("float32")
    n = int(filename) if filename and str(filename).isdigit() else 512
    for _ in range(n):
        y = int(rng.randint(0, 10))
        x = protos[y] + 0.3 * rng.randn(784).astype("float32")
        yield {"pixel": x.tolist(), "label": y}
