"""Data provider of the traffic-prediction demo
(``demos/traffic_prediction/dataprovider.py``): sliding windows over a
periodic, noisy sensor series; predict the next reading."""

import numpy as np

from paddle_tpu_torch.trainer.PyDataProvider2 import dense_vector, provider

HIST = 12


@provider(input_types={"series": dense_vector(HIST),
                       "next": dense_vector(1)})
def process(settings, filename):
    rng = np.random.RandomState(13)
    n = int(filename) if filename and str(filename).isdigit() else 512
    t0 = rng.rand(n) * 100
    for i in range(n):
        t = t0[i] + np.arange(HIST + 1)
        # daily + weekly periodicity, like road-sensor flow curves
        y = (np.sin(2 * np.pi * t / 24) + 0.3 * np.sin(2 * np.pi * t / 168)
             + 0.05 * rng.randn(HIST + 1)).astype(np.float32)
        yield {"series": y[:HIST].tolist(), "next": [float(y[HIST])]}
