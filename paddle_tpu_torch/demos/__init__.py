"""The reference's demos, written against ``paddle_tpu_torch``: the v1
configs and their PyDataProvider2 providers (mnist_v1, quick_start,
sequence_tagging, traffic_prediction, the training half of seq2seq),
which ``python -m paddle_tpu_torch.trainer --config=...`` trains, and
the fluid demos gan, vae and model_zoo, each with a ``main(place=...)``.
Widths, batches, seeds and synthetic data are the originals'
(``demos/``)."""
