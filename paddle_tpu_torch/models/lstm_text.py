"""2-layer LSTM text classifier (``paddle_tpu/models/lstm_text.py``;
reference: benchmark/paddle/rnn/rnn.py, IMDB, seq len 100, stacked LSTM
+ FC)."""

from paddle_tpu_torch import layers


def lstm_text_classifier(word_ids, class_dim: int = 2, emb_dim: int = 128,
                         hidden: int = 256, num_layers: int = 2):
    """word_ids: (B, T, 1) int64 padded batch."""
    emb = layers.embedding(input=word_ids, size=[30000, emb_dim])
    x = emb  # (B, T, E)
    for _ in range(num_layers):
        proj = layers.fc(input=x, size=hidden * 4, num_flatten_dims=2,
                         bias_attr=False)
        h, _c = layers.lstm(input=proj, size=hidden)
        x = h
    # mean over time then classify
    pooled = layers.reduce_mean(x, dim=1)
    return layers.fc(input=pooled, size=class_dim, act="softmax")
