"""minibatch.batch (``paddle_tpu/v2/minibatch.py``)."""


def batch(reader, batch_size, drop_last=True):
    def batch_reader():
        b = []
        for item in reader():
            b.append(item)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader
