"""The NMT demo's generation config (``demos/seq2seq/gen_config.py``):
``python -m paddle_tpu_torch.serving --gen_config=THIS_FILE`` executes it
and calls ``make_generator()`` for the ``(beam_gen, parameters)`` pair
behind ``POST /generate``.

The parameters come from a Parameters tar when ``PADDLE_GEN_PARAMS``
names one (written with ``parameters.to_tar``); otherwise the demo trains
``PADDLE_GEN_TRAIN_PASSES`` passes (8) in process first.
``PADDLE_GEN_MAXLEN`` is the spec's ``max_length`` (9).  Both run on
``framework.default_place``'s place: the card, or the CPU where the
server was started with ``--cpu``.
"""

import functools
import os


def make_beam_gen(beam_size: int = 4, max_length: int = 9, vocab=None,
                  emb=None, hid=None):
    """The demo's generation spec, at the demo's widths unless given:
    the one builder the serving config and the parity checks share."""
    import paddle_tpu_torch.v2 as paddle
    from paddle_tpu_torch.demos.seq2seq import network
    from paddle_tpu_torch.trainer_config_helpers import (GeneratedInput,
                                                         StaticInput,
                                                         beam_search,
                                                         data_layer)

    vocab = vocab or network.VOCAB
    emb = emb or network.EMB
    hid = hid or network.HID
    src = data_layer(name="src", size=vocab)
    src.input_type = paddle.data_type.integer_value_sequence(vocab)
    enc = network.encoder(src, emb=emb, hid=hid)
    return beam_search(
        step=functools.partial(network.decoder_step, vocab=vocab, hid=hid),
        input=[GeneratedInput(size=vocab, embedding_name="trg_emb",
                              embedding_size=emb),
               StaticInput(enc, is_seq=True, size=hid)],
        bos_id=network.BOS, eos_id=network.EOS, beam_size=beam_size,
        max_length=max_length)


class TarParameters:
    """Trained parameters read from a Parameters tar into a Scope of
    their own on ``place`` (``framework.default_place``'s, the card
    unless it names another): what a generator needs of Parameters."""

    def __init__(self, path, place=None):
        import io
        import tarfile

        import numpy as np

        from paddle_tpu_torch.executor import Scope
        from paddle_tpu_torch.framework import resolve_place

        self.place = resolve_place(place)
        self.scope = Scope()
        arrays = {}
        with tarfile.open(path) as tar:
            for m in tar.getmembers():
                name = m.name[:-4] if m.name.endswith(".npy") else m.name
                arrays[name] = np.load(io.BytesIO(tar.extractfile(m).read()),
                                       allow_pickle=False)
        self.scope.load_numpy(arrays, self.place.device())


def make_generator():
    beam_gen = make_beam_gen(
        max_length=int(os.environ.get("PADDLE_GEN_MAXLEN", "9")))
    params_tar = os.environ.get("PADDLE_GEN_PARAMS")
    if params_tar:
        return beam_gen, TarParameters(params_tar)
    from paddle_tpu_torch.trainer import train_from_config

    passes = int(os.environ.get("PADDLE_GEN_TRAIN_PASSES", "8"))
    config = os.path.join(os.path.dirname(os.path.abspath(
        os.path.realpath(__file__))), "trainer_config.py")
    tc, _ = train_from_config(config, num_passes=passes, log_period=10 ** 9)
    return beam_gen, tc.parameters
