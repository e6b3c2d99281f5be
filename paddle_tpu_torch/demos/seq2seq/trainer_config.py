"""The v1 seq2seq NMT config with additive attention
(``demos/seq2seq/trainer_config.py``): a GRU encoder and a
recurrent_group decoder whose step runs simple_attention over the
encoded states."""

from paddle_tpu_torch.trainer_config_helpers import *  # noqa: F401,F403

from paddle_tpu_torch.demos.seq2seq.network import (EMB, VOCAB,  # noqa: F401
                                                   decoder_step, encoder)

define_py_data_sources2(
    train_list="512", test_list="96",
    module="paddle_tpu_torch.demos.seq2seq.dataprovider",
    obj="process")

settings(batch_size=16, learning_rate=0.01,
         learning_method=AdamOptimizer())

src = data_layer(name="src", size=VOCAB)
enc = encoder(src)

trg_in = data_layer(name="trg_in", size=VOCAB)
trg_out = data_layer(name="trg_out", size=VOCAB)
trg_emb = embedding_layer(input=trg_in, size=EMB,
                          param_attr=ParamAttr(name="trg_emb"))

probs = recurrent_group(step=decoder_step,
                        input=[trg_emb, StaticInput(enc, is_seq=True,
                                                    size=32)])
cost = classification_cost(input=probs, label=trg_out)
outputs(cost)
