"""The seq2seq network pieces (``demos/seq2seq/network.py``): a GRU
encoder and an attention decoder step, their parameters named so that
the train and generation configs share them.  The widths default to the
demo's; ``benchmark/run.py``'s seq2seq cell is the same network at
VOCAB 30000, EMB = HID = 512 (``decoder_step`` takes its widths by
keyword, through ``functools.partial``, where a group calls it)."""

from paddle_tpu_torch.trainer_config_helpers import (LinearActivation, ParamAttr,
                                               SoftmaxActivation,
                                               TanhActivation,
                                               embedding_layer, fc_layer,
                                               grumemory, memory)
from paddle_tpu_torch.trainer_config_helpers.networks import simple_attention

VOCAB = 16
EMB, HID = 24, 32
BOS, EOS = 0, 1


def encoder(src, emb=EMB, hid=HID):
    """embedding -> 3H projection -> GRU; the states carry position,
    which the attention needs to track alignment."""
    src_emb = embedding_layer(input=src, size=emb,
                              param_attr=ParamAttr(name="src_emb"))
    enc_proj = fc_layer(input=src_emb, size=3 * hid,
                        act=LinearActivation(),
                        param_attr=ParamAttr(name="enc_w"),
                        bias_attr=False, name="enc_proj")
    return grumemory(input=enc_proj, size=hid, name="enc_seq",
                     param_attr=ParamAttr(name="enc_gru_w"),
                     bias_attr=ParamAttr(name="enc_gru_b"))


def decoder_step(word_emb, enc_seq, vocab=VOCAB, hid=HID):
    """One decoder step: additive attention over the encoder states +
    a recurrent fc cell + softmax over the vocab.  Used for teacher-
    forced training (recurrent_group) AND beam-search generation."""
    dec_mem = memory(name="dec_h", size=hid)
    ctx = simple_attention(encoded_sequence=enc_seq, encoded_proj=enc_seq,
                           decoder_state=dec_mem, name="attn",
                           softmax_param_attr=ParamAttr(name="attn_w"))
    h = fc_layer(input=[word_emb, ctx, dec_mem], size=hid,
                 act=TanhActivation(), name="dec_h",
                 param_attr=[ParamAttr(name="dec_w_in"),
                             ParamAttr(name="dec_w_ctx"),
                             ParamAttr(name="dec_w_rec")],
                 bias_attr=False)
    return fc_layer(input=h, size=vocab, act=SoftmaxActivation(),
                    name="dec_out", param_attr=ParamAttr(name="dec_w_out"),
                    bias_attr=False)
