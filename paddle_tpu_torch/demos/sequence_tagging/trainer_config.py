"""The v1 sequence-tagging config with a CRF cost
(``demos/sequence_tagging/trainer_config.py``): data -> embedding ->
linear fc emission -> crf_layer."""

from paddle_tpu_torch.trainer_config_helpers import *  # noqa: F401,F403

define_py_data_sources2(
    train_list="512", test_list="128",
    module="paddle_tpu_torch.demos.sequence_tagging.dataprovider",
    obj="process")

settings(batch_size=32, learning_rate=0.05,
         learning_method=AdamOptimizer())

NUM_TAGS = 4
VOCAB = 20

word = data_layer(name="word", size=VOCAB)
emb = embedding_layer(input=word, size=16)
emission = fc_layer(input=emb, size=NUM_TAGS, act=LinearActivation())

tag = data_layer(name="tag", size=NUM_TAGS)
crf = crf_layer(input=emission, label=tag,
                param_attr=ParamAttr(name="crf_transition"))

outputs(crf)
