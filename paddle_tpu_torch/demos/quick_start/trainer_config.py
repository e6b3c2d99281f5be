"""The v1 quick-start text classification config
(``demos/quick_start/trainer_config.py``): embedding, sequence_conv_pool,
a softmax fc, Adam."""

from paddle_tpu_torch.trainer_config_helpers import *  # noqa: F401,F403

dict_dim = get_config_arg("dict_dim", int, 200)

define_py_data_sources2(
    train_list="256", test_list="64",
    module="paddle_tpu_torch.demos.quick_start.text_provider",
    obj="process",
    args={"dict_dim": dict_dim})

settings(batch_size=32, learning_rate=1e-3,
         learning_method=AdamOptimizer())

words = data_layer(name="word", size=dict_dim)
emb = embedding_layer(input=words, size=32)
conv = sequence_conv_pool(input=emb, context_len=3, hidden_size=64)
prob = fc_layer(input=conv, size=2, act=SoftmaxActivation())

label = data_layer(name="label", size=2)
cost = classification_cost(input=prob, label=label)

outputs(cost)
