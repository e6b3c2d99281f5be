"""The v1 traffic-prediction config
(``demos/traffic_prediction/trainer_config.py``): three fcs regressing
the next reading."""

from paddle_tpu_torch.trainer_config_helpers import *  # noqa: F401,F403

define_py_data_sources2(
    train_list="512", test_list="128",
    module="paddle_tpu_torch.demos.traffic_prediction.dataprovider",
    obj="process")

settings(batch_size=32, learning_rate=1e-3,
         learning_method=AdamOptimizer())

HIST = 12  # past readings per sample

series = data_layer(name="series", size=HIST)
h1 = fc_layer(input=series, size=32, act=TanhActivation())
h2 = fc_layer(input=h1, size=16, act=TanhActivation())
pred = fc_layer(input=h2, size=1, act=LinearActivation())

nxt = data_layer(name="next", size=1)
cost = regression_cost(input=pred, label=nxt)

outputs(cost)
