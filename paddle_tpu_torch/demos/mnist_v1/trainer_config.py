"""The v1 MNIST config (``demos/mnist_v1/trainer_config.py``): two
simple_img_conv_pool blocks, two fcs, Momentum(0.9)."""

from paddle_tpu_torch.trainer_config_helpers import *  # noqa: F401,F403

define_py_data_sources2(
    train_list="512", test_list="128",
    module="paddle_tpu_torch.demos.mnist_v1.mnist_provider",
    obj="process")

settings(batch_size=64, learning_rate=0.01,
         learning_method=MomentumOptimizer(momentum=0.9))

img = data_layer(name="pixel", size=784)

conv1 = simple_img_conv_pool(input=img, filter_size=5, num_filters=8,
                             num_channel=1, pool_size=2, pool_stride=2,
                             act=ReluActivation())
conv2 = simple_img_conv_pool(input=conv1, filter_size=5, num_filters=16,
                             pool_size=2, pool_stride=2,
                             act=ReluActivation())
fc1 = fc_layer(input=conv2, size=64, act=TanhActivation())
predict = fc_layer(input=fc1, size=10, act=SoftmaxActivation())

label = data_layer(name="label", size=10)
cost = classification_cost(input=predict, label=label)

outputs(cost)
