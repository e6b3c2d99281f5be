"""Named access to the packaged model zoo (reference:
python/paddle/utils/predefined_net.py — standard nets instantiable by
name from config).  Builders take the input Variable and return the
pre-softmax feature/logits LayerOutput-style Variable."""

__all__ = ["predefined_nets", "get_predefined_net"]


def predefined_nets():
    from paddle_tpu_torch import models

    return {
        "lenet5": models.lenet5,
        "alexnet": models.alexnet,
        "vgg16": models.vgg16,
        "resnet50": models.resnet_imagenet,
        "resnet_cifar10": models.resnet_cifar10,
        "googlenet": models.googlenet,
        "wide_deep": models.wide_deep,
        "lstm_text": models.lstm_text_classifier,
    }


def get_predefined_net(name):
    nets = predefined_nets()
    if name not in nets:
        raise KeyError(
            f"unknown predefined net {name!r}; have {sorted(nets)}")
    return nets[name]
