"""Models of the port (``paddle_tpu/models``)."""

from paddle_tpu_torch.models.lenet import lenet5
from paddle_tpu_torch.models.resnet import resnet_cifar10, resnet_imagenet

__all__ = ["lenet5", "resnet_cifar10", "resnet_imagenet"]
