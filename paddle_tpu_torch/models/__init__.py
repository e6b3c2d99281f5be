"""Models of the port (``paddle_tpu/models``)."""

from paddle_tpu_torch.models.resnet import resnet_cifar10, resnet_imagenet

__all__ = ["resnet_cifar10", "resnet_imagenet"]
