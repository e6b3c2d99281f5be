"""Models of the port (``paddle_tpu/models``)."""

from paddle_tpu_torch.models.alexnet import alexnet
from paddle_tpu_torch.models.googlenet import googlenet
from paddle_tpu_torch.models.lenet import lenet5
from paddle_tpu_torch.models.lstm_text import lstm_text_classifier
from paddle_tpu_torch.models.resnet import resnet_cifar10, resnet_imagenet
from paddle_tpu_torch.models.transformer import (transformer_lm,
                                                 transformer_lm_loss)
from paddle_tpu_torch.models.vgg import vgg16
from paddle_tpu_torch.models.wide_deep import wide_deep

__all__ = ["alexnet", "googlenet", "lenet5", "lstm_text_classifier",
           "resnet_cifar10", "resnet_imagenet", "transformer_lm",
           "transformer_lm_loss", "vgg16", "wide_deep"]
