"""The model zoo (counterpart of ``horovod_tpu/models``): the ResNets,
Inception V3 and VGG-16 / 19 (the reference's scaling table), the
transformer LM, and in ``models.mnist`` the MNIST nets of the examples;
``models.convert`` carries Flax parameters across."""

from .inception import InceptionV3
from .resnet import (ResNet, ResNet18, ResNet34, ResNet50, ResNet101,
                     ResNet152)
from .transformer import TransformerLM
from .vgg import VGG, VGG16, VGG19

__all__ = ["InceptionV3", "ResNet", "ResNet18", "ResNet34", "ResNet50",
           "ResNet101", "ResNet152", "TransformerLM", "VGG", "VGG16",
           "VGG19"]
