"""Model zoo (ported so far: LeNet, SimpleCNN, VGG16/19,
TextGenerationLSTM, ResNet50)."""

from deeplearning4j_tpu_torch.zoo.models import (VGG16, VGG19, LeNet,
                                                 ResNet50, SimpleCNN,
                                                 TextGenerationLSTM,
                                                 ZooModel)

__all__ = ["ZooModel", "LeNet", "SimpleCNN", "VGG16", "VGG19",
           "TextGenerationLSTM", "ResNet50"]
