"""Model zoo: the JAX package's thirteen models, and the pretrained
weights manifest."""

from deeplearning4j_tpu_torch.zoo.models import (
    VGG16, VGG19, AlexNet, Darknet19, FaceNetNN4Small2, GoogLeNet,
    InceptionResNetV1, LeNet, ResNet50, SimpleCNN, TextGenerationLSTM,
    TinyYOLO, UNet, ZooModel, available_models, export_pretrained,
    load_manifest, register_pretrained)

__all__ = ["ZooModel", "LeNet", "SimpleCNN", "AlexNet", "VGG16", "VGG19",
           "ResNet50", "GoogLeNet", "InceptionResNetV1",
           "FaceNetNN4Small2", "TextGenerationLSTM", "TinyYOLO",
           "Darknet19", "UNet", "available_models",
           "register_pretrained", "load_manifest", "export_pretrained"]
