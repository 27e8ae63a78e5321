from .lenet import LeNet
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152, resnext50_32x4d,
                     resnext50_64x4d, resnext101_32x4d, resnext101_64x4d,
                     resnext152_32x4d, resnext152_64x4d, wide_resnet50_2,
                     wide_resnet101_2)
from .vit import VisionTransformer, vit_b_16, vit_l_16, vit_s_16

__all__ = ["BasicBlock", "BottleneckBlock", "LeNet", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
           "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
           "wide_resnet50_2", "wide_resnet101_2", "VisionTransformer",
           "vit_b_16", "vit_l_16", "vit_s_16"]
