"""ResNet family. Counterpart of ``paddle_tpu/vision/models/resnet.py``
(``BasicBlock``, ``BottleneckBlock``, ``ResNet`` and its thirteen
factories: resnet18/34/50/101/152, wide_resnet50_2/101_2 and the ResNeXt
variants, whose 3 x 3 convolutions are grouped).

The same structure and parameter names as the JAX package
(``conv1``, ``bn1``, ``layer1`` ... ``layer4`` as ``Sequential``s of
blocks, each block's ``downsample`` a ``Sequential`` of a 1 x 1 conv and a
batch norm, ``fc``), so a JAX model's weights and batch-norm statistics
carry across with ``framework.io.load_numpy_state_dict``. Convolutions
run on cuDNN, batch norm and pooling on torch's ops: the JAX package
computes them outside any Pallas kernel. Built in float32 on ``device``
(default: the framework's, ``cuda``); ``model.to(torch.bfloat16)`` casts
it, buffers included, as ``bench_resnet50`` casts the JAX model.
``ResNet`` is channels-last-safe (``framework.layout.to_channels_last``).
"""
from __future__ import annotations

import torch
from torch import nn

from ...framework.device import resolve_device
from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear, MaxPool2D,
                   ReLU, Sequential)

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
           "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
           "wide_resnet50_2", "wide_resnet101_2"]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, *, device=None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        self.conv1 = Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                            bias_attr=False, device=device)
        self.bn1 = norm_layer(planes, device=device)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            device=device)
        self.bn2 = norm_layer(planes, device=device)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, *, device=None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False,
                            device=device)
        self.bn1 = norm_layer(width, device=device)
        self.conv2 = Conv2D(width, width, 3, stride=stride, padding=dilation,
                            groups=groups, dilation=dilation, bias_attr=False,
                            device=device)
        self.bn2 = norm_layer(width, device=device)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False, device=device)
        self.bn3 = norm_layer(planes * self.expansion, device=device)
        self.relu = ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Module):
    # layout-safe: conv, batch norm and pool are layout-aware, the
    # residual adds elementwise, the flatten after the 1 x 1 pool
    _channels_last_safe = True

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, *, device=None):
        super().__init__()
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        self.device = dev = resolve_device(device)
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.dilation = 1
        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                            bias_attr=False, device=dev)
        self.bn1 = BatchNorm2D(self.inplanes, device=dev)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes, device=dev)

    def _make_layer(self, block, planes, blocks, stride=1):
        dev = self.device
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, device=dev),
                BatchNorm2D(planes * block.expansion, device=dev),
            )
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, device=dev)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, device=dev))
        return Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def _resnet(block, depth, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not in the port: load a state dict "
            "with framework.io.load_numpy_state_dict")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def _resnext(depth, groups, pretrained, kwargs):
    kwargs["groups"] = groups
    kwargs["width"] = 4
    return _resnet(BottleneckBlock, depth, pretrained, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnext(50, 32, pretrained, kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    return _resnext(50, 64, pretrained, kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return _resnext(101, 32, pretrained, kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return _resnext(101, 64, pretrained, kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    return _resnext(152, 32, pretrained, kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    return _resnext(152, 64, pretrained, kwargs)
