"""ResNet family (counterpart of ``paddle_tpu/vision/models/resnet.py``:
BasicBlock, BottleneckBlock, resnet18..152, the wide and resnext
variants), with the JAX package's layer and parameter names, so state
dicts carry across (``models/convert.py``).

Every Conv2D -> BatchNorm2D pair of a block, and a downsample made of one,
runs through ``nn.layers_conv_norm.conv_bn``: fused where the JAX package
fuses it (stride-1 3x3 and 1x1 convs in channels-last), chained across the
block in training, never computing a conv twice. The grouped convs of the
resnext variants never qualify and take ``F.conv2d``.

Conv weights start KaimingUniform (the JAX package's initializer, in the
port's copy) from torch's generator, the fc layer as ``torch.nn.Linear``
starts; BatchNorm weights one, biases zero.
"""

from __future__ import annotations

from torch import nn

from ...device import resolve_device
from ...nn import functional as F
from ...nn.layers_conv_norm import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D,
                                    MaxPool2D, ReLU, conv_bn)

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "wide_resnet50_2",
           "wide_resnet101_2", "resnext50_32x4d", "resnext101_64x4d"]


def _shortcut(downsample, x):
    """The identity branch: a Conv2D -> BatchNorm2D downsample runs as one
    unit (fused where it qualifies); anything else as it is."""
    if downsample is None:
        return F.value(x)
    mods = list(downsample) if isinstance(downsample, nn.Sequential) else []
    if len(mods) == 2 and isinstance(mods[0], Conv2D) \
            and isinstance(mods[1], BatchNorm2D):
        return F.value(conv_bn(mods[0], mods[1], x))
    return downsample(F.value(x))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, device=None,
                 dtype=None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        kw = dict(device=device, dtype=dtype)
        self.conv1 = Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                            bias_attr=False, **kw)
        self.bn1 = norm_layer(planes, **kw)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            **kw)
        self.bn2 = norm_layer(planes, **kw)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        out = conv_bn(self.conv1, self.bn1, x, relu=True)
        out = F.value(conv_bn(self.conv2, self.bn2, out))
        return self.relu(out + _shortcut(self.downsample, x))


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, device=None,
                 dtype=None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        kw = dict(device=device, dtype=dtype)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False, **kw)
        self.bn1 = norm_layer(width, **kw)
        self.conv2 = Conv2D(width, width, 3, stride=stride, padding=dilation,
                            groups=groups, dilation=dilation,
                            bias_attr=False, **kw)
        self.bn2 = norm_layer(width, **kw)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False, **kw)
        self.bn3 = norm_layer(planes * self.expansion, **kw)
        self.relu = ReLU()
        self.downsample = downsample

    def forward(self, x):
        out = conv_bn(self.conv1, self.bn1, x, relu=True)
        out = conv_bn(self.conv2, self.bn2, out, relu=True)
        out = F.value(conv_bn(self.conv3, self.bn3, out))
        return self.relu(out + _shortcut(self.downsample, x))


class ResNet(nn.Module):
    """``ResNet(block, depth)`` on ``device`` (None -> CUDA, raising
    without a GPU; ``"cpu"`` runs the kernels' plain versions)."""

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, device=None, dtype=None):
        super().__init__()
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        self._kw = dict(device=resolve_device(device), dtype=dtype)
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = BatchNorm2D
        self.inplanes = 64
        self.dilation = 1

        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                            bias_attr=False, **self._kw)
        self.bn1 = self._norm_layer(self.inplanes, **self._kw)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes,
                                **self._kw)

    def _make_layer(self, block, planes, blocks, stride=1):
        norm_layer = self._norm_layer
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, **self._kw),
                norm_layer(planes * block.expansion, **self._kw))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, self.dilation,
                        norm_layer, **self._kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=norm_layer, **self._kw))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(F.flatten(x, 1))
        return x


def _resnet(block, depth, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError("pretrained weights are not shipped; load "
                                  "weights with models.load_paddle_tpu_state")
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


def resnext50_32x4d(pretrained=False, **kwargs):
    kwargs["groups"] = 32
    kwargs["width"] = 4
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    kwargs["groups"] = 64
    kwargs["width"] = 4
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)
