"""The paper's CIFAR-10 CNN zoo — all 16 models from FROST Sec IV — in the
PyTorch port: the counterpart of ``repro.models.cnn``, with the same
public names (the mini-library ``conv``, ``bn``, ``fc``, ``gap``,
``maxpool``, ``avgpool``, ``relu``, ``conv_bn``; the 16 ``*_init`` /
``*_apply`` pairs; ``CNN_ZOO`` in the same order; ``cnn_loss``).

Plain functions over parameter dicts, as ``models/transformer.py``.  Each
tree keeps the JAX package's keys, list positions and ``None`` slots
(VGG16's and GoogLeNet's pools), so ``common.tree_leaves`` walks it in
JAX's flatten order.  The layouts differ from JAX's:

  * activations are NCHW (images (B, 3, 32, 32)), so channel operations
    (concatenation, split, shuffle, DPN's slices, the SE gates) act on
    dim 1;
  * conv weights are OIHW, (cout, cin / groups, k, k), where JAX's are
    HWIO; ``repro_torch.bridge.cnn_params_from_numpy`` transposes.  fc
    weights keep JAX's (cin, cout).

What follows JAX's semantics exactly:

  * ``padding="SAME"`` pads as XLA does: ``total // 2`` before and the
    rest after, so a 3x3 stride-2 conv on an even input pads (0, 1) and
    a 7x7 one (2, 3) (``same_pads``).  Where the two sides differ the
    input goes through ``F.pad`` and the conv pads nothing;
  * ``bn`` normalises with the batch's own statistics and the biased
    variance, and keeps no running statistics (``F.batch_norm`` with
    ``training=True`` and no buffers), in training and in eval alike;
  * LeNet flattens its features in NHWC order, the order of ``f1``'s rows;
  * ``loss_and_grads`` returns a zero gradient for a leaf the forward
    never reads (PreActResNet18's ``stem.bn`` and ``short.bn``), as
    ``jax.grad`` does.

Inits take a ``Draws`` (the random source and the device) where JAX takes
a key: the shapes and scales are JAX's (conv N(0, 2 / fan_in) with fan_in
= (cin / groups) k k, fc N(0, 1 / cin), zero biases, bn ones and zeros),
not its numbers.  On the meta device a ``Draws`` yields shapes alone.
"""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import common


# --------------------------------------------------------------------------
# random draws (the port's stand-in for a key iterator)
# --------------------------------------------------------------------------
class Draws:
    """Where an init's leaves come from: normal draws from ``generator``
    on its own device, moved to ``device``; with no generator, leaves on
    the meta device (shapes only, no memory)."""

    def __init__(self, generator: torch.Generator | None = None,
                 device: torch.device | str = "meta"):
        self.generator = generator
        self.device = torch.device(device)
        if generator is None and self.device.type != "meta":
            raise ValueError("a Draws off the meta device needs a generator")

    def normal(self, shape, std: float) -> torch.Tensor:
        if self.generator is None:
            return torch.empty(shape, device="meta")
        draw = torch.randn(shape, generator=self.generator,
                           device=self.generator.device)
        return draw.mul_(std).to(self.device)

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=torch.float32,
                          device=self.device)


# --------------------------------------------------------------------------
# mini conv library (NCHW, OIHW)
# --------------------------------------------------------------------------
def conv_init(draws, cin, cout, k=3, use_bias=False, groups=1):
    fan_in = (cin // groups) * k * k
    p = {"w": draws.normal((cout, cin // groups, k, k),
                           np.sqrt(2.0 / fan_in))}
    if use_bias:
        p["b"] = draws.full((cout,), 0.0)
    return p


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial axis: (before, after), the odd
    element after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(p, x, stride=1, padding="SAME", groups=1):
    w = p["w"]
    pad = 0
    if padding == "SAME":
        (t, b), (l, r) = (same_pads(x.shape[2], w.shape[2], stride),
                          same_pads(x.shape[3], w.shape[3], stride))
        if t == b and l == r:
            pad = (t, l)
        else:
            x = F.pad(x, (l, r, t, b))
    elif padding != "VALID":
        raise ValueError(f"padding {padding!r}: use 'SAME' or 'VALID'")
    return F.conv2d(x, w, p.get("b"), stride, pad, 1, groups)


def bn_init(draws, c):
    return {"scale": draws.full((c,), 1.0), "bias": draws.full((c,), 0.0)}


def bn(p, x, eps=1e-5):
    return F.batch_norm(x, None, None, p["scale"], p["bias"], True, 0.0, eps)


def fc_init(draws, cin, cout):
    return {"w": draws.normal((cin, cout), np.sqrt(1.0 / cin)),
            "b": draws.full((cout,), 0.0)}


def fc(p, x):
    return torch.addmm(p["b"], x, p["w"])


def gap(x):                      # global average pool
    return torch.mean(x, dim=(2, 3))


def maxpool(x, k=2, s=2):
    return F.max_pool2d(x, k, s)


def avgpool(x, k=2, s=2):
    return F.avg_pool2d(x, k, s)


relu = torch.relu


def conv_bn_init(draws, cin, cout, k=3, groups=1):
    return {"conv": conv_init(draws, cin, cout, k, groups=groups),
            "bn": bn_init(draws, cout)}


def conv_bn(p, x, stride=1, groups=1, act=True, padding="SAME"):
    y = bn(p["bn"], conv(p["conv"], x, stride, padding, groups))
    return relu(y) if act else y


def _gate(x, w):
    """An SE gate (B, C) over the channels of x (B, C, H, W)."""
    return x * w[:, :, None, None]


# ==========================================================================
# 1. LeNet  (the paper's flat outlier)
# ==========================================================================
def lenet_init(draws, n_classes=10):
    return {"c1": conv_init(draws, 3, 6, 5, use_bias=True),
            "c2": conv_init(draws, 6, 16, 5, use_bias=True),
            "f1": fc_init(draws, 16 * 5 * 5, 120),
            "f2": fc_init(draws, 120, 84),
            "f3": fc_init(draws, 84, n_classes)}


def lenet_apply(p, x):
    x = maxpool(relu(conv(p["c1"], x, padding="VALID")))
    x = maxpool(relu(conv(p["c2"], x, padding="VALID")))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # f1's (h, w, c)
    return fc(p["f3"], relu(fc(p["f2"], relu(fc(p["f1"], x)))))


# ==========================================================================
# 2. VGG16
# ==========================================================================
_VGG16 = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512, "M"]


def vgg16_init(draws, n_classes=10):
    layers = []
    cin = 3
    for v in _VGG16:
        if v == "M":
            layers.append(None)
        else:
            layers.append(conv_bn_init(draws, cin, v))
            cin = v
    return {"layers": layers, "fc": fc_init(draws, 512, n_classes)}


def vgg16_apply(p, x):
    for spec, lp in zip(_VGG16, p["layers"]):
        x = maxpool(x) if spec == "M" else conv_bn(lp, x)
    return fc(p["fc"], gap(x))


# ==========================================================================
# 3/4. ResNet18 / PreActResNet18
# ==========================================================================
def _basic_block_init(draws, cin, cout, stride, preact=False):
    blk = {"c1": conv_bn_init(draws, cin, cout),
           "c2": conv_bn_init(draws, cout, cout)}
    if preact:
        # pre-activation: bn runs on the conv INPUT (cin / cout channels)
        blk["c1"]["bn"] = bn_init(draws, cin)
    if stride != 1 or cin != cout:
        blk["short"] = conv_bn_init(draws, cin, cout, k=1)
    return blk


def _basic_block(p, x, stride, preact=False):
    if preact:
        h = relu(bn(p["c1"]["bn"], x))
        sc = conv(p["short"]["conv"], h, stride) if "short" in p else x
        h = conv(p["c1"]["conv"], h, stride)
        h = conv(p["c2"]["conv"], relu(bn(p["c2"]["bn"], h)))
        return h + sc
    h = conv_bn(p["c1"], x, stride)
    h = conv_bn(p["c2"], h, act=False)
    sc = conv_bn(p["short"], x, stride, act=False) if "short" in p else x
    return relu(h + sc)


_R18_SPEC = [(64, 1), (64, 1), (128, 2), (128, 1),
             (256, 2), (256, 1), (512, 2), (512, 1)]


def _resnet18_init(draws, n_classes=10, *, preact=False):
    p = {"stem": conv_bn_init(draws, 3, 64), "blocks": [], "fc": None}
    cin = 64
    for cout, stride in _R18_SPEC:
        p["blocks"].append(_basic_block_init(draws, cin, cout, stride,
                                             preact=preact))
        cin = cout
    p["fc"] = fc_init(draws, 512, n_classes)
    return p


def _resnet18_apply(p, x, preact=False):
    x = conv_bn(p["stem"], x) if not preact else conv(p["stem"]["conv"], x)
    for blk, (_, stride) in zip(p["blocks"], _R18_SPEC):
        x = _basic_block(blk, x, stride, preact)
    return fc(p["fc"], gap(relu(x) if preact else x))


resnet18_init = functools.partial(_resnet18_init, preact=False)
resnet18_apply = functools.partial(_resnet18_apply, preact=False)
preactresnet18_init = functools.partial(_resnet18_init, preact=True)
preactresnet18_apply = functools.partial(_resnet18_apply, preact=True)


# ==========================================================================
# 5. SENet18 — ResNet18 with squeeze-excitation
# ==========================================================================
def senet18_init(draws, n_classes=10):
    p = _resnet18_init(draws, n_classes, preact=False)
    p["se"] = []
    for cout in [64, 64, 128, 128, 256, 256, 512, 512]:
        p["se"].append({"f1": fc_init(draws, cout, cout // 16),
                        "f2": fc_init(draws, cout // 16, cout)})
    return p


def senet18_apply(p, x):
    x = conv_bn(p["stem"], x)
    for blk, (_, stride), se in zip(p["blocks"], _R18_SPEC, p["se"]):
        h = _basic_block(blk, x, stride)
        w = torch.sigmoid(fc(se["f2"], relu(fc(se["f1"], gap(h)))))
        x = _gate(h, w)
    return fc(p["fc"], gap(x))


# ==========================================================================
# 6. GoogLeNet (inception)
# ==========================================================================
def _inception_init(draws, cin, n1, n3r, n3, n5r, n5, pp):
    return {"b1": conv_bn_init(draws, cin, n1, 1),
            "b2a": conv_bn_init(draws, cin, n3r, 1),
            "b2b": conv_bn_init(draws, n3r, n3, 3),
            "b3a": conv_bn_init(draws, cin, n5r, 1),
            "b3b": conv_bn_init(draws, n5r, n5, 3),
            "b3c": conv_bn_init(draws, n5, n5, 3),
            "b4": conv_bn_init(draws, cin, pp, 1)}


def _inception_pool(x):
    """JAX's SAME 3x3 stride-1 max ``reduce_window``: -inf pads one on
    each side."""
    return F.max_pool2d(x, 3, 1, padding=1)


def _inception(p, x):
    b1 = conv_bn(p["b1"], x)
    b2 = conv_bn(p["b2b"], conv_bn(p["b2a"], x))
    b3 = conv_bn(p["b3c"], conv_bn(p["b3b"], conv_bn(p["b3a"], x)))
    b4 = conv_bn(p["b4"], _inception_pool(x))
    return torch.cat([b1, b2, b3, b4], dim=1)


_GOOGLE = [(192, 64, 96, 128, 16, 32, 32), (256, 128, 128, 192, 32, 96, 64),
           ("M",), (480, 192, 96, 208, 16, 48, 64),
           (512, 160, 112, 224, 24, 64, 64), (512, 128, 128, 256, 24, 64, 64),
           (512, 112, 144, 288, 32, 64, 64), (528, 256, 160, 320, 32, 128, 128),
           ("M",), (832, 256, 160, 320, 32, 128, 128),
           (832, 384, 192, 384, 48, 128, 128)]


def googlenet_init(draws, n_classes=10):
    p = {"stem": conv_bn_init(draws, 3, 192), "cells": []}
    for spec in _GOOGLE:
        if spec[0] == "M":
            p["cells"].append(None)
        else:
            p["cells"].append(_inception_init(draws, *spec))
    p["fc"] = fc_init(draws, 1024, n_classes)
    return p


def googlenet_apply(p, x):
    x = conv_bn(p["stem"], x)
    for spec, cell in zip(_GOOGLE, p["cells"]):
        x = maxpool(x, 3, 2) if spec[0] == "M" else _inception(cell, x)
    return fc(p["fc"], gap(x))


# ==========================================================================
# 7. DenseNet121
# ==========================================================================
_DN121 = [6, 12, 24, 16]


def densenet121_init(draws, n_classes=10, growth=32):
    cin = 2 * growth
    p = {"stem": conv_bn_init(draws, 3, cin), "blocks": [], "trans": []}
    for bi, n_layers in enumerate(_DN121):
        layers = []
        for _ in range(n_layers):
            layers.append({"c1": conv_bn_init(draws, cin, 4 * growth, 1),
                           "c2": conv_bn_init(draws, 4 * growth, growth, 3)})
            cin += growth
        p["blocks"].append(layers)
        if bi < len(_DN121) - 1:
            cout = cin // 2
            p["trans"].append(conv_bn_init(draws, cin, cout, 1))
            cin = cout
    p["fc"] = fc_init(draws, cin, n_classes)
    return p


def densenet121_apply(p, x):
    x = conv_bn(p["stem"], x)
    for bi, layers in enumerate(p["blocks"]):
        for lp in layers:
            h = conv_bn(lp["c2"], conv_bn(lp["c1"], x))
            x = torch.cat([x, h], dim=1)
        if bi < len(p["trans"]):
            x = avgpool(conv_bn(p["trans"][bi], x, act=False))
    return fc(p["fc"], gap(x))


# ==========================================================================
# 8. ResNeXt29 (2x64d)
# ==========================================================================
_RESNEXT_CARD = 2


def _resnext_spec(card=2, width=64):
    out, cin = [], 64
    for stage, stride0 in [(0, 1), (1, 2), (2, 2)]:
        group_w = card * width * (2 ** stage)
        cout = group_w * 2
        for i in range(3):
            out.append((cin, group_w, cout, stride0 if i == 0 else 1))
            cin = cout
    return out


def resnext29_init(draws, n_classes=10, card=2, width=64):
    p = {"stem": conv_bn_init(draws, 3, 64), "blocks": []}
    for cin, group_w, cout, stride in _resnext_spec(card, width):
        blk = {"c1": conv_bn_init(draws, cin, group_w, 1),
               "c2": conv_bn_init(draws, group_w, group_w, 3, groups=card),
               "c3": conv_bn_init(draws, group_w, cout, 1)}
        if stride != 1 or cin != cout:
            blk["short"] = conv_bn_init(draws, cin, cout, 1)
        p["blocks"].append(blk)
    p["fc"] = fc_init(draws, cout, n_classes)
    return p


def resnext29_apply(p, x):
    x = conv_bn(p["stem"], x)
    for blk, (_, _, _, stride) in zip(p["blocks"], _resnext_spec()):
        h = conv_bn(blk["c1"], x)
        h = conv_bn(blk["c2"], h, stride, groups=_RESNEXT_CARD)
        h = conv_bn(blk["c3"], h, act=False)
        sc = conv_bn(blk["short"], x, stride, act=False) if "short" in blk else x
        x = relu(h + sc)
    return fc(p["fc"], gap(x))


# ==========================================================================
# 9/10. MobileNet / MobileNetV2
# ==========================================================================
def _dw_conv_init(draws, c, k=3):
    # depthwise: OIHW with I = 1, groups = c
    w = draws.normal((c, 1, k, k), np.sqrt(2.0 / (k * k)))
    return {"conv": {"w": w}, "bn": bn_init(draws, c)}


_MBV1 = [64, (128, 2), 128, (256, 2), 256, (512, 2),
         512, 512, 512, 512, 512, (1024, 2), 1024]


def mobilenet_init(draws, n_classes=10):
    p = {"stem": conv_bn_init(draws, 3, 32), "blocks": []}
    cin = 32
    for v in _MBV1:
        cout, _ = (v, 1) if isinstance(v, int) else v
        p["blocks"].append({"dw": _dw_conv_init(draws, cin),
                            "pw": conv_bn_init(draws, cin, cout, 1)})
        cin = cout
    p["fc"] = fc_init(draws, 1024, n_classes)
    return p


def mobilenet_apply(p, x):
    x = conv_bn(p["stem"], x)
    for v, blk in zip(_MBV1, p["blocks"]):
        _, stride = (v, 1) if isinstance(v, int) else v
        # depthwise = grouped conv with groups = cin and 1 filter per group
        x = conv_bn(blk["dw"], x, stride, groups=x.shape[1])
        x = conv_bn(blk["pw"], x)
    return fc(p["fc"], gap(x))


_MBV2 = [(1, 16, 1, 1), (6, 24, 2, 1), (6, 32, 3, 2), (6, 64, 4, 2),
         (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]


def _inverted_residual_spec(spec_table):
    """Flatten (expand, cout, n, stride) stage specs into per-block
    (stride, residual?) statics."""
    out, cin = [], 32
    for t, c, n, s in spec_table:
        for i in range(n):
            stride = s if i == 0 else 1
            out.append((stride, stride == 1 and cin == c, cin * t))
            cin = c
    return out


def mobilenetv2_init(draws, n_classes=10):
    p = {"stem": conv_bn_init(draws, 3, 32), "blocks": []}
    cin = 32
    for t, c, n, s in _MBV2:
        for i in range(n):
            hid = cin * t
            p["blocks"].append({"expand": conv_bn_init(draws, cin, hid, 1),
                                "dw": _dw_conv_init(draws, hid),
                                "project": conv_bn_init(draws, hid, c, 1)})
            cin = c
    p["head"] = conv_bn_init(draws, cin, 1280, 1)
    p["fc"] = fc_init(draws, 1280, n_classes)
    return p


def mobilenetv2_apply(p, x):
    x = conv_bn(p["stem"], x)
    for blk, (stride, res, _) in zip(p["blocks"], _inverted_residual_spec(_MBV2)):
        h = conv_bn(blk["expand"], x)
        h = conv_bn(blk["dw"], h, stride, groups=h.shape[1])
        h = conv_bn(blk["project"], h, act=False)
        x = x + h if res else h
    return fc(p["fc"], gap(conv_bn(p["head"], x)))


# ==========================================================================
# 11. ShuffleNetV2
# ==========================================================================
def _channel_shuffle(x, groups=2):
    B, C, H, W = x.shape
    return x.reshape(B, groups, C // groups, H, W).transpose(1, 2) \
            .reshape(B, C, H, W)


_SHUFFLE_V2 = [(116, 4), (232, 8), (464, 4)]


def shufflenetv2_init(draws, n_classes=10):
    p = {"stem": conv_bn_init(draws, 3, 24), "stages": []}
    cin = 24
    for cout, n in _SHUFFLE_V2:
        stage = []
        # downsample unit: both branches convolved
        stage.append({
            "b1dw": _dw_conv_init(draws, cin),
            "b1pw": conv_bn_init(draws, cin, cout // 2, 1),
            "b2pw1": conv_bn_init(draws, cin, cout // 2, 1),
            "b2dw": _dw_conv_init(draws, cout // 2),
            "b2pw2": conv_bn_init(draws, cout // 2, cout // 2, 1)})
        for _ in range(n - 1):
            half = cout // 2
            stage.append({
                "pw1": conv_bn_init(draws, half, half, 1),
                "dw": _dw_conv_init(draws, half),
                "pw2": conv_bn_init(draws, half, half, 1)})
        p["stages"].append(stage)
        cin = cout
    p["head"] = conv_bn_init(draws, cin, 1024, 1)
    p["fc"] = fc_init(draws, 1024, n_classes)
    return p


def shufflenetv2_apply(p, x):
    x = conv_bn(p["stem"], x)
    for stage in p["stages"]:
        d = stage[0]
        b1 = conv_bn(d["b1pw"], conv_bn(d["b1dw"], x, 2, groups=x.shape[1],
                                        act=False))
        b2 = conv_bn(d["b2pw1"], x)
        b2 = conv_bn(d["b2dw"], b2, 2, groups=b2.shape[1], act=False)
        b2 = conv_bn(d["b2pw2"], b2)
        x = _channel_shuffle(torch.cat([b1, b2], dim=1))
        for blk in stage[1:]:
            x1, x2 = torch.chunk(x, 2, dim=1)
            h = conv_bn(blk["pw1"], x2)
            h = conv_bn(blk["dw"], h, groups=h.shape[1], act=False)
            h = conv_bn(blk["pw2"], h)
            x = _channel_shuffle(torch.cat([x1, h], dim=1))
    return fc(p["fc"], gap(conv_bn(p["head"], x)))


# ==========================================================================
# 12. EfficientNetB0
# ==========================================================================
_EFFB0 = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 40, 2, 2), (6, 80, 3, 2),
          (6, 112, 3, 1), (6, 192, 4, 2), (6, 320, 1, 1)]


def efficientnetb0_init(draws, n_classes=10):
    p = {"stem": conv_bn_init(draws, 3, 32), "blocks": []}
    cin = 32
    for t, c, n, s in _EFFB0:
        for i in range(n):
            hid = cin * t
            blk = {}
            if t != 1:
                blk["expand"] = conv_bn_init(draws, cin, hid, 1)
            blk["dw"] = _dw_conv_init(draws, hid)
            blk["se1"] = fc_init(draws, hid, max(1, cin // 4))
            blk["se2"] = fc_init(draws, max(1, cin // 4), hid)
            blk["project"] = conv_bn_init(draws, hid, c, 1)
            p["blocks"].append(blk)
            cin = c
    p["fc"] = fc_init(draws, cin, n_classes)
    return p


def efficientnetb0_apply(p, x):
    swish = F.silu
    x = swish(bn(p["stem"]["bn"], conv(p["stem"]["conv"], x)))
    statics = _inverted_residual_spec(_EFFB0)
    for blk, (stride, res, _) in zip(p["blocks"], statics):
        h = x
        if "expand" in blk:
            h = swish(bn(blk["expand"]["bn"], conv(blk["expand"]["conv"], h)))
        h = swish(bn(blk["dw"]["bn"],
                     conv(blk["dw"]["conv"], h, stride, groups=h.shape[1])))
        w = torch.sigmoid(fc(blk["se2"], swish(fc(blk["se1"], gap(h)))))
        h = _gate(h, w)
        h = bn(blk["project"]["bn"], conv(blk["project"]["conv"], h))
        x = x + h if res else h
    return fc(p["fc"], gap(x))


# ==========================================================================
# 13. RegNetX_200MF
# ==========================================================================
_REGX200 = [(24, 1, 8), (56, 1, 8), (152, 4, 8), (368, 7, 8)]  # (w, d, group)


def _regnet_spec():
    out, cin = [], 64
    for w, d, g in _REGX200:
        for i in range(d):
            stride = 1 if (i > 0 or w == 24) else 2
            out.append((cin, w, w // g, stride))
            cin = w
    return out


def regnetx200mf_init(draws, n_classes=10):
    p = {"stem": conv_bn_init(draws, 3, 64), "blocks": []}
    for cin, w, groups, stride in _regnet_spec():
        blk = {"c1": conv_bn_init(draws, cin, w, 1),
               "c2": conv_bn_init(draws, w, w, 3, groups=groups),
               "c3": conv_bn_init(draws, w, w, 1)}
        if stride != 1 or cin != w:
            blk["short"] = conv_bn_init(draws, cin, w, 1)
        p["blocks"].append(blk)
    p["fc"] = fc_init(draws, w, n_classes)
    return p


def regnetx200mf_apply(p, x):
    x = conv_bn(p["stem"], x)
    for blk, (_, _, groups, stride) in zip(p["blocks"], _regnet_spec()):
        h = conv_bn(blk["c1"], x)
        h = conv_bn(blk["c2"], h, stride, groups=groups)
        h = conv_bn(blk["c3"], h, act=False)
        sc = conv_bn(blk["short"], x, stride, act=False) \
            if "short" in blk else x
        x = relu(h + sc)
    return fc(p["fc"], gap(x))


# ==========================================================================
# 14. DPN92 (dual path network, CIFAR variant)
# ==========================================================================
_DPN92 = [(96, 256, 16, 3, 1), (192, 512, 32, 4, 2),
          (384, 1024, 24, 20, 2), (768, 2048, 128, 3, 2)]


def _dpn_spec():
    out, cin = [], 64
    for in_planes, out_planes, dense_depth, n, stride0 in _DPN92:
        for i in range(n):
            out.append((cin, in_planes, out_planes, dense_depth,
                        stride0 if i == 0 else 1, i == 0))
            cin = out_planes + (i + 2) * dense_depth
    return out, cin


def dpn92_init(draws, n_classes=10):
    p = {"stem": conv_bn_init(draws, 3, 64), "blocks": []}
    spec, c_final = _dpn_spec()
    for cin, in_planes, out_planes, dense_depth, stride, first in spec:
        blk = {"c1": conv_bn_init(draws, cin, in_planes, 1),
               "c2": conv_bn_init(draws, in_planes, in_planes, 3, groups=32),
               "c3": conv_bn_init(draws, in_planes,
                                  out_planes + dense_depth, 1)}
        if first:    # dual-path: conv shortcut only opens each stage
            blk["short"] = conv_bn_init(draws, cin,
                                        out_planes + dense_depth, 1)
        p["blocks"].append(blk)
    p["fc"] = fc_init(draws, c_final, n_classes)
    return p


def dpn92_apply(p, x):
    x = conv_bn(p["stem"], x)
    spec, _ = _dpn_spec()
    for blk, (_, _, out, d, stride, first) in zip(p["blocks"], spec):
        h = conv_bn(blk["c1"], x)
        h = conv_bn(blk["c2"], h, stride, groups=32)
        h = conv_bn(blk["c3"], h, act=False)
        sc = conv_bn(blk["short"], x, stride, act=False) if first else x
        # dual path: residual add on the first `out` channels, dense-style
        # concat growth on the rest (accumulates +d per block)
        res = sc[:, :out] + h[:, :out]
        dense = torch.cat([sc[:, out:], h[:, out:]], dim=1)
        x = relu(torch.cat([res, dense], dim=1))
    return fc(p["fc"], gap(x))


# ==========================================================================
# 15. SimpleDLA (deep layer aggregation, simplified)
# ==========================================================================
def simpledla_init(draws, n_classes=10):
    widths = [16, 32, 64, 128, 256, 512]
    p = {"stem": conv_bn_init(draws, 3, 16), "stages": []}
    cin = 16
    for w in widths:
        stage = {"b1": _basic_block_init(draws, cin, w, 1),
                 "b2": _basic_block_init(draws, w, w, 1),
                 "agg": conv_bn_init(draws, 2 * w, w, 1)}
        p["stages"].append(stage)
        cin = w
    p["fc"] = fc_init(draws, cin, n_classes)
    return p


def simpledla_apply(p, x):
    x = conv_bn(p["stem"], x)
    for i, stage in enumerate(p["stages"]):
        h1 = _basic_block(stage["b1"], x, 1)
        h2 = _basic_block(stage["b2"], h1, 1)
        x = conv_bn(stage["agg"], torch.cat([h1, h2], dim=1))
        if i >= 2:
            x = maxpool(x)
    return fc(p["fc"], gap(x))


# ==========================================================================
# 16. PNASNet (reduced: PNASNetA cell, CIFAR)
# ==========================================================================
def _pnas_spec(f=44):
    out, cin = [], f
    for stage in range(3):
        cout = f * (2 ** stage)
        n_cells = 6 if stage < 2 else 5
        for i in range(n_cells):
            stride = 2 if (stage > 0 and i == 0) else 1
            out.append((cin, cout, stride))
            cin = cout
    return out


def pnasnet_init(draws, n_classes=10, f=44):
    p = {"stem": conv_bn_init(draws, 3, f), "cells": []}
    for cin, cout, stride in _pnas_spec(f):
        cell = {"sep": _dw_conv_init(draws, cin, 7 if stride == 2 else 5),
                "pw": conv_bn_init(draws, cin, cout, 1)}
        if stride == 2 or cin != cout:
            cell["short"] = conv_bn_init(draws, cin, cout, 1)
        p["cells"].append(cell)
    p["fc"] = fc_init(draws, cout, n_classes)
    return p


def pnasnet_apply(p, x):
    x = conv_bn(p["stem"], x)
    for cell, (_, _, stride) in zip(p["cells"], _pnas_spec()):
        h = conv_bn(cell["sep"], x, stride, groups=x.shape[1], act=False)
        h = conv_bn(cell["pw"], h, act=False)
        sc = conv_bn(cell["short"], x, stride, act=False) \
            if "short" in cell else x
        x = relu(h + sc)
    return fc(p["fc"], gap(x))


# ==========================================================================
# registry — the paper's 16 models
# ==========================================================================
CNN_ZOO: dict[str, tuple[Callable, Callable]] = {
    "SimpleDLA": (simpledla_init, simpledla_apply),
    "DPN92": (dpn92_init, dpn92_apply),
    "DenseNet121": (densenet121_init, densenet121_apply),
    "EfficientNetB0": (efficientnetb0_init, efficientnetb0_apply),
    "GoogLeNet": (googlenet_init, googlenet_apply),
    "LeNet": (lenet_init, lenet_apply),
    "MobileNet": (mobilenet_init, mobilenet_apply),
    "MobileNetV2": (mobilenetv2_init, mobilenetv2_apply),
    "PNASNet": (pnasnet_init, pnasnet_apply),
    "PreActResNet18": (preactresnet18_init, preactresnet18_apply),
    "RegNetX_200MF": (regnetx200mf_init, regnetx200mf_apply),
    "ResNet18": (resnet18_init, resnet18_apply),
    "ResNeXt29_2x64d": (resnext29_init, resnext29_apply),
    "SENet18": (senet18_init, senet18_apply),
    "ShuffleNetV2": (shufflenetv2_init, shufflenetv2_apply),
    "VGG16": (vgg16_init, vgg16_apply),
}


def _nll(logits, labels):
    """The mean of logsumexp(logits) - logits[label], in the logits'
    dtype (JAX's ``cnn_loss`` casts nothing)."""
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return torch.mean(torch.logsumexp(logits, dim=-1) - gold)


def cnn_loss(apply_fn, params, images, labels):
    return _nll(apply_fn(params, images), labels)


# the optimizer of the paper benchmark's CNN step (benchmarks/common.py:
# 93-95), as keywords of ``optim.OptimizerConfig``; its schedule is
# constant, so ``total_steps`` does not matter
OPTIMIZER = dict(learning_rate=1e-3, warmup_steps=2, weight_decay=0.0,
                 schedule="constant")


def loss_and_grads(apply_fn, params, images, labels):
    """``((loss, logits), grads)`` as ``jax.value_and_grad(..., has_aux=
    True)`` of ``cnn_loss`` gives them: ``grads`` has the structure of
    ``params`` (whose leaves must require grad), with a zero gradient for
    a leaf the forward never reads; ``loss`` and ``logits`` are
    detached."""
    leaves = common.tree_leaves(params)
    logits = apply_fn(params, images)
    loss = _nll(logits, labels)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    by_leaf = {id(p): g for p, g in zip(leaves, grads)}
    return ((loss.detach(), logits.detach()),
            common.tree_map(lambda p: by_leaf[id(p)], params))
