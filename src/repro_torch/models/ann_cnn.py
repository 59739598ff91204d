"""ANN teacher models for the KD framework (twin of ``repro.models.ann_cnn``;
the paper's teacher is a ReLU ResNet, §V.A): ResNet-18, ResNet-34 and the
ANN VGG-11, on the layer library of ``nn.py``. Their convs are plain
``nn.conv_apply`` (cuDNN in IEEE f32), as the reference leaves them to XLA
outside any Pallas kernel.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import DeviceLike, resolve_device
from . import nn

_DEPTHS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}
_VGG11 = [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512]


@dataclasses.dataclass(frozen=True)
class ANNCNNConfig:
    arch: str = "resnet34"          # resnet18 | resnet34 | vgg11
    num_classes: int = 10
    in_channels: int = 3
    image_size: int = 32
    width_mult: float = 1.0
    dtype: torch.dtype = torch.float32


def _c(ch: int, cfg: ANNCNNConfig) -> int:
    return max(8, int(ch * cfg.width_mult))


def build_layers(cfg: ANNCNNConfig) -> list[tuple]:
    layers: list[tuple] = []
    cin = cfg.in_channels
    size = cfg.image_size
    if cfg.arch == "vgg11":
        for item in _VGG11:
            if item == "M":
                layers.append(("maxpool",))
                size //= 2
            else:
                cout = _c(item, cfg)
                layers.append(("conv", cin, cout, 1))
                cin = cout
    elif cfg.arch in _DEPTHS:
        stem = _c(64, cfg)
        layers.append(("conv", cin, stem, 1))
        cin = stem
        for stage, nblk in enumerate(_DEPTHS[cfg.arch]):
            cout = _c(64 * (2 ** stage), cfg)
            for i in range(nblk):
                stride = 2 if (stage > 0 and i == 0) else 1
                layers.append(("resblock", cin, cout, stride))
                cin = cout
                size //= stride
    else:
        raise ValueError(f"unknown ann-cnn arch {cfg.arch!r}")
    layers.append(("head", cin, size))
    return layers


def init(gen: torch.Generator, cfg: ANNCNNConfig,
         device: DeviceLike = None) -> dict:
    """Random variables ``{"params", "state"}`` in the reference's layout,
    drawn from ``gen`` (carry the reference's draws across with
    ``convert``)."""
    dev = resolve_device(device)
    dt = cfg.dtype
    params: list = []
    state: list = []
    for layer in build_layers(cfg):
        kind = layer[0]
        if kind == "conv":
            _, cin, cout, _ = layer
            bn_p, bn_s = nn.bn_init(cout, dt, dev)
            params.append({"conv": nn.conv_init(gen, 3, 3, cin, cout,
                                                dtype=dt, device=dev),
                           "bn": bn_p})
            state.append({"bn": bn_s})
        elif kind == "maxpool":
            params.append({})
            state.append({})
        elif kind == "resblock":
            _, cin, cout, stride = layer
            bn1p, bn1s = nn.bn_init(cout, dt, dev)
            bn2p, bn2s = nn.bn_init(cout, dt, dev)
            p = {"conv1": nn.conv_init(gen, 3, 3, cin, cout, dtype=dt,
                                       device=dev), "bn1": bn1p,
                 "conv2": nn.conv_init(gen, 3, 3, cout, cout, dtype=dt,
                                       device=dev), "bn2": bn2p}
            s = {"bn1": bn1s, "bn2": bn2s}
            if stride != 1 or cin != cout:
                bnsp, bnss = nn.bn_init(cout, dt, dev)
                p["conv_sc"] = nn.conv_init(gen, 1, 1, cin, cout, dtype=dt,
                                            device=dev)
                p["bn_sc"] = bnsp
                s["bn_sc"] = bnss
            params.append(p)
            state.append(s)
        elif kind == "head":
            _, cin, _ = layer
            params.append({"fc": nn.linear_init(gen, cin, cfg.num_classes,
                                                dtype=dt, device=dev)})
            state.append({})
    return {"params": params, "state": state}


def _conv_bn_relu(conv_p, bn_p, bn_s, x, train, stride=1, relu=True):
    y = nn.conv_apply(conv_p, x, stride)
    y, new_s = nn.bn_apply(bn_p, bn_s, y, train)
    if relu:
        y = torch.relu(y)
    return y, new_s


def apply(variables: dict, images: torch.Tensor, cfg: ANNCNNConfig,
          train: bool = False) -> tuple[torch.Tensor, list]:
    """images [B, H, W, C] -> (logits [B, classes], new BN state list)."""
    params, state = variables["params"], variables["state"]
    x = images.to(cfg.dtype)
    new_state: list = []
    logits = None
    for p, s, layer in zip(params, state, build_layers(cfg)):
        kind = layer[0]
        if kind == "conv":
            x, bn_s = _conv_bn_relu(p["conv"], p["bn"], s["bn"], x, train,
                                    layer[3])
            new_state.append({"bn": bn_s})
        elif kind == "maxpool":
            x = nn.max_pool(x)
            new_state.append({})
        elif kind == "resblock":
            stride = layer[3]
            y, bn1_s = _conv_bn_relu(p["conv1"], p["bn1"], s["bn1"], x,
                                     train, stride)
            y2 = nn.conv_apply(p["conv2"], y, 1)
            y2, bn2_s = nn.bn_apply(p["bn2"], s["bn2"], y2, train)
            ns = {"bn1": bn1_s, "bn2": bn2_s}
            if "conv_sc" in p:
                sc = nn.conv_apply(p["conv_sc"], x, stride)
                sc, ns["bn_sc"] = nn.bn_apply(p["bn_sc"], s["bn_sc"], sc,
                                              train)
            else:
                sc = x
            x = torch.relu(y2 + sc)
            new_state.append(ns)
        elif kind == "head":
            _, _, size = layer
            pooled = nn.avg_pool(x, size).reshape(x.shape[0], -1)
            logits = nn.linear_apply(p["fc"], pooled)
            new_state.append({})
    return logits, new_state
