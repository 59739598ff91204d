"""The paper's deployed SNN models: VGG-11, ResNet-11, QKFResNet-11 (twin of
``repro.models.snn_cnn``, the deployment half).

Execution contract, as in the reference:
  * multi-timestep tensors are [T, B, H, W, C]; the deployed mode is T=1;
  * every activation between layers is a binary spike map (LIF outputs);
  * the classifier head is W2TTFS (``head="avgpool"`` gives the ANN head);
  * QKFResNet-11 = ResNet-11 + spiking QKFormer block(s) on the final map;
  * ``fuse_model`` folds BN into the conv/linear weights (the F&Q stage) and
    produces the artifact ``forward`` deploys.

``forward`` walks the layer list once. Under ``"reference"`` it runs the
plain PyTorch chain (conv, LIF, QK mask); under ``"fused_dense"`` and
``"fused_packed"`` every binary-activation layer is one fused PE pass on
the hand-written kernels, with int8 or bit-packed spike maps and their
``vld_cnt`` maps between layers. The unfused
training graph (``init``'s ``{"params", "state"}``) comes with the training
slice (ROADMAP queue 1 item 4).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from .. import DeviceLike, ops, resolve_device
from ..core.lif import LIFConfig
from ..core.quant import (QuantConfig, fuse_bn_into_conv, fuse_bn_into_linear,
                          quantize_fixed)
from ..core.w2ttfs import avgpool_classifier
from ..ops import SpikeTensor
from . import nn

_TRAINING_TODO = ("the unfused training graph comes with the training slice "
                  "(ROADMAP queue 1 item 4); pass the fuse_model artifact")


@dataclasses.dataclass(frozen=True)
class SNNCNNConfig:
    arch: str = "vgg11"             # vgg11 | resnet11 | qkfresnet11
    num_classes: int = 10
    in_channels: int = 3
    image_size: int = 32
    width_mult: float = 1.0
    timesteps: int = 1              # T=1 is the paper's deployed mode
    lif: LIFConfig = LIFConfig()
    quant: QuantConfig = QuantConfig()
    head: str = "w2ttfs"            # w2ttfs | avgpool
    qk_blocks: int = 1
    dtype: torch.dtype = torch.float32
    # "reference" (the None default), "fused_dense", "fused_packed"; the
    # "+grad" policies parse but are still to port. The reference's
    # training-graph fields (qk_mask_mode, bn_fold) come with training.
    policy: Optional[Any] = None    # ExecutionPolicy | preset name | None

    def __post_init__(self):
        if self.policy is not None:
            object.__setattr__(self, "policy", ops.as_policy(self.policy))

    @property
    def exec_policy(self) -> ops.ExecutionPolicy:
        return self.policy if self.policy is not None else ops.REFERENCE


# --------------------------------------------------------------- arch tables
_VGG11 = [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512]
_RESNET11_STAGES = [(64, 1), (128, 2), (256, 2), (512, 2)]


def _c(ch: int, cfg: SNNCNNConfig) -> int:
    return max(8, int(ch * cfg.width_mult))


def build_layers(cfg: SNNCNNConfig) -> list[tuple]:
    """Layer descriptor list: (kind, meta...)."""
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
                layers.append(("conv_bn_lif", cin, cout, 1))
                cin = cout
    elif cfg.arch in ("resnet11", "qkfresnet11"):
        stem = _c(64, cfg)
        layers.append(("conv_bn_lif", cin, stem, 1))
        cin = stem
        for ch, stride in _RESNET11_STAGES:
            cout = _c(ch, cfg)
            layers.append(("resblock", cin, cout, stride))
            cin = cout
            size //= stride
        if cfg.arch == "qkfresnet11":
            for _ in range(cfg.qk_blocks):
                layers.append(("qkformer", cin))
    else:
        raise ValueError(f"unknown snn-cnn arch {cfg.arch!r}")
    layers.append(("head", cin, size))
    return layers


# ----------------------------------------------------------------------- init
def init(gen: torch.Generator, cfg: SNNCNNConfig,
         device: DeviceLike = None) -> dict:
    """Random training variables ``{"params", "state"}`` in the reference's
    layout, drawn from ``gen`` (the values differ from the reference's
    ``jax.random`` draws; carry those across with ``convert``)."""
    dev = resolve_device(device)
    dt = cfg.dtype
    params: list = []
    state: list = []

    def bn(c):
        return nn.bn_init(c, dt, dev)

    for layer in build_layers(cfg):
        kind = layer[0]
        if kind == "conv_bn_lif":
            _, cin, cout, _ = layer
            bn_p, bn_s = bn(cout)
            params.append({"conv": nn.conv_init(gen, 3, 3, cin, cout,
                                                dtype=dt, device=dev),
                           "bn": bn_p})
            state.append({"bn": bn_s})
        elif kind == "maxpool":
            params.append({})
            state.append({})
        elif kind == "resblock":
            _, cin, cout, stride = layer
            bn1p, bn1s = bn(cout)
            bn2p, bn2s = bn(cout)
            p = {"conv1": nn.conv_init(gen, 3, 3, cin, cout, dtype=dt,
                                       device=dev), "bn1": bn1p,
                 "conv2": nn.conv_init(gen, 3, 3, cout, cout, dtype=dt,
                                       device=dev), "bn2": bn2p}
            s = {"bn1": bn1s, "bn2": bn2s}
            if stride != 1 or cin != cout:
                bnsp, bnss = bn(cout)
                p["conv_sc"] = nn.conv_init(gen, 1, 1, cin, cout, dtype=dt,
                                            device=dev)
                p["bn_sc"] = bnsp
                s["bn_sc"] = bnss
            params.append(p)
            state.append(s)
        elif kind == "qkformer":
            _, d = layer
            p, s = {}, {}
            for name in ("q", "k", "proj", "mlp1", "mlp2"):
                p[name] = nn.linear_init(gen, d, d, bias=False, dtype=dt,
                                         device=dev)
                p[f"bn_{name}"], s[f"bn_{name}"] = bn(d)
            params.append(p)
            state.append(s)
        elif kind == "head":
            _, cin, _ = layer
            params.append({"fc": nn.linear_init(gen, cin, cfg.num_classes,
                                                dtype=dt, device=dev)})
            state.append({})
    return {"params": params, "state": state}


# ----------------------------------------------------------------- F&Q fusion
def fuse_model(variables: dict, cfg: SNNCNNConfig) -> list:
    """The F&Q stage: fold BN into conv/linear and, with ``cfg.quant``
    enabled, fixed-point-quantize the weights. Returns the fused parameter
    list ``forward`` deploys (conv + bias, no BN)."""
    params, state = variables["params"], variables["state"]
    fused: list = []
    bits = cfg.quant.bits if cfg.quant.enabled else None

    def q(w):
        return quantize_fixed(w, bits, axis=None) if bits else w

    def fold(conv, bnp, bns):
        w, b = fuse_bn_into_conv(conv["w"], None, bnp["scale"], bnp["bias"],
                                 bns["mean"], bns["var"])
        return {"w": q(w), "b": b}

    for p, s, layer in zip(params, state, build_layers(cfg)):
        kind = layer[0]
        if kind == "conv_bn_lif":
            fused.append({"conv": fold(p["conv"], p["bn"], s["bn"])})
        elif kind == "resblock":
            f = {c: fold(p[c], p[bn], s[bn])
                 for c, bn in (("conv1", "bn1"), ("conv2", "bn2"))}
            if "conv_sc" in p:
                f["conv_sc"] = fold(p["conv_sc"], p["bn_sc"], s["bn_sc"])
            fused.append(f)
        elif kind == "qkformer":
            f = {}
            for name in ("q", "k", "proj", "mlp1", "mlp2"):
                bnp, bns = p[f"bn_{name}"], s[f"bn_{name}"]
                w, b = fuse_bn_into_linear(p[name]["w"], None, bnp["scale"],
                                           bnp["bias"], bns["mean"],
                                           bns["var"])
                f[name] = {"w": q(w), "b": b}
            fused.append(f)
        elif kind == "head":
            fused.append({"fc": {"w": q(p["fc"]["w"]), "b": p["fc"]["b"]}})
        else:
            fused.append({})
    return fused


def fold_train_params(params: list, state: list, cfg: SNNCNNConfig) -> list:
    """The differentiable BN fold of the training graph."""
    raise NotImplementedError(_TRAINING_TODO)


# -------------------------------------------------------------- apply helpers
def _per_step(fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """Apply a per-image fn over [T, B, ...] by folding T into the batch."""
    t, b = x.shape[0], x.shape[1]
    y = fn(x.reshape(t * b, *x.shape[2:]))
    return y.reshape(t, b, *y.shape[1:])


def forward(variables, images: torch.Tensor, cfg: SNNCNNConfig, *,
            policy=None) -> tuple[torch.Tensor, None, dict]:
    """The deployed forward on the ``fuse_model`` artifact.

    ``images``: [B, H, W, C] analog input on the device the walk runs on
    (direct encoding, repeated across T). ``policy`` (or
    ``cfg.exec_policy``) is ``"reference"``, ``"fused_dense"`` or
    ``"fused_packed"``. Under ``"fused_packed"`` the first LIF's spikes are
    packed (``ops.pack``), every later spike map crosses device memory as
    int32 words with its ``vld_cnt`` map, the identity shortcut stays
    packed, and the head unpacks (``ops.unpack``).

    Returns (logits [B, classes], None, aux) as the reference does: ``aux``
    carries per-layer spike counts, spike rates, ``vld_reused``,
    ``total_spikes``, ``active_frac`` and, on the event path, the spike
    bytes shipped between kernels (``spike_hbm_bytes``; packed, also
    ``spike_hbm_packed_bytes`` and the int8 ``spike_hbm_dense_bytes`` they
    replace).
    """
    if isinstance(variables, dict) and "params" in variables:
        raise NotImplementedError(_TRAINING_TODO)
    pol = ops.as_policy(policy, cfg.exec_policy)
    if pol.differentiable:
        raise NotImplementedError(
            f"policy {pol.name!r}: the differentiable graph comes with the "
            f"training slice (ROADMAP queue 1 item 4)")
    event = pol.fused
    layers = build_layers(cfg)
    t = cfg.timesteps
    x0 = images[None].expand(t, *images.shape).to(cfg.dtype)

    aux: dict = {"spikes": {}, "rates": {}, "vld_reused": 0}
    if event:
        aux["spike_hbm_bytes"] = 0
        if pol.packed:
            aux["spike_hbm_packed_bytes"] = 0
            aux["spike_hbm_dense_bytes"] = 0
    st: Optional[SpikeTensor] = None   # [T, B*H*W, C] once the net spikes
    spatial = None                     # (B, H, W, C)
    logits = None

    # ------------------------------------------------------ shared helpers
    def account(s_: SpikeTensor) -> SpikeTensor:
        """Device-memory bytes of every spike map shipped between kernels,
        in the format it shipped in."""
        if event:
            aux["spike_hbm_bytes"] += s_.hbm_bytes
            if pol.packed:
                aux["spike_hbm_packed_bytes"] += s_.hbm_bytes
                aux["spike_hbm_dense_bytes"] += s_.dense_bytes
        return s_

    def to_tokens(spk5: torch.Tensor) -> tuple[SpikeTensor, tuple]:
        """[T, B, H, W, C] spikes -> (token SpikeTensor, spatial); the
        event path enters the policy's format here."""
        b, h, w_, c = spk5.shape[1:]
        flat = spk5.reshape(t, b * h * w_, c)
        if event:
            flat = flat.to(torch.int8)
            s_ = ops.pack(flat) if pol.packed else SpikeTensor.dense(flat)
            return account(s_), (b, h, w_, c)
        return SpikeTensor.dense(flat), (b, h, w_, c)

    def lif_chain(cur: torch.Tensor) -> torch.Tensor:
        """Multi-timestep LIF over [T, ...] currents through ``ops.lif``;
        the carry holds post-reset state with ``s_prev = 0``."""
        v = torch.zeros_like(cur[0])
        z = torch.zeros_like(cur[0])
        outs = []
        for ti in range(t):
            s_, v = ops.lif(cur[ti], v, z, lif_cfg=cfg.lif, policy=pol)
            outs.append(s_)
        return torch.stack(outs).to(cur.dtype)

    # -------------------------------------------- reference (non-event) ops
    def conv_current(pc: dict, s_in: SpikeTensor, sp: tuple, stride: int
                     ) -> torch.Tensor:
        """conv current over token spikes -> [T, B, Ho, Wo, Cout] f32."""
        b, h, w_, c = sp
        x5 = s_in.data.reshape(t * b, h, w_, c).to(cfg.dtype)
        y = nn.conv_apply(pc, x5, stride)
        return y.reshape(t, b, *y.shape[1:])

    # ------------------------------------------------- event-cell ops (C3)
    def conv_lif(pc: dict, s_in: SpikeTensor, sp: tuple, stride: int,
                 residual=None) -> tuple[SpikeTensor, tuple]:
        """conv(spikes) + bias + LIF as ONE fused PE pass."""
        kh, kw = pc["w"].shape[:2]
        pat, (ho, wo) = ops.im2col(s_in, sp, kh, kw, stride, t=t,
                                   policy=pol)
        w2d = ops.conv_matmul_weights(pc["w"], pat)
        out = ops.fused_pe_layer(pat, w2d, bias=pc.get("b"),
                                 residual=residual, lif_cfg=cfg.lif,
                                 policy=pol)
        return account(out.spikes), (sp[0], ho, wo, w2d.shape[1])

    def conv_cur_event(pc: dict, s_in: SpikeTensor, sp: tuple,
                       stride: int) -> torch.Tensor:
        """Shortcut conv: event-skipped matmul -> f32 membrane current (it
        joins conv2's fused pass as the residual operand)."""
        kh, kw = pc["w"].shape[:2]
        pat, _ = ops.im2col(s_in, sp, kh, kw, stride, t=t, policy=pol)
        w2d = ops.conv_matmul_weights(pc["w"], pat)
        cur = torch.stack([ops.matmul(pat[ti], w2d, policy=pol)
                           for ti in range(t)])
        return cur + pc["b"].to(torch.float32)

    # ----------------------------------------------------- the layer walk
    for li, (fp, layer) in enumerate(zip(variables, layers)):
        kind = layer[0]
        if kind == "conv_bn_lif":
            stride = layer[3]
            if st is None:
                # analog input: dense conv, then the first LIF enters the
                # spiking domain
                cur = _per_step(
                    lambda z: nn.conv_apply(fp["conv"], z, stride), x0)
                st, spatial = to_tokens(lif_chain(cur))
            elif event:
                st, spatial = conv_lif(fp["conv"], st, spatial, stride)
            else:
                cur = conv_current(fp["conv"], st, spatial, stride)
                st, spatial = to_tokens(lif_chain(cur))
        elif kind == "maxpool":
            st, (h2, w2) = ops.pool(st, spatial, t=t, policy=pol)
            st = account(st)
            spatial = (spatial[0], h2, w2, spatial[3])
        elif kind == "resblock":
            stride = layer[3]
            if event:
                s1, sp1 = conv_lif(fp["conv1"], st, spatial, stride)
                if "conv_sc" in fp:
                    res = conv_cur_event(fp["conv_sc"], st, spatial, stride)
                else:
                    # identity: the binary spike shortcut, in the
                    # policy's format (a packed map stays packed)
                    res = st
                aux["spikes"][f"res{li}_s1"] = s1.count()
                st, spatial = conv_lif(fp["conv2"], s1, sp1, 1, residual=res)
            else:
                s1 = lif_chain(conv_current(fp["conv1"], st, spatial, stride))
                st1, sp1 = to_tokens(s1)
                cur2 = conv_current(fp["conv2"], st1, sp1, 1)
                if "conv_sc" in fp:
                    sc = conv_current(fp["conv_sc"], st, spatial, stride)
                else:
                    b, h, w_, c = spatial
                    sc = st.data.reshape(t, b, h, w_, c).to(cur2.dtype)
                # MS-ResNet shortcut: add membrane currents, then fire
                aux["spikes"][f"res{li}_s1"] = s1.sum()
                st, spatial = to_tokens(lif_chain(cur2 + sc))
        elif kind == "qkformer":
            d = layer[1]
            if event:
                # five fused passes; each consumes the vld map its producer
                # emitted, and the K pass applies the QK token mask on
                # write-back (the hardware "or" atten_reg == rowsum >= 1)
                tok = st
                lifkw = dict(lif_cfg=cfg.lif, policy=pol)
                q3 = ops.fused_pe_layer(tok, fp["q"]["w"], bias=fp["q"]["b"],
                                        **lifkw).spikes
                attn3 = ops.fused_pe_layer(tok, fp["k"]["w"],
                                           bias=fp["k"]["b"], q=q3,
                                           qk_threshold=1.0, **lifkw).spikes
                y3 = ops.fused_pe_layer(attn3, fp["proj"]["w"],
                                        bias=fp["proj"]["b"], residual=tok,
                                        **lifkw).spikes
                m13 = ops.fused_pe_layer(y3, fp["mlp1"]["w"],
                                         bias=fp["mlp1"]["b"], **lifkw).spikes
                y23 = ops.fused_pe_layer(m13, fp["mlp2"]["w"],
                                         bias=fp["mlp2"]["b"], residual=y3,
                                         **lifkw).spikes
                for s_ in (q3, attn3, y3, m13, y23):
                    account(s_)
                aux["vld_reused"] += sum(
                    1 for s_ in (tok, tok, attn3, y3, m13)
                    if s_.vld_cnt is not None)
                aux["spikes"][f"qkf{li}_q"] = q3.count()
                st = y23
            else:
                b, h, w_, _ = spatial
                hw = h * w_
                tok4 = st.data.reshape(t, b, hw, d)

                def lin(name, inp4):
                    cur = ops.matmul(inp4, fp[name]["w"], policy=pol)
                    return cur + fp[name]["b"].to(cur.dtype)

                q4 = lif_chain(lin("q", tok4))
                k4 = lif_chain(lin("k", tok4))
                attn4 = ops.qk_mask(q4, k4, mode="or",
                                    surrogate=cfg.lif.surrogate,
                                    alpha=cfg.lif.alpha, policy=pol).data
                y4 = lif_chain(lin("proj", attn4.to(cfg.dtype)) + tok4)
                m1 = lif_chain(lin("mlp1", y4))
                y2 = lif_chain(lin("mlp2", m1) + y4)
                aux["spikes"][f"qkf{li}_q"] = q4.sum()
                aux["spikes"][f"qkf{li}_mask_on"] = (q4.sum(dim=-1) > 0).sum()
                st = SpikeTensor.dense(y2.reshape(t, b * hw, d))
        elif kind == "head":
            _, _, size = layer
            b, h, w_, c = spatial
            fc_w, fc_b = fp["fc"]["w"], fp["fc"]["b"]
            xd = ops.unpack(st, policy=pol) if event else st.data
            xd = xd.to(cfg.dtype).reshape(t, b, h, w_, c)

            def head_one(s_t):
                if cfg.head == "w2ttfs":
                    return ops.w2ttfs_head(s_t, fc_w, fc_b, window=size,
                                           policy=pol)
                return avgpool_classifier(s_t, fc_w, fc_b, size)

            # rate-decode over T
            logits = torch.stack([head_one(xd[ti])
                                  for ti in range(t)]).mean(dim=0)
        if kind != "head":
            aux["spikes"][f"layer{li}"] = st.count()
            aux["rates"][f"layer{li}"] = st.count() / math.prod(st.shape)

    aux["total_spikes"] = sum(v for k_, v in aux["spikes"].items()
                              if k_.startswith("layer"))
    if aux["rates"]:
        aux["active_frac"] = (sum(aux["rates"].values())
                              / len(aux["rates"]))
    return logits, None, aux
