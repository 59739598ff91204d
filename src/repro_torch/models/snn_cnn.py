"""The paper's deployed SNN models: VGG-11, ResNet-11, QKFResNet-11 (twin of
``repro.models.snn_cnn``, the deployment half).

Execution contract, as in the reference:
  * multi-timestep tensors are [T, B, H, W, C]; the deployed mode is T=1;
  * every activation between layers is a binary spike map (LIF outputs);
  * the classifier head is W2TTFS (``head="avgpool"`` gives the ANN head);
  * QKFResNet-11 = ResNet-11 + spiking QKFormer block(s) on the final map;
  * ``fuse_model`` folds BN into the conv/linear weights (the F&Q stage) and
    produces the artifact ``forward`` deploys.

``forward`` walks the layer list once, for the whole train/deploy matrix.
On the ``fuse_model`` artifact, ``"reference"`` runs the plain PyTorch
chain (conv, LIF, QK mask) and ``"fused_dense"``/``"fused_packed"`` run
every binary-activation layer as one fused PE pass on the hand-written
kernels, with int8 or bit-packed spike maps and their ``vld_cnt`` maps
between layers. On ``init``'s ``{"params", "state"}`` it is the KD training
graph under the policy's ``"+grad"`` form (unfused conv+BN, or with
``cfg.bn_fold`` the deployed layer bodies on weights folded every step).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from .. import DeviceLike, ops, resolve_device
from ..core.lif import LIFConfig
from ..core.quant import (QuantConfig, fake_quant, fuse_bn_into_conv,
                          fuse_bn_into_linear, quantize_fixed)
from ..core.w2ttfs import avgpool_classifier
from ..ops import SpikeTensor
from . import nn


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
    qk_mask_mode: str = "threshold"  # threshold | or  (Fig 5 atten_reg = "or")
    # BN-folded training forward: fold BN (running statistics, frozen) into
    # the conv/linear weights every step, so the training graph runs the
    # same fused PE layer bodies the deployed artifact runs; gradients reach
    # the conv weights and the BN scale and bias through the fold
    bn_fold: bool = False
    dtype: torch.dtype = torch.float32
    # "reference" (the None default), "fused_dense", "fused_packed"; on the
    # training graph the policy runs in its "+grad" form
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
    """The BN fold of the live training variables: the differentiable twin
    of ``fuse_model``. Each layer's BN (running statistics from ``state``,
    taken as constants) folds into its conv/linear weight, and the folded
    weight goes through the straight-through ``fake_quant``, giving the
    ``{"w", "b"}`` layers of the deployed artifact. It runs inside the
    training graph every step, so gradients reach the conv weights and the
    BN scale and bias through the fold."""
    folded: list = []

    def fq(w):
        return fake_quant(w, cfg.quant, is_weight=True)

    def fold_conv(cp, bp, bs):
        w, b = fuse_bn_into_conv(cp["w"], None, bp["scale"], bp["bias"],
                                 bs["mean"].detach(), bs["var"].detach())
        return {"w": fq(w), "b": b}

    for p, s, layer in zip(params, state, build_layers(cfg)):
        kind = layer[0]
        if kind == "conv_bn_lif":
            folded.append({"conv": fold_conv(p["conv"], p["bn"], s["bn"])})
        elif kind == "resblock":
            f = {c: fold_conv(p[c], p[bn], s[bn])
                 for c, bn in (("conv1", "bn1"), ("conv2", "bn2"))}
            if "conv_sc" in p:
                f["conv_sc"] = fold_conv(p["conv_sc"], p["bn_sc"],
                                         s["bn_sc"])
            folded.append(f)
        elif kind == "qkformer":
            f = {}
            for name in ("q", "k", "proj", "mlp1", "mlp2"):
                bnp, bns = p[f"bn_{name}"], s[f"bn_{name}"]
                w, b = fuse_bn_into_linear(p[name]["w"], None, bnp["scale"],
                                           bnp["bias"], bns["mean"].detach(),
                                           bns["var"].detach())
                f[name] = {"w": fq(w), "b": b}
            folded.append(f)
        elif kind == "head":
            folded.append({"fc": {"w": fq(p["fc"]["w"]), "b": p["fc"]["b"]}})
        else:
            folded.append({})
    return folded


# -------------------------------------------------------------- apply helpers
def _per_step(fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """Apply a per-image fn over [T, B, ...] by folding T into the batch."""
    t, b = x.shape[0], x.shape[1]
    y = fn(x.reshape(t * b, *x.shape[2:]))
    return y.reshape(t, b, *y.shape[1:])


def _qw(w: torch.Tensor, cfg: SNNCNNConfig) -> torch.Tensor:
    return fake_quant(w, cfg.quant, is_weight=True)


def _conv_bn(p: dict, s: dict, x: torch.Tensor, cfg: SNNCNNConfig,
             train: bool, stride: int = 1) -> tuple[torch.Tensor, dict]:
    """conv + BN over [T, B, H, W, C] (BN statistics pooled over T*B);
    returns the current and the new BN state."""
    conv_p = {"w": _qw(p["conv"]["w"], cfg)}
    cur = _per_step(lambda z: nn.conv_apply(conv_p, z, stride), x)
    t, b = cur.shape[0], cur.shape[1]
    flat = cur.reshape(t * b, *cur.shape[2:])
    y, new_bn = nn.bn_apply(p["bn"], s, flat, train)
    return y.reshape(t, b, *cur.shape[2:]), new_bn


def forward(variables, images: torch.Tensor, cfg: SNNCNNConfig, *,
            train: bool = False, policy=None
            ) -> tuple[torch.Tensor, Optional[list], dict]:
    """The forward pass: one layer walk for the whole train/deploy matrix.

    ``variables`` selects the parameter graph:
      * the ``{"params", "state"}`` dict from ``init``: the unfused conv+BN
        training graph (``train`` switches BN between batch statistics with
        running-statistic updates and the running statistics). The policy
        is resolved through its gradient axis (``for_training()``), so
        autograd always sees the surrogate pseudo-derivative: under
        ``"reference"`` this is the plain KD training forward, under a
        fused policy the same graph runs its forward on the kernels. With
        ``cfg.bn_fold`` the walk folds BN into the weights every step
        (``fold_train_params``) and runs the deployed layer bodies, one
        fused PE pass per spiking conv; the running statistics pass through
        unchanged.
      * the list from ``fuse_model``: the BN-folded F&Q artifact.
        ``"reference"`` runs plain PyTorch; ``"fused_dense"`` and
        ``"fused_packed"`` run every binary-activation layer through the
        fused PE kernels with int8 or bit-packed spike maps and their
        ``vld_cnt`` maps between layers (packed: the first LIF's spikes are
        packed, the identity shortcut stays packed, the head unpacks).

    ``images``: [B, H, W, C] analog input on the device the walk runs on
    (direct encoding, repeated across T). ``policy`` (or
    ``cfg.exec_policy``) is an ``ExecutionPolicy`` or preset name.

    Returns (logits [B, classes], new_state, aux): ``new_state`` is the BN
    state list of the unfused graph and None for the deployed one; ``aux``
    carries per-layer spike counts, spike rates, ``vld_reused``,
    ``total_spikes``, ``active_frac`` and, on the event path, the spike
    bytes shipped between kernels (``spike_hbm_bytes``; packed, also
    ``spike_hbm_packed_bytes`` and the int8 ``spike_hbm_dense_bytes``).
    """
    layers = build_layers(cfg)
    fused_graph = not (isinstance(variables, dict) and "params" in variables)
    pol = ops.as_policy(policy, cfg.exec_policy)
    if not fused_graph:
        pol = pol.for_training()
    event = fused_graph and pol.fused and not pol.differentiable
    params = variables if fused_graph else variables["params"]
    state = [None] * len(layers) if fused_graph else variables["state"]
    folded = (not fused_graph) and cfg.bn_fold
    fparams = fold_train_params(params, state, cfg) if folded else params
    t = cfg.timesteps
    x0 = images[None].expand(t, *images.shape).to(cfg.dtype)

    aux: dict = {"spikes": {}, "rates": {}, "vld_reused": 0}
    if event:
        aux["spike_hbm_bytes"] = 0
        if pol.packed:
            aux["spike_hbm_packed_bytes"] = 0
            aux["spike_hbm_dense_bytes"] = 0
    # the hardware atten_reg ("or") gates the deployed graph; the unfused
    # graph uses the config's (surrogate-trainable) mask mode
    qk_mode = "or" if fused_graph else cfg.qk_mask_mode
    new_state: list = []
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

    # ------------------------------------------ float-cell (non-event) ops
    def conv_current(pc: dict, s_in: SpikeTensor, sp: tuple, stride: int
                     ) -> torch.Tensor:
        """conv current over token spikes -> [T, B, Ho, Wo, Cout] f32: a
        cuDNN conv under the reference kernels, conv-as-matmul through the
        differentiable ``ops.matmul`` when the policy runs the kernels."""
        b, h, w_, c = sp
        if pol.fused:
            kh, kw = pc["w"].shape[:2]
            pat, (ho, wo) = ops.im2col(s_in, sp, kh, kw, stride, t=t,
                                       policy=pol)
            w2d = ops.conv_matmul_weights(pc["w"], pat)
            cur = ops.matmul(pat.data.reshape(t, b, ho * wo, -1), w2d,
                             policy=pol).reshape(t, b, ho, wo, -1)
            if "b" in pc:
                cur = cur + pc["b"].to(cur.dtype)
            return cur
        x5 = s_in.data.reshape(t * b, h, w_, c).to(cfg.dtype)
        y = nn.conv_apply(pc, x5, stride)
        return y.reshape(t, b, *y.shape[1:])

    def bn5(cur: torch.Tensor, p_l: dict, s_l: dict, key: str,
            ns: dict) -> torch.Tensor:
        """BN over [T, B, Ho, Wo, C] currents (statistics pooled over T*B,
        the unfused graph only); records the new running statistics."""
        yb, ns[key] = nn.bn_apply(p_l[key], s_l[key],
                                  cur.reshape(cur.shape[0] * cur.shape[1],
                                              *cur.shape[2:]), train)
        return yb.reshape(cur.shape)

    def conv_block(names: tuple, p_l, s_l, s_in, sp, stride, ns
                   ) -> torch.Tensor:
        """One conv current (+BN on the unfused graph)."""
        conv_name, bn_name = names
        if fused_graph:
            return conv_current(p_l[conv_name], s_in, sp, stride)
        cur = conv_current({"w": _qw(p_l[conv_name]["w"], cfg)}, s_in, sp,
                           stride)
        return bn5(cur, p_l, s_l, bn_name, ns)

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
    for li, (p, fp, s, layer) in enumerate(zip(params, fparams, state,
                                               layers)):
        kind = layer[0]
        ns: dict = {}
        if kind == "conv_bn_lif":
            stride = layer[3]
            if st is None:
                # analog input: dense conv (+BN on the unfused graph), then
                # the first LIF enters the spiking domain
                if fused_graph or folded:
                    cur = _per_step(
                        lambda z: nn.conv_apply(fp["conv"], z, stride), x0)
                else:
                    cur, ns["bn"] = _conv_bn(p, s["bn"], x0, cfg, train,
                                             stride)
                st, spatial = to_tokens(lif_chain(cur))
            elif event or folded:
                st, spatial = conv_lif(fp["conv"], st, spatial, stride)
            else:
                cur = conv_block(("conv", "bn"), p, s, st, spatial, stride,
                                 ns)
                st, spatial = to_tokens(lif_chain(cur))
        elif kind == "maxpool":
            st, (h2, w2) = ops.pool(st, spatial, t=t, policy=pol)
            st = account(st)
            spatial = (spatial[0], h2, w2, spatial[3])
        elif kind == "resblock":
            stride = layer[3]
            if event or folded:
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
                s1 = lif_chain(conv_block(("conv1", "bn1"), p, s, st,
                                          spatial, stride, ns))
                st1, sp1 = to_tokens(s1)
                cur2 = conv_block(("conv2", "bn2"), p, s, st1, sp1, 1, ns)
                if "conv_sc" in p:
                    sc = conv_block(("conv_sc", "bn_sc"), p, s, st, spatial,
                                    stride, ns)
                else:
                    b, h, w_, c = spatial
                    sc = st.data.reshape(t, b, h, w_, c).to(cur2.dtype)
                # MS-ResNet shortcut: add membrane currents, then fire
                aux["spikes"][f"res{li}_s1"] = s1.detach().sum()
                st, spatial = to_tokens(lif_chain(cur2 + sc))
        elif kind == "qkformer":
            d = layer[1]
            if event or folded:
                # five fused passes; each consumes the vld map its producer
                # emitted, and the K pass applies the QK token mask on
                # write-back (the hardware "or" atten_reg == rowsum >= 1).
                # The BN-folded training walk runs this same body under the
                # differentiable policy.
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

                def lin_bn(name, inp4):
                    """linear (+bias on the fused graph, +BN on the unfused
                    graph) -> [T, B, hw, d] current."""
                    if fused_graph:
                        cur = ops.matmul(inp4, fp[name]["w"], policy=pol)
                        return cur + fp[name]["b"].to(cur.dtype)
                    cur = ops.matmul(inp4, _qw(p[name]["w"], cfg),
                                     policy=pol)
                    yb, ns[f"bn_{name}"] = nn.bn_apply(
                        p[f"bn_{name}"], s[f"bn_{name}"], cur.reshape(-1, d),
                        train)
                    return yb.reshape(t, b, hw, d)

                q4 = lif_chain(lin_bn("q", tok4))
                k4 = lif_chain(lin_bn("k", tok4))
                attn4 = ops.qk_mask(q4, k4, mode=qk_mode,
                                    surrogate=cfg.lif.surrogate,
                                    alpha=cfg.lif.alpha, policy=pol).data
                y4 = lif_chain(lin_bn("proj", attn4.to(cfg.dtype)) + tok4)
                m1 = lif_chain(lin_bn("mlp1", y4))
                y2 = lif_chain(lin_bn("mlp2", m1) + y4)
                aux["spikes"][f"qkf{li}_q"] = q4.detach().sum()
                aux["spikes"][f"qkf{li}_mask_on"] = (q4.sum(dim=-1) > 0).sum()
                st = SpikeTensor.dense(y2.reshape(t, b * hw, d))
        elif kind == "head":
            _, _, size = layer
            b, h, w_, c = spatial
            if fused_graph or folded:
                fc_w, fc_b = fp["fc"]["w"], fp["fc"]["b"]
            else:
                fc_w, fc_b = _qw(p["fc"]["w"], cfg), p["fc"]["b"]
            if event:                     # the fused head reads the int8 map
                xd = ops.unpack(st, dtype=(torch.int8 if cfg.head == "w2ttfs"
                                           else cfg.dtype), policy=pol)
            else:
                xd = st.data.to(cfg.dtype)
            xd = xd.reshape(t, b, h, w_, c)

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
        if not fused_graph:
            # folded walk: the running statistics are frozen and pass
            # through, so the carry keeps one tree structure
            new_state.append(s if folded else ns)

    aux["total_spikes"] = sum(v for k_, v in aux["spikes"].items()
                              if k_.startswith("layer"))
    if aux["rates"]:
        aux["active_frac"] = (sum(aux["rates"].values())
                              / len(aux["rates"]))
    return logits, (None if fused_graph else new_state), aux
