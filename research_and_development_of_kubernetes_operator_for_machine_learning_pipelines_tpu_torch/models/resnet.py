"""ResNet-50 image classifier in PyTorch (port of the JAX package's
``models/resnet.py``; baseline config 2, the canary traffic shift).

Inference only, with batch norm folded into a scale and bias per channel.
The parameter tree is the reference's: conv weights HWIO
(``[kh, kw, cin, cout]``), folded BN leaves ``{"scale", "bias"}``, and
``fc`` ``{"w" [cin, classes], "b"}``, so a ``params.npz``, a snapshot or
``convert.from_jax_numpy`` carries it one to one.

Serving layout: images arrive NHWC (the wire's ``[B, H, W, 3]``), and
``permute(0, 3, 1, 2)`` is an NCHW view with channels-last strides, which
cuDNN takes without a copy.  :func:`prepare` makes the one copy of each
conv weight the convolutions want, OIHW in channels-last memory (OHWI
bytes), at build time; :func:`forward` on the reference tree prepares on
every call (the tests' path).

Padding is XLA's ``SAME``: ``total = max((out - 1) * s + k - in, 0)``,
``total // 2`` before and the rest after, so a stride-2 conv on an even
input pads one more pixel after than before (the 7x7 stem at 224 pads
(2, 3), a 3x3 stride-2 conv at 56 pads (0, 1)); ``padding=k // 2`` would
shift every stride-2 block by a pixel.

Precision: the reference computes in the images' dtype with f32
accumulation (``_conv``), at XLA's default precision, which on its TPU
runs f32 convolutions as bf16 passes.  Here the convolutions run under
``cudnn.flags(allow_tf32=CONV_TF32)``, set around each forward by this
module: TF32 on the card (a 10-bit mantissa, finer than the reference's
default), plain f32 or f64 on the CPU.  The classifier's matmul is an
f32 product at the process's matmul precision (IEEE unless something
sets ``torch.backends.cuda.matmul.allow_tf32``, which the port never
does).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

# TF32 for the f32 convolutions on the card (see the module docstring).
CONV_TF32 = True


@dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: tuple[int, ...] = (3, 4, 6, 3)  # ResNet-50
    num_classes: int = 1000
    width: int = 64

    @classmethod
    def resnet50(cls, **kw) -> "ResNetConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "ResNetConfig":
        defaults = dict(stage_sizes=(1, 1), num_classes=10, width=8)
        defaults.update(kw)
        return cls(**defaults)


def fold_batchnorm(gamma, beta, mean, var, eps: float = 1e-5) -> dict:
    """Fold BN running statistics into an affine scale and bias."""
    scale = gamma / torch.sqrt(var + eps)
    return {"scale": scale, "bias": beta - mean * scale}


def _block_stride(stage_index: int, block_index: int) -> int:
    return 2 if (stage_index > 0 and block_index == 0) else 1


def init(gen: torch.Generator, cfg: ResNetConfig, dtype=torch.float32, device=None) -> dict:
    """He-normal conv weights from ``gen`` (std sqrt(2 / fan_in)), BN folded
    to the identity, the classifier normal with std 0.01, in the
    reference's layout."""

    def normal(shape, std):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (std * w).to(dtype)

    def conv(kh, kw, cin, cout):
        return normal((kh, kw, cin, cout), (2.0 / (kh * kw * cin)) ** 0.5)

    def bn(c):
        return {"scale": torch.ones((c,), dtype=dtype, device=device),
                "bias": torch.zeros((c,), dtype=dtype, device=device)}

    w = cfg.width
    params: dict = {"stem": {"conv": conv(7, 7, 3, w), "bn": bn(w)}, "stages": []}
    cin = w
    for si, n in enumerate(cfg.stage_sizes):
        cmid = w * (2**si)
        cout = cmid * 4
        stage = []
        for bi in range(n):
            stride = _block_stride(si, bi)
            block = {
                "conv1": conv(1, 1, cin, cmid), "bn1": bn(cmid),
                "conv2": conv(3, 3, cmid, cmid), "bn2": bn(cmid),
                "conv3": conv(1, 1, cmid, cout), "bn3": bn(cout),
            }
            if cin != cout or stride != 1:
                block["proj"] = conv(1, 1, cin, cout)
                block["proj_bn"] = bn(cout)
            stage.append(block)
            cin = cout
        params["stages"].append(stage)
    params["fc"] = {"w": normal((cin, cfg.num_classes), 0.01),
                    "b": torch.zeros((cfg.num_classes,), dtype=dtype, device=device)}
    return params


_CONV_KEYS = ("conv", "conv1", "conv2", "conv3", "proj")


def prepare(params: dict) -> dict:
    """The serving copy of the tree: every conv weight as OIHW in
    channels-last memory, at its stored dtype; the other leaves shared."""

    def walk(node):
        if isinstance(node, list):
            return [walk(v) for v in node]
        if not isinstance(node, dict):
            return node
        return {k: (v.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                    if k in _CONV_KEYS else walk(v))
                for k, v in node.items()}

    return walk(params)


def _same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """XLA's SAME padding of an NCHW tensor for a k x k window at ``stride``."""
    pads = []
    for size in (x.shape[3], x.shape[2]):  # F.pad lists the last dim first
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """SAME convolution of NCHW ``x`` with an OIHW weight, in x's dtype."""
    k = w.shape[-1]
    return F.conv2d(_same_pad(x, k, stride), w.to(x.dtype), stride=stride)


def _scale_bias(x: torch.Tensor, sb: dict) -> torch.Tensor:
    """Folded batch norm, ``x * scale + bias`` per channel (NCHW)."""
    return x * sb["scale"].to(x.dtype)[:, None, None] + sb["bias"].to(x.dtype)[:, None, None]


def _bottleneck(x: torch.Tensor, p: dict, stride: int) -> torch.Tensor:
    out = F.relu(_scale_bias(_conv(x, p["conv1"]), p["bn1"]))
    out = F.relu(_scale_bias(_conv(out, p["conv2"], stride=stride), p["bn2"]))
    out = _scale_bias(_conv(out, p["conv3"]), p["bn3"])
    if "proj" in p:
        x = _scale_bias(_conv(x, p["proj"], stride=stride), p["proj_bn"])
    return F.relu(out + x)


def forward_prepared(prepared: dict, images: torch.Tensor, cfg: ResNetConfig) -> torch.Tensor:
    """images [B, H, W, 3] -> logits [B, num_classes] f32, on a tree from
    :func:`prepare`, computed in the images' dtype."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=CONV_TF32):
        x = images.permute(0, 3, 1, 2)  # NCHW view, channels-last strides
        x = F.relu(_scale_bias(_conv(x, prepared["stem"]["conv"], stride=2),
                               prepared["stem"]["bn"]))
        # 3x3 / 2 max pool with -inf padding (1, 1): F.max_pool2d's padding.
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        for si, stage in enumerate(prepared["stages"]):
            for bi, block in enumerate(stage):
                x = _bottleneck(x, block, _block_stride(si, bi))
    x = x.mean(dim=(2, 3))  # global average pool
    fc = prepared["fc"]
    logits = x @ fc["w"].to(x.dtype) + fc["b"].to(x.dtype)
    return logits.to(torch.float32)


def forward(params: dict, images: torch.Tensor, cfg: ResNetConfig) -> torch.Tensor:
    """images [B, H, W, 3] float -> logits [B, num_classes] float32, on the
    reference's tree."""
    return forward_prepared(prepare(params), images, cfg)
