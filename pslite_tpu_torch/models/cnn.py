"""CNN model family (ResNet-style) with a PS training step, on PyTorch.

Counterpart of ``pslite_tpu/models/cnn.py``: a conv stem, residual
blocks and a linear head, trained data parallel through the flat-store
PS cycle (``ps_step.py``: pull, grad, K4's ring push with the SGD
update).  Params keep JAX's layout (conv weights HWIO, the same keys)
and the public functions take NHWC images, so both packages compare
directly.

Inside, the activations of every rank sit in one NCHW batch whose
channels are rank-major (``[B, R*C, H, W]``), and each conv is one
grouped ``F.conv2d`` with ``groups=R``: rank r's channels meet only rank
r's weights.  Choices against JAX's arithmetic:

- ``padding="SAME"`` (cnn.py:84-90) pads ``total = max((ceil(H/s) - 1)
  * s + k - H, 0)`` rows with ``total // 2`` before and the rest after,
  so a 3x3 conv of stride 2 on an even size pads (0, 1), asymmetric,
  where ``F.conv2d(padding=1)`` would pad (1, 1).  The port pads
  explicitly with ``F.pad`` and convolves unpadded.
- The convs and the head compute in bfloat16 unless the images are
  float64 (cnn.py:81), operands cast and the result cast back, as JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .ps_step import make_flat_ps_step, tree_map
from .transformer import compute_dtype, normal_init


@dataclass(frozen=True)
class CNNConfig:
    num_classes: int = 10
    channels: Tuple[int, ...] = (16, 32)
    blocks_per_stage: int = 1
    image_size: int = 16
    in_channels: int = 3
    dtype: str = "float32"


def init_params(gen: torch.Generator, cfg: CNNConfig, device="cpu"):
    """JAX's shapes and scales (``N(0, 1) * fan_in**-0.5``, scales ones,
    the head bias zeros), drawn from ``gen``."""
    dt = getattr(torch, cfg.dtype)

    def conv(kh, kw, cin, cout):
        return normal_init(gen, (kh, kw, cin, cout), (kh * kw * cin) ** -0.5,
                           dt, device)

    params = {"stem": conv(3, 3, cfg.in_channels, cfg.channels[0]),
              "stages": []}
    cin = cfg.channels[0]
    for cout in cfg.channels:
        stage = []
        for _ in range(cfg.blocks_per_stage):
            block = {
                "conv1": conv(3, 3, cin, cout),
                "conv2": conv(3, 3, cout, cout),
                "scale1": torch.ones((cout,), dtype=dt, device=device),
                "scale2": torch.ones((cout,), dtype=dt, device=device),
            }
            if cin != cout:
                block["proj"] = conv(1, 1, cin, cout)
            stage.append(block)
            cin = cout
        params["stages"].append(stage)
    params["head"] = normal_init(gen, (cin, cfg.num_classes), cin ** -0.5,
                                 dt, device)
    params["head_b"] = torch.zeros((cfg.num_classes,), dtype=dt,
                                   device=device)
    return params


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    """``padding="SAME"``'s (before, after) for one spatial dim."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv2d(x, w, stride, cdt):
    """Per-rank conv: ``x`` ``[B, R*Cin, H, W]``, ``w`` ``[R, kh, kw, Cin,
    Cout]`` (HWIO per rank) -> ``[B, R*Cout, H', W']``."""
    R, kh, kw, cin, cout = w.shape
    ph = _same_pad(x.shape[2], kh, stride)
    pw = _same_pad(x.shape[3], kw, stride)
    xp = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    weight = w.permute(0, 4, 3, 1, 2).reshape(R * cout, cin, kh, kw)
    return F.conv2d(xp.to(cdt), weight.to(cdt), stride=stride,
                    groups=R).to(x.dtype)


def _norm(x, scale):
    """``x * rsqrt(mean(x**2 over H, W) + 1e-5) * scale`` per channel;
    ``scale`` ``[R, C]``."""
    var = torch.mean(torch.square(x), dim=(2, 3), keepdim=True)
    return x * torch.rsqrt(var + 1e-5) * scale.reshape(1, -1, 1, 1)


def _forward_ranks(params, images):
    """Per-rank params and images ``[R, B, H, W, C]`` -> logits ``[R, B,
    num_classes]``."""
    R, B, H, W, C = images.shape
    cdt = compute_dtype(images)
    x = images.permute(1, 0, 4, 2, 3).reshape(B, R * C, H, W)
    x = torch.relu(_conv2d(x, params["stem"], 1, cdt))
    for s, stage in enumerate(params["stages"]):
        for b, block in enumerate(stage):
            stride = 2 if b == 0 and s > 0 else 1
            h = torch.relu(_norm(_conv2d(x, block["conv1"], stride, cdt),
                                 block["scale1"]))
            h = _norm(_conv2d(h, block["conv2"], 1, cdt), block["scale2"])
            shortcut = x
            if "proj" in block:
                shortcut = _conv2d(x, block["proj"], stride, cdt)
            elif stride != 1:
                shortcut = x[:, :, ::stride, ::stride]
            x = torch.relu(h + shortcut)
    pooled = x.mean(dim=(2, 3)).reshape(B, R, -1).transpose(0, 1)
    logits = torch.bmm(pooled.to(cdt), params["head"].to(cdt)).float()
    return logits + params["head_b"][:, None]


def forward(params, images, cfg: CNNConfig, group=None):
    """Images -> logits.  Without ``group``: ``[B, H, W, C]`` -> ``[B,
    num_classes]``; with it, per-rank params and ``[R, B, H, W, C]`` ->
    ``[R, B, num_classes]``."""
    if group is not None:
        return _forward_ranks(params, images)
    one = tree_map(lambda p: p.unsqueeze(0), params)
    return _forward_ranks(one, images.unsqueeze(0))[0]


def loss_fn(params, images, labels, cfg: CNNConfig, group=None):
    """Mean cross-entropy: a scalar, or ``[R]`` with ``group``."""
    logits = forward(params, images, cfg, group)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0].mean(
        dim=-1)


def make_ps_train_step(cfg: CNNConfig, group, lr: float = 0.1,
                       seed: int = 0):
    """Data-parallel PS training over the group's first axis: the
    BytePS CNN cycle (pull, grad, reduce-scatter push with the SGD
    update) on the shared flat-store cycle.  Returns ``(step, store)``;
    ``step(images, labels) -> loss`` on the global batch."""
    axis = group.axis_names[0]
    params0 = init_params(torch.Generator().manual_seed(seed), cfg,
                          device=group.device)
    return make_flat_ps_step(
        group, params0,
        lambda p, img_l, lbl_l: loss_fn(p, img_l, lbl_l, cfg, group),
        [(axis,), (axis,)], lr=lr)


def toy_batch(cfg: CNNConfig, batch: int, seed: int = 0):
    """Learnable toy data: label = quadrant of the brightest corner."""
    rng = np.random.default_rng(seed)
    images = rng.normal(
        size=(batch, cfg.image_size, cfg.image_size, cfg.in_channels)
    ).astype(np.float32)
    labels = rng.integers(0, cfg.num_classes, size=batch).astype(np.int32)
    half = cfg.image_size // 2
    for i, lab in enumerate(labels):
        r = (lab % 2) * half
        c = ((lab // 2) % 2) * half
        images[i, r:r + half, c:c + half] += 2.0 * (lab + 1) / cfg.num_classes
    return images, labels
