"""ResNet-50 gradient push/pull trace (BASELINE config 4).

Counterpart of ``pslite_tpu/models/resnet_trace.py`` (:17-159).  BytePS's
flagship workload is the ResNet-50 gradient stream: about 25.5M f32
parameters (102 MB) pushed and pulled every step.  The reference has no
model code; the trace is the traffic shape.  The per-tensor sizes come
from the architecture ([3, 4, 6, 3] bottleneck blocks), and the stream is
replayed through the collective engine as bucketed dense push_pulls.
"""

from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch


def resnet50_param_sizes() -> List[Tuple[str, int]]:
    """(name, float32 element count) per tensor, ~25.5M total."""
    sizes: List[Tuple[str, int]] = []

    def conv(name, kh, kw, cin, cout):
        sizes.append((f"{name}.weight", kh * kw * cin * cout))
        sizes.append((f"{name}.bn", 2 * cout))  # gamma+beta

    conv("stem", 7, 7, 3, 64)
    cin = 64
    widths = [(64, 256), (128, 512), (256, 1024), (512, 2048)]
    blocks = [3, 4, 6, 3]
    for stage, ((mid, out), n) in enumerate(zip(widths, blocks)):
        for b in range(n):
            base = f"layer{stage + 1}.{b}"
            conv(f"{base}.conv1", 1, 1, cin, mid)
            conv(f"{base}.conv2", 3, 3, mid, mid)
            conv(f"{base}.conv3", 1, 1, mid, out)
            if b == 0:
                conv(f"{base}.downsample", 1, 1, cin, out)
            cin = out
    sizes.append(("fc.weight", 2048 * 1000))
    sizes.append(("fc.bias", 1000))
    return sizes


def total_params() -> int:
    return sum(n for _, n in resnet50_param_sizes())


def make_buckets(bucket_bytes: int = 4 << 20) -> List[Tuple[str, int]]:
    """Size-bucketing of the gradient stream: small tensors fuse into
    partition-sized buckets and oversized tensors split into
    partition-sized chunks (the reference's BYTEPS_PARTITION_BYTES
    semantics, rdma_transport.h:591-617)."""
    buckets: List[Tuple[str, int]] = []
    cur = 0
    idx = 0
    limit = bucket_bytes // 4  # fp32 elements

    def flush():
        nonlocal cur, idx
        if cur:
            buckets.append((f"rn50_bucket{idx}", cur))
            idx += 1
            cur = 0

    for _, n in resnet50_param_sizes():
        while n >= limit:
            flush()
            buckets.append((f"rn50_bucket{idx}", limit))
            idx += 1
            n -= limit
        if cur + n > limit:
            flush()
        cur += n
    flush()
    return buckets


def replay(engine, steps: int = 1, bucket_bytes: int = 4 << 20,
           grouped: bool = True, host_origin: bool = False,
           overlap: bool = True, measure=None):
    """Run the ResNet-50 push/pull trace through a CollectiveEngine.

    ``grouped=True`` pushes the whole gradient stream as one
    ``push_pull_group`` per step; ``False`` replays bucket by bucket.

    ``host_origin=True`` replays the path a framework takes: each
    bucket's gradient starts as a host numpy array every step.  With
    ``overlap=True`` the buckets go through ``push_pull_multi_stream``,
    which stages bucket i+1 onto the device (pinned buffers, a copy
    stream) while bucket i reduces; ``overlap=False`` copies each bucket
    in its ``push_pull`` call, serially (the baseline of the overlap).

    ``measure(loop) -> seconds | None`` replaces the host clock (for
    example with CUDA events); None means that clock has no reading and
    is passed on.  Returns (bytes moved per step, seconds per step).
    """
    buckets = make_buckets(bucket_bytes)
    grads = {}
    host = {}
    for name, n in buckets:
        engine.register_dense(name, np.arange(1, dtype=np.uint64), n)
        shape = (engine.num_workers, engine.bucket(name).padded_len)
        if host_origin:
            host[name] = np.ones(shape, np.float32)
        else:
            grads[name] = torch.ones(shape, dtype=torch.float32,
                                     device=engine.device)
    names = [name for name, _ in buckets]
    # Groups take stateless handles only; an engine built with a fused
    # optimizer handle replays bucket by bucket.
    grouped = grouped and not engine.handle_is_stateful and not host_origin

    def one_step():
        if grouped:
            engine.push_pull_group(names, [grads[n] for n in names])
        elif not host_origin:
            for n in names:
                engine.push_pull(n, grads[n])
        elif not overlap:
            for n in names:
                engine.push_pull(n, host[n])
        else:
            for _ in engine.push_pull_multi_stream(
                    ((n, host[n]) for n in names), depth=2):
                pass

    one_step()  # first touch: allocations, the kernel library
    engine.block()

    def loop():
        for _ in range(steps):
            one_step()
        engine.block()

    if measure is not None:
        elapsed = measure(loop)
    else:
        t0 = time.perf_counter()
        loop()
        elapsed = time.perf_counter() - t0
    dt = elapsed / max(steps, 1) if elapsed is not None else None
    step_bytes = 2 * 4 * sum(n for _, n in buckets)  # push + pull
    return step_bytes, dt
