"""Train the flagship transformer through the PS data plane.

(The port's copy of ``examples/train_flagship.py``.)  One process drives
the whole device group (every rank is worker AND server shard — the
JOINT deployment): ``--ranks`` virtual ranks on ``--device``, 8 on the
card by default, as the original's CPU recipe forces 8 devices.  Each
step pulls, runs forward and backward over ``(dp, sp)`` and pushes
through K4's ring with the fused SGD update::

    python examples/torch/train_flagship.py --steps 20
    python examples/torch/train_flagship.py --device cpu --steps 5

Add ``--moe`` for the expert-parallel variant.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--moe", action="store_true")
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--ranks", type=int, default=8,
                    help="virtual ranks (the original's devices)")
    ap.add_argument("--device", default="cuda:0",
                    help="torch device of every rank ('cpu' runs the "
                         "plain PyTorch versions)")
    args = ap.parse_args()

    import torch

    from pslite_tpu_torch.checkpoint import save_train_state
    from pslite_tpu_torch.models.train import make_ps_train_step, toy_batch
    from pslite_tpu_torch.models.transformer import ModelConfig
    from pslite_tpu_torch.parallel.mesh import make_group

    n = args.ranks
    sp = 2 if n % 2 == 0 else 1
    group = make_group((n // sp, sp), ("dp", "sp"), device=args.device)
    print(f"devices={n} mesh=(dp={n // sp}, sp={sp}) "
          f"backend={group.device}")

    cfg = ModelConfig(
        vocab=256, dim=args.dim, heads=4, layers=args.layers,
        moe_experts=4 * sp if args.moe else 0,
    )
    step, store = make_ps_train_step(cfg, group, lr=args.lr)

    # Batch shards over dp and sequence over sp: round both up so the
    # example runs on any group size.
    dp = n // sp
    batch = -(-args.batch // dp) * dp
    seq = -(-args.seq // sp) * sp
    if (batch, seq) != (args.batch, args.seq):
        print(f"note: batch/seq padded to mesh factors: "
              f"batch {args.batch}->{batch}, seq {args.seq}->{seq}")
    inputs, targets = toy_batch(cfg, batch=batch, seq=seq)
    inputs = torch.as_tensor(inputs, device=group.device)
    targets = torch.as_tensor(targets, device=group.device)

    # Warm up (kernel build, first allocations) before timing, like
    # pslite_tpu_torch/benchmark.py.
    loss = step(inputs, targets)
    print(f"step {0:4d}  loss {float(loss):.4f}  (first use)")
    timed_steps = args.steps - 1
    t0 = time.perf_counter()
    for i in range(1, args.steps):
        loss = step(inputs, targets)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss):.4f}")
    store.engine.block(store.name)
    dt = time.perf_counter() - t0
    if timed_steps > 0:
        toks = batch * seq * timed_steps
        print(f"{toks / dt:,.0f} tokens/s (steady state, "
              f"{timed_steps} timed steps)")
    else:
        print("(need --steps >= 2 for a steady-state throughput number)")

    if args.checkpoint:
        written = save_train_state(store.array(), args.steps,
                                   args.checkpoint)
        print(f"saved {written}")


if __name__ == "__main__":
    main()
