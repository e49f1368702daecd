"""Train the flagship transformer with PIPELINE parallelism (dp x pp).

(The port's copy of ``examples/train_pipeline.py``.)  The layer stack is
sharded across pipeline stages (each stage owns its key range of layers
— the PS sharding applied to depth), microbatches stream through a
GPipe schedule, and an optional leading data-parallel axis averages
gradients across replicas.  ``--ranks`` virtual ranks on ``--device``,
8 on the card by default, as the original's CPU recipe forces 8
devices::

    python examples/torch/train_pipeline.py --steps 20
    python examples/torch/train_pipeline.py --device cpu --steps 5
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
    ap.add_argument("--micro", type=int, default=2, help="microbatches")
    ap.add_argument("--mb", type=int, default=2, help="microbatch size")
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--ranks", type=int, default=8,
                    help="virtual ranks (the original's devices)")
    ap.add_argument("--device", default="cuda:0",
                    help="torch device of every rank ('cpu' runs the "
                         "plain PyTorch versions)")
    args = ap.parse_args()

    import numpy as np
    import torch

    from pslite_tpu_torch.models.train import make_pp_train_step
    from pslite_tpu_torch.models.transformer import ModelConfig
    from pslite_tpu_torch.parallel.mesh import make_group

    n = args.ranks
    pp = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    if pp == 1:
        raise SystemExit("need an even device count for a pipeline")
    dp = n // pp
    group = (
        make_group((dp, pp), ("dp", "pp"), device=args.device) if dp > 1
        else make_group((pp,), ("pp",), device=args.device)
    )
    print(f"devices={n} mesh=(dp={dp}, pp={pp}) "
          f"backend={group.device}")

    cfg = ModelConfig(vocab=256, dim=args.dim, heads=4, layers=pp)
    step, state = make_pp_train_step(
        cfg, group, lr=args.lr, num_micro=args.micro
    )

    rng = np.random.default_rng(0)
    shape = (
        (dp, args.micro, args.mb, args.seq) if dp > 1
        else (args.micro, args.mb, args.seq)
    )
    inputs = rng.integers(0, cfg.vocab, size=shape).astype(np.int32)
    targets = (inputs + 1) % cfg.vocab
    inputs = torch.as_tensor(inputs, device=group.device)
    targets = torch.as_tensor(targets, device=group.device)

    t0 = time.perf_counter()
    for i in range(args.steps):
        state, loss = step(state, inputs, targets)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss):.4f}")
    dt = (time.perf_counter() - t0) / args.steps
    print(f"{dt * 1e3:.1f} ms/step "
          f"(bubble {(pp - 1)}/{args.micro + pp - 1} of ticks)")


if __name__ == "__main__":
    main()
