"""How the profiler's device clock sits against its host clock, on the card.

``chip_smoke.py``'s ``device_breakdown`` reads kernels from
``torch.profiler`` windows, and the profiler drops a device event that its
clock places outside the recorded window.  This script profiles windows of
5 ``push_pull`` steps of the 40 x 1 MB bucket on 8 ranks (one K4 ring
launch each) with no idle time around the steps and with 10 ms at each
end, and prints for each window the kernel events it kept and, from the
window's Chrome trace, the launches with no kernel event and the least
kernel start minus its launch's start (``chip_smoke.launch_offsets``): a
negative value is a kernel placed before it was launched, by that much.
Then it prints ``device_breakdown``'s reading of the same step.

    python3 tools/profiler_window.py [--windows 12]

Needs one card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=12,
                    help="windows at each padding (default 12)")
    args = ap.parse_args()
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    import chip_smoke as cs
    import pslite_tpu_torch as ps

    if not torch.cuda.is_available():
        print("profiler_window: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    eng = ps.CollectiveEngine(ps.DeviceGroup(cs.N), server_handle="sum",
                              impl="pallas")
    eng.register_dense("b", np.arange(cs.KEYS, dtype=np.uint64), cs.VAL_LEN)
    inp = torch.ones(cs.N * eng.bucket("b").padded_len, device="cuda")

    def step():
        eng.push_pull("b", inp)

    for _ in range(5):
        step()
    torch.cuda.synchronize()
    least = {}
    for pad in (0.0,) * args.windows + (0.01,) * args.windows:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=5)) as prof:
            step()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(pad)
            for _ in range(5):
                step()
            torch.cuda.synchronize()
            time.sleep(pad)
        counts = [ev.count for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA
                  and ev.self_device_time_total
                  and not ev.key.startswith("ProfilerStep")]
        missing, offset_us = cs.launch_offsets(prof)
        if offset_us is not None:
            least[pad] = min(least.get(pad, offset_us), offset_us)
        print(f"pad {pad * 1e3:g} ms: kernel events {counts}, launches "
              f"without a kernel {missing}, least kernel-minus-launch "
              f"start {offset_us} us", flush=True)
    for pad, us in least.items():
        print(f"least kernel-minus-launch start over the windows padded "
              f"{pad * 1e3:g} ms: {us} us [{smi}]")
    busy_ms, kernels = cs.device_breakdown(torch, step)
    print(f"device_breakdown: busy {busy_ms:.4f} ms/step, kernels "
          f"{[(k, round(ms, 4)) for k, ms in kernels]} [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
