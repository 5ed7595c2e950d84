#!/usr/bin/env python3
"""What torch.profiler costs around one B=64 greedy predict of CaSE at the
serving widths (chip_smoke.py's model and batch), on one NVIDIA card.

    python3 tools/probe_profile_cost.py      # from the repository root

Twice each, in turns: a profile that records the host's operator events
and the device's activity, and one that records the device's alone. For
each: the whole call in s, the predict's ms inside the window, the
window's exit s, ``key_averages`` s, and the device busy ms it reads; then
one call of chip_smoke.profile_device. Prints the card's name and power
limit, then a JSON line per profile.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_profile_cost: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from case_rg_tpu_torch.kernels import _build
    from case_rg_tpu_torch.runtime.inference import make_predict_fn

    print(cs.smi(), flush=True)
    _build.build_all()
    dev = torch.device("cuda")
    cfg, model = cs.serving_model(dev)
    predict = make_predict_fn(model, cfg, cs.T_ANS, device=dev)
    bt = cs.make_batch(np.random.RandomState(1))
    predict(bt)
    torch.cuda.synchronize()

    def timed(acts):
        t0 = time.perf_counter()
        with profile(activities=acts) as p:
            t1 = time.perf_counter()
            predict(bt)
            torch.cuda.synchronize()
            run_ms = (time.perf_counter() - t1) * 1e3
        t2 = time.perf_counter()
        busy = sum(float(getattr(e, "self_device_time_total", 0))
                   for e in p.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e3
        t3 = time.perf_counter()
        return {"total_s": t3 - t0, "run_ms": run_ms,
                "exit_s": t2 - t1 - run_ms / 1e3, "key_averages_s": t3 - t2,
                "busy_ms": busy}

    for _ in range(2):
        for name, acts in (("host+device", [ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]),
                           ("device", [ProfilerActivity.CUDA])):
            print(json.dumps({name: timed(acts)}), flush=True)
    t0 = time.perf_counter()
    r = cs.profile_device(predict, [bt])
    print(json.dumps({"profile_device": {
        "total_s": time.perf_counter() - t0,
        "busy_ms": r["device_busy_ms_per_batch"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
