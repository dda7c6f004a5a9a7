#!/usr/bin/env python3
"""Replay chaos flash crowds in one process and count what each replay leaves behind.

    python replay_soak.py [--replays N] [--judge] [--package torchmetrics_tpu_torch]

Runs N flash-crowd replays (``flash_crowd_config(seed=0, tenants=12)``) on the CPU in one
process and prints one JSON line a replay: its seconds, updates per second, and the
process-wide state after it: the value log's series, the cost ledger's entries, the
tenant, migration, checkpoint, lease, fence and thread-tenant registries of
``obs/scope.py``, the capture streams of ``core/jit.py`` and the live threads. With
``--judge`` each replay runs both arms (the controller off, then on) and prints the
failed SLO rows of the flash-crowd spec. ``--package torchmetrics_tpu`` counts the
same in the JAX package (its replay takes no ``device``).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import threading
import time


def state(pkg: str) -> dict:
    scope = importlib.import_module(f"{pkg}.obs.scope")
    values = importlib.import_module(f"{pkg}.obs.values")
    cost = importlib.import_module(f"{pkg}.obs.cost")
    jit = importlib.import_module(f"{pkg}.core.jit")
    return {"value_series": len(values.get_log()), "ledger_entries": len(cost.get_ledger()),
            "tenant_rows": len(scope._REGISTRY._rows), "migrations": len(scope._MIGRATIONS),
            "checkpoints": len(scope._CHECKPOINTS), "leases": len(scope._LEASES), "fences": len(scope._FENCES),
            "thread_tenants": len(scope._THREAD_TENANTS), "capture_streams": len(getattr(jit, "_CAPTURE_STREAMS", {})),
            "live_threads": threading.active_count()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python replay_soak.py", description=__doc__.splitlines()[0])
    parser.add_argument("--replays", type=int, default=5)
    parser.add_argument("--judge", action="store_true")
    parser.add_argument("--package", default="torchmetrics_tpu_torch",
                        choices=("torchmetrics_tpu_torch", "torchmetrics_tpu"))
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    pkg = args.package
    if pkg == "torchmetrics_tpu":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import torch

    torch.set_num_threads(2)
    chaos = importlib.import_module(f"{pkg}.chaos")
    replay = importlib.import_module(f"{pkg}.chaos.replay")
    extra = {"device": "cpu"} if pkg == "torchmetrics_tpu_torch" else {}
    schedule = chaos.generate(chaos.flash_crowd_config(seed=0, tenants=12))
    print(json.dumps({"replay": None, **state(pkg)}), flush=True)
    arms = ({"flash_crowd": True, "placement_enabled": False}, {"flash_crowd": True}) if args.judge \
        else ({"flash_crowd": True},)
    for n in range(args.replays):
        t0 = time.perf_counter()
        results = [replay.replay(schedule, replay.ReplayConfig(**extra, **arm)) for arm in arms]
        line = {"replay": n, "seconds": time.perf_counter() - t0,
                "updates_per_s": results[-1]["updates_per_second"]}
        if args.judge:
            result, control = results[1], results[0]
            result["placement"]["control_arm_updates_per_second"] = control["updates_per_second"]
            result["placement"]["control_arm"] = {
                key: control[key] for key in ("batches_fed", "wall_seconds", "sleep_seconds", "updates_per_second")}
            result["placement"]["control_arm"]["compile_seconds"] = control["cost"]["compile_seconds"]
            line["slos_failed"] = chaos.judge(result, chaos.flash_crowd_slo_spec(), prefix="chaos_fc")["failed"]
        print(json.dumps({**line, **state(pkg)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
