#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch and CUDA port on this
machine's card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell's entry in BENCHMARK.json
names its configuration and its traffic; the traffic file names the
driver. With `--trace 0` the result's metrics are the cell's end-to-end
metrics, with `--trace 1` its per-layer metrics, each read by
`portbench/metrics/<name>.py`. The last line of standard output is the
result, one JSON object; the last lines of standard error are the
numbers that decided `correct`, each beside its limit.

Exits with 2 and prints no result where the card is missing or has too
few devices, and with 3 where the run loaded JAX or the JAX package.
"""
from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment() -> None:
    """Keep every compiler cache at a fixed path inside the checkout, and
    keep libraries from loading JAX."""
    cache = ROOT / "portbench" / "_work" / "cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def resolve(root: Path, name: str) -> dict:
    """The cell `name` of `root`'s BENCHMARK.json with everything it
    names, found by name: its configuration's file and its traffic file
    (`portbench/traffic/<traffic>.json`, which names the driver)."""
    from portbench.common import load_json
    bench = load_json(root / "BENCHMARK.json")
    cells = [c for c in bench["workloads"] if c["name"] == name]
    if not cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[0]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return {"bench": bench, "cell": cell,
            "config": load_json(root / entry["file"]),
            "traffic": load_json(root / "portbench" / "traffic"
                                 / f"{cell['traffic']}.json")}


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The cell's metrics of the run's kind, in BENCHMARK.json's order."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def reader(root: Path, name: str):
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def power_limit() -> str:
    try:
        done = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return done.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def measure(root: Path, name: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", start: float = START):
    """Run the cell `name` of `root` on `device` -> (the result's
    object, the driver's `Run`)."""
    import torch

    from portbench.common import Context
    found = resolve(root, name)
    cell, traffic = found["cell"], found["traffic"]
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    ctx = Context(cell=name, config=found["config"], traffic=traffic,
                  seed=seed, seconds=seconds, trace=trace, device=device)
    run = driver.run(ctx)
    run.values["setup_s"] = run.setup_end - start
    metrics = {}
    for entry in metrics_of(found["bench"], name, trace):
        value = reader(root, entry["name"])(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    on_card = device.startswith("cuda")
    info = {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": int(cell["chips"]),
            "memory_peak_bytes": run.memory_peak_bytes}
    if on_card:
        info["power"] = power_limit()
    result = {"correct": run.correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": info}
    if trace and run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in run.checks}
    return result, run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _environment()
    sys.path.insert(0, str(ROOT))
    from portbench.common import block_forbidden, forbidden_modules
    block_forbidden()
    chips = int(resolve(ROOT, args.workload)["cell"]["chips"])

    import torch
    # one process with few threads: the host's cores are shared
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); torch "
              f"sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, run = measure(ROOT, args.workload, args.seed, args.seconds,
                          bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    print(f"window: {run.values.get('steps')} steps in {run.window_s!r} s; "
          f"the reference took {run.values.get('reference_s')!r} s",
          file=sys.stderr)
    if run.trace is not None:
        from portbench.trace import kernel_shares
        for name, share in kernel_shares(run).items():
            print(f"roofline {name} {share!r} %", file=sys.stderr)
    for c in run.checks:
        note = f" ({c.note})" if c.note else ""
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}{note}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
