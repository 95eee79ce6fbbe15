"""Training hooks: profiling, NaN guard, throughput + metric logging,
checkpoints (port of `tensoralloy_tpu/train/hooks.py`).

Hooks implement `after_step(step, state, metrics)` and are passed to
`Trainer.fit(callback=...)` via `compose_hooks`.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger("tensoralloy_tpu_torch")


class Hook:
    def after_step(self, step: int, state, metrics: Dict):
        raise NotImplementedError

    def end(self):
        pass


class _Boundary:
    """Interval firing that tolerates sparse callbacks: with fused
    scan_steps=k the trainer only invokes hooks at steps k-1, 2k-1, ...
    so `step % every == 0` may NEVER be true — fire whenever an
    `every_steps` boundary has been crossed since the last callback
    (same logic as CheckpointHook)."""

    def __init__(self, every_steps: int):
        self.every = max(int(every_steps), 1)
        self._boundary: Optional[int] = None

    def crossed(self, step: int) -> bool:
        if self._boundary is None:
            self._boundary = step // self.every
            return False
        b = (step + 1) // self.every
        if b > self._boundary:
            self._boundary = b
            return True
        return False


class ProfilerHook(Hook):
    """Captures a `torch.profiler` trace (host and CUDA activity) of
    `trace_steps` steps every `every_steps` steps into
    `{logdir}/trace-{step}.json` (Chrome trace format; viewable in
    Perfetto)."""

    def __init__(self, logdir: str, every_steps: int = 1000,
                 trace_steps: int = 3):
        self.logdir = logdir
        self._bound = _Boundary(every_steps)
        self.trace_steps = trace_steps
        self._tracing_until: Optional[int] = None
        self._profiler = None
        self._started_at = 0
        os.makedirs(logdir, exist_ok=True)

    def _stop(self):
        self._profiler.stop()
        self._profiler.export_chrome_trace(
            os.path.join(self.logdir, f"trace-{self._started_at}.json"))
        self._profiler = None
        self._tracing_until = None

    def after_step(self, step, state, metrics):
        if self._tracing_until is None and self._bound.crossed(step):
            import torch
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=activities)
            self._profiler.start()
            self._started_at = step
            self._tracing_until = step + self.trace_steps
        elif self._tracing_until is not None and \
                step >= self._tracing_until:
            self._stop()

    def end(self):
        if self._tracing_until is not None:
            self._stop()


class NanTensorHook(Hook):
    """Aborts training when the loss becomes NaN/Inf."""

    def __init__(self, fail_on_nan: bool = True, key: str = "loss/total",
                 every_steps: int = 50):
        self.fail_on_nan = fail_on_nan
        self.key = key
        # float(metrics) forces a host-device sync; checking every
        # step would serialize host batch prep with device compute
        self._bound = _Boundary(every_steps)

    def after_step(self, step, state, metrics):
        if not self._bound.crossed(step):
            return
        value = metrics.get(self.key)
        if value is None:
            return
        v = float(value)
        if not np.isfinite(v):
            msg = f"{self.key} is {v} at step {step}"
            if self.fail_on_nan:
                raise FloatingPointError(msg)
            logger.error(msg)


class ExamplesPerSecondHook(Hook):
    """Average + current structures/s."""

    def __init__(self, batch_size: int, every_steps: int = 100):
        self.batch_size = batch_size
        self._bound = _Boundary(every_steps)
        self._t0 = time.time()
        self._t_last = self._t0
        self._step_last = 0

    def after_step(self, step, state, metrics):
        if step > 0 and self._bound.crossed(step):
            now = time.time()
            avg = step * self.batch_size / max(now - self._t0, 1e-9)
            cur = ((step - self._step_last) * self.batch_size /
                   max(now - self._t_last, 1e-9))
            logger.info("examples/sec: avg %.1f, current %.1f "
                        "(step %d)", avg, cur, step)
            self._t_last = now
            self._step_last = step


class LoggingTensorHook(Hook):
    """Periodic metric logging to the python logger + a JSONL file."""

    def __init__(self, every_steps: int = 100,
                 jsonl_path: Optional[str] = None):
        self._bound = _Boundary(every_steps)
        self.jsonl_path = jsonl_path
        self._fh = open(jsonl_path, "a") if jsonl_path else None

    def after_step(self, step, state, metrics):
        if not self._bound.crossed(step):
            return
        row = {k: float(v) for k, v in metrics.items()}
        row["step"] = step
        logger.info(" ".join(f"{k}={v:.6f}" for k, v in row.items()
                             if k != "step"))
        if self._fh:
            self._fh.write(json.dumps(row) + "\n")
            self._fh.flush()

    def end(self):
        if self._fh:
            self._fh.close()


class CheckpointHook(Hook):
    """Periodic checkpoints with keep-N rotation.

    Writes `{model_dir}/ckpt-{step}.npz`; use `latest_checkpoint` to
    find the newest for crash auto-resume.
    """

    def __init__(self, trainer, model_dir: str, every_steps: int = 1000,
                 keep: int = 5):
        self.trainer = trainer
        self.model_dir = model_dir
        self.every_steps = max(int(every_steps), 1)
        self.keep = max(int(keep), 1)
        self._saved_boundary: Optional[int] = None
        os.makedirs(model_dir, exist_ok=True)

    def after_step(self, step, state, metrics):
        if self._saved_boundary is None:
            # align to the resume point so we don't instantly re-save
            self._saved_boundary = step // self.every_steps
        b = (step + 1) // self.every_steps
        if b > self._saved_boundary:
            self._saved_boundary = b
            self._save(step + 1, state)

    def _save(self, step: int, state):
        path = os.path.join(self.model_dir, f"ckpt-{step}.npz")
        self.trainer.save_checkpoint(path, state)
        self._rotate()

    def _rotate(self):
        entries = _list_checkpoints(self.model_dir)
        for _, path in entries[:-self.keep]:
            for p in (path, path + ".json"):
                if os.path.exists(p):
                    os.remove(p)


class BestCheckpointHook:
    """Keeps `{model_dir}/ckpt-best.npz`: the EMA checkpoint whose eval
    `metric` is the lowest seen: a run that trades a channel away late
    in training, when only the newest N periodic checkpoints survive
    rotation, would otherwise lose its best model.

    Fired from `Trainer.fit(eval_callback=...)` after every eval, so
    "best" is judged on the same EMA test metrics as `history.json`.
    Resume-safe: `best.json` records the incumbent (step, value, full
    eval row), so a crash-resumed run never overwrites a better earlier
    model with a worse later one.
    """

    def __init__(self, trainer, model_dir: str,
                 metric: str = "energy/mae/atom"):
        self.trainer = trainer
        self.model_dir = model_dir
        self.metric = metric
        self.best: Optional[float] = None
        os.makedirs(model_dir, exist_ok=True)
        meta = os.path.join(model_dir, "best.json")
        if os.path.exists(meta):
            try:
                with open(meta) as fh:
                    rec = json.load(fh)
                if rec.get("metric") == metric:
                    self.best = float(rec["value"])
            except (ValueError, KeyError):
                pass   # unreadable incumbent: first new eval wins

    def after_eval(self, step: int, state, ev: Dict):
        v = ev.get(self.metric)
        if v is None or not np.isfinite(v):
            return
        if self.best is not None and float(v) >= self.best:
            return
        self.best = float(v)
        self.trainer.save_checkpoint(
            os.path.join(self.model_dir, "ckpt-best.npz"), state)
        with open(os.path.join(self.model_dir, "best.json"), "w") as fh:
            json.dump({"step": int(step), "metric": self.metric,
                       "value": float(v),
                       "eval": {k: float(x) for k, x in ev.items()}},
                      fh, indent=2)


def _list_checkpoints(model_dir: str):
    """-> [(step, path)] ascending by step."""
    import glob
    import re
    out = []
    for p in glob.glob(os.path.join(model_dir, "ckpt-*.npz")):
        m = re.search(r"ckpt-(\d+)\.npz$", p)
        if m:
            out.append((int(m.group(1)), p))
    return sorted(out)


def latest_checkpoint(model_dir: str) -> Optional[str]:
    """Path of the newest periodic checkpoint, or None."""
    entries = _list_checkpoints(model_dir)
    return entries[-1][1] if entries else None


def compose_hooks(hooks: List[Hook]):
    """-> a Trainer.fit callback driving all hooks."""
    def callback(step, state, metrics):
        for hook in hooks:
            hook.after_step(step, state, metrics)
    return callback


def set_logging_configs(logfile: str = "logfile",
                        level: int = logging.INFO):
    """File+console logging setup."""
    logging.basicConfig(
        level=level,
        format="%(asctime)s [%(levelname)s] %(message)s",
        handlers=[logging.FileHandler(logfile),
                  logging.StreamHandler()])
