"""Failure detection and rollback training loop (PyTorch).

Counterpart of ``reptext_tpu/sampling/elastic.py``:

- **Restore points**: copies of the trained state (the ControlNet's and the
  optimizer's ``state_dict``) on the host at step 0, every
  ``checkpoint_every`` steps and at the end; with ``checkpoint_dir`` each is
  also written with ``torch.save`` to ``<dir>/step_<n>.pt``.
- **Anomaly detection**: every step's loss is read back as a Python float
  (which waits for the device: the read doubles as the heartbeat); a
  non-finite loss, an exception or a watchdog timeout is a fault.
- **Recovery**: on a fault the state is restored from the last restore point
  and training replays from its step, up to ``max_retries`` faults per step.
  Batches are addressed by step and each step's generator is seeded from
  ``(seed, step)``, so a replay is exact; replayed steps record their losses
  again.
"""

from __future__ import annotations

import copy
import math
import os
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


class StepWatchdog:
    """Flags a step that exceeds ``timeout_s`` (a hung device)."""

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s
        self._deadline: Optional[float] = None
        self._lock = threading.Lock()
        self.expired = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def arm(self):
        with self._lock:
            self._deadline = time.monotonic() + self.timeout_s
        self.expired.clear()

    def disarm(self):
        with self._lock:
            self._deadline = None

    def _run(self):
        while not self._stop.is_set():
            with self._lock:
                d = self._deadline
            if d is not None and time.monotonic() > d:
                self.expired.set()
            time.sleep(min(self.timeout_s / 4, 1.0))

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one training step, seeded from ``(seed, step)``."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _to_host(state: Any) -> Any:
    """A deep copy of a (nested) state dict with every tensor on the CPU."""
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True)
    if isinstance(state, dict):
        return {k: _to_host(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_to_host(v) for v in state)
    return copy.deepcopy(state)


class ElasticTrainer:
    """Training loop with restore points and fault rollback.

    Args:
        train_step: ``(batch, generator) -> loss`` that updates the trained
            state in place (see ``train_controlnet.bind_frozen_base``).
        batch_fn: ``step -> batch``, step-indexed so a replay is exact.
        state: the trained state, by name: objects with ``state_dict`` and
            ``load_state_dict`` (the ControlNet and its optimizer).
        device: where the per-step generators live.
        checkpoint_dir: where ``torch.save`` writes the restore points;
            ``None`` keeps them in host memory only.
        checkpoint_every: steps between restore points.
        max_retries: faults tolerated per step before re-raising.
        step_timeout_s: watchdog limit per step (0 disables).
        on_event: ``(kind, info)`` callback for checkpoint, step, fault and
            rollback events.
    """

    def __init__(self, train_step: Callable, batch_fn: Callable[[int], Dict[str, Any]],
                 state: Dict[str, Any], device="cpu", checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 50, max_retries: int = 2, step_timeout_s: float = 0.0,
                 on_event: Optional[Callable[[str, dict], None]] = None):
        self.train_step = train_step
        self.batch_fn = batch_fn
        self.state = state
        self.device = torch.device(device)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.max_retries = max_retries
        self.on_event = on_event or (lambda kind, info: None)
        self._watchdog = StepWatchdog(step_timeout_s) if step_timeout_s > 0 else None
        self._restore: Optional[dict] = None  # last good {"step", "state"}
        self.faults: list = []
        self.losses: list = []
        self._fault_counts: Dict[int, int] = {}

    def _save(self, step: int):
        self._restore = {"step": step,
                         "state": {k: _to_host(v.state_dict()) for k, v in self.state.items()}}
        if self.checkpoint_dir:
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            torch.save(self._restore, os.path.join(self.checkpoint_dir, f"step_{step}.pt"))
        self.on_event("checkpoint", {"step": step})

    def _rollback(self) -> int:
        if self._restore is None:
            raise RuntimeError("fault before the first restore point; nothing to restore")
        for k, v in self.state.items():
            v.load_state_dict(self._restore["state"][k])
        self.on_event("rollback", {"to_step": self._restore["step"]})
        return self._restore["step"]

    def run(self, num_steps: int, seed: int = 0) -> list:
        """Run ``num_steps`` with fault recovery; returns the per-step losses."""
        step = 0
        self._save(step)
        try:
            while step < num_steps:
                if self._watchdog:
                    self._watchdog.arm()
                try:
                    loss = self.train_step(self.batch_fn(step),
                                           step_generator(seed, step, self.device))
                    loss_val = float(loss)  # heartbeat: waits for the device
                    if self._watchdog and self._watchdog.expired.is_set():
                        raise TimeoutError(f"step {step} exceeded {self._watchdog.timeout_s}s")
                    if not math.isfinite(loss_val):
                        raise FloatingPointError(f"non-finite loss {loss_val} at step {step}")
                except Exception as e:  # noqa: BLE001 - device faults, NaN, hangs
                    self.faults.append({"step": step, "error": f"{type(e).__name__}: {e}"})
                    self.on_event("fault", self.faults[-1])
                    # a deterministic fault (the same step failing after every
                    # rollback) must end the run, not loop
                    self._fault_counts[step] = self._fault_counts.get(step, 0) + 1
                    if self._fault_counts[step] > self.max_retries:
                        raise
                    step = self._rollback()
                    del self.losses[step:]  # replayed steps re-record their losses
                    continue
                finally:
                    if self._watchdog:
                        self._watchdog.disarm()
                self.losses.append(loss_val)
                step += 1
                self.on_event("step", {"step": step, "loss": loss_val})
                if step % self.checkpoint_every == 0 or step == num_steps:
                    self._save(step)
        finally:
            if self._watchdog:
                self._watchdog.close()
        return self.losses
