"""The port's ElasticTrainer: restore points, NaN rollback, retry cap,
torch.save checkpoints, the watchdog, and exact replays (the twins of
tests/test_elastic.py, on a quadratic w * x = y with SGD)."""

import time

import numpy as np
import pytest
import torch

from reptext_tpu_torch.sampling.elastic import ElasticTrainer, step_generator


class Quad(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(()))


def _setup():
    model = Quad()
    opt = torch.optim.SGD(model.parameters(), lr=0.1)

    def quad_step(batch, generator):
        opt.zero_grad()
        loss = ((model.w * batch["x"] - batch["y"]) ** 2).mean()
        loss.backward()
        opt.step()
        return loss.detach()

    return model, {"model": model, "optimizer": opt}, quad_step


def clean_batch(step):
    return {"x": torch.ones(4), "y": torch.full((4,), 3.0)}


def nan_batch():
    return {"x": torch.full((4,), float("nan")), "y": torch.full((4,), 3.0)}


def test_clean_run_checkpoints_and_converges():
    events = []
    model, state, step = _setup()
    tr = ElasticTrainer(step, clean_batch, state, checkpoint_every=5,
                        on_event=lambda k, i: events.append((k, i)))
    losses = tr.run(10)
    assert len(losses) == 10 and losses[-1] < losses[0] and not tr.faults
    assert [i["step"] for k, i in events if k == "checkpoint"] == [0, 5, 10]
    assert [i["step"] for k, i in events if k == "step"] == list(range(1, 11))
    assert model.w.item() == pytest.approx(3.0, abs=0.5)


def test_nan_fault_rolls_back_and_recovers():
    seen = {"done": False}

    def batch_fn(step):
        if step == 7 and not seen["done"]:
            seen["done"] = True   # a transient fault: one NaN batch
            return nan_batch()
        return clean_batch(step)

    events = []
    model, state, step = _setup()
    tr = ElasticTrainer(step, batch_fn, state, checkpoint_every=5,
                        on_event=lambda k, i: events.append((k, i)))
    tr.run(10)
    assert len(tr.faults) == 1 and tr.faults[0]["step"] == 7
    assert ("rollback", {"to_step": 5}) in events
    assert len(tr.losses) == 10                      # replayed, not double-counted
    assert np.isfinite(model.w.item()) and model.w.item() == pytest.approx(3.0, abs=0.5)


def test_deterministic_fault_exhausts_retries():
    def batch_fn(step):
        return nan_batch() if step == 3 else clean_batch(step)   # a permanent fault

    _, state, step = _setup()
    tr = ElasticTrainer(step, batch_fn, state, checkpoint_every=2, max_retries=2)
    with pytest.raises(FloatingPointError):
        tr.run(10)
    assert len(tr.faults) == 3   # the first + 2 retries


def test_restore_points_are_written_with_torch_save(tmp_path):
    model, state, step = _setup()
    tr = ElasticTrainer(step, clean_batch, state, checkpoint_dir=str(tmp_path), checkpoint_every=3)
    tr.run(3)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_0.pt", "step_3.pt"]
    saved = torch.load(tmp_path / "step_3.pt")
    assert saved["step"] == 3 and set(saved["state"]) == {"model", "optimizer"}
    assert torch.equal(saved["state"]["model"]["w"], model.w.detach())


def test_watchdog_flags_hung_step():
    _, state, step = _setup()

    def slow_step(batch, generator):
        time.sleep(0.6)
        return step(batch, generator)

    tr = ElasticTrainer(slow_step, clean_batch, state, checkpoint_every=5, max_retries=0,
                        step_timeout_s=0.2)
    with pytest.raises(TimeoutError):
        tr.run(3)
    assert tr.faults and "exceeded" in tr.faults[0]["error"]


def test_replay_restores_the_state_and_redraws_the_same_numbers():
    """A rollback restores the parameter and the optimizer state, and the
    replayed steps draw exactly what they drew the first time."""
    draws, seen = [], {"done": False}
    model, state, step = _setup()
    opt = state["optimizer"]
    opt.param_groups[0]["momentum"] = 0.9      # optimizer state that must roll back

    def recording_step(batch, generator):
        draws.append(torch.rand((), generator=generator).item())
        return step(batch, generator)

    def batch_fn(i):
        if i == 4 and not seen["done"]:
            seen["done"] = True
            return nan_batch()
        return clean_batch(i)

    tr = ElasticTrainer(recording_step, batch_fn, state, checkpoint_every=2)
    tr.run(6, seed=11)
    ref_model, ref_state, ref_step = _setup()
    ref_state["optimizer"].param_groups[0]["momentum"] = 0.9
    ref = ElasticTrainer(ref_step, clean_batch, ref_state, checkpoint_every=2)
    ref.run(6, seed=11)
    assert tr.losses == ref.losses
    assert model.w.item() == ref_model.w.item()
    # steps 0-3, the faulting step 4, then the replay of 4 (restored at 4) and 5
    want = [torch.rand((), generator=step_generator(11, i, "cpu")).item()
            for i in (0, 1, 2, 3, 4, 4, 5)]
    assert draws == want
