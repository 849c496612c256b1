"""A run with the timed path broken underneath comes out not correct: the
harness's look for a chip is skipped (the CPU, tiny sizes) and the rest of
the run is driven as it stands. One test per fault each cell can have: a
training step that leaves its state unchanged, half of the batch left out
with the mean taken over the rest, an answer altered where it is produced.
The training faults are planted from the first step and again from the
window's first step on (after the set-up's steps), with the window's own
faults besides: validation views skipped, renewals skipped, a
validation's answer altered. No cell spans chips, so no exchange can be
left out."""

import pytest
import torch

from conftest import run_cell


def _noop_step(self, closure=None):
    return None


def _half_batch(original):
    def loss(id_module, fbatch, *a, **k):
        half = fbatch.c2w.shape[0] // 2
        return original(id_module, type(fbatch)(*(t[:half] for t in fbatch)), *a, **k)
    return loss


def _moved_pose(original):
    def solve(*a, **k):
        sol = original(*a, **k)
        c2w = sol.c2w.clone()
        c2w[0, 3] += 1e-2
        return sol._replace(c2w=c2w)
    return solve


def _one_score_off(original):
    def score(*a, **k):
        out = original(*a, **k)
        s = out.scores.clone()
        s[int(torch.argmax(s))] *= 1.01
        return out._replace(scores=s)
    return score


def _after(calls, faulty, original):
    """``faulty`` from the ``calls + 1``-th call on, ``original`` before."""
    seen = [0]

    def fn(*a, **k):
        seen[0] += 1
        return (faulty if seen[0] > calls else original)(*a, **k)
    return fn


def _fewer_views(original):
    def test(cam_infos, *a, **k):
        return original(cam_infos[:max(1, len(cam_infos) // 2)], *a, **k)
    return test


def _loss_off(original):
    def loss(*a, **k):
        value, target = original(*a, **k)
        return value * 1.01, target
    return loss


SETUP_STEPS = 3  # conftest's check_steps: the window's steps follow these


@pytest.mark.parametrize("cell", ("dinov2_s14.train", "superpoint.train"))
@pytest.mark.parametrize("fault", ("state_unchanged", "half_batch", "state_unchanged_late",
                                   "half_batch_late", "views_skipped", "renewals_skipped",
                                   "validation_altered"))
def test_training_faults(tiny_root, capsys, monkeypatch, cell, fault):
    from sixdgs_torch.pose import evaluate, trainer

    late = SETUP_STEPS if fault.endswith("_late") else 0
    if fault.startswith("state_unchanged"):
        monkeypatch.setattr(trainer.Adafactor, "step",
                            _after(late, _noop_step, trainer.Adafactor.step))
    elif fault.startswith("half_batch"):
        original = trainer.batch_loss_cached
        monkeypatch.setattr(trainer, "batch_loss_cached",
                            _after(late, _half_batch(original), original))
    elif fault == "views_skipped":  # the set-up's validation asks for one view a split
        original = evaluate.test_pose_estimation
        monkeypatch.setattr(evaluate, "test_pose_estimation", _after(
            2, _fewer_views(original), original))
    elif fault == "renewals_skipped":
        original = trainer.PoseTrainer._regen_rays
        monkeypatch.setattr(trainer.PoseTrainer, "_regen_rays",
                            _after(2, lambda self: None, original))
    else:
        original = evaluate.distance_score_loss
        monkeypatch.setattr(evaluate, "distance_score_loss", _loss_off(original))
    rc, line = run_cell(tiny_root, cell, capsys=capsys)
    assert rc == 0
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", ("dinov2_s14.pose", "superpoint.pose"))
@pytest.mark.parametrize("fault", ("pose_moved", "score_altered"))
def test_answer_altered(tiny_root, capsys, monkeypatch, cell, fault):
    from sixdgs_torch.pose import evaluate

    if fault == "pose_moved":
        monkeypatch.setattr(evaluate, "solve_pose", _moved_pose(evaluate.solve_pose))
    else:
        monkeypatch.setattr(evaluate, "score_image", _one_score_off(evaluate.score_image))
    rc, line = run_cell(tiny_root, cell, capsys=capsys)
    assert rc == 0
    assert line["correct"] is False, line["checks"]
