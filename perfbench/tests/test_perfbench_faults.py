"""The comparison that decides `correct`, at a size a test run holds: a sound
run passes; the control (the reference in fp8 in the program's place) fails;
and a run with the timed path broken underneath comes out not correct, once
for each fault its cell can have (a step that returns its state unchanged,
half of the batch left out, an answer altered where it is produced, and
for training an EMA that never moves or that copies the parameters).  The
harness's look for a card is skipped: everything runs on the CPU."""

from __future__ import annotations

import pytest
import torch

from perfbench.tests import tiny

KINDS = list(tiny.WORKLOADS)


@pytest.mark.parametrize("kind", KINDS)
def test_sound_run_is_correct_and_control_is_not(kind):
    run = tiny.tiny_run(kind)
    result = tiny.execute(run)
    assert result["correct"], result["checks"]
    driver = tiny.harness.load_part("drivers", run.workload["driver"])
    control = driver.readings(run, control=True)
    limits = run.workload["limits"]
    assert any(not control[n] <= limits[n] for n in limits), control


def _ddim_unchanged(monkeypatch):
    from jointimagegeneration_torch.models import slice_ldm

    monkeypatch.setattr(slice_ldm, "ddim_step", lambda params, noise, x, e, index, temperature=1.0: (x, x))


def _half_batch(monkeypatch):
    from jointimagegeneration_torch.models.slice_ldm import SliceLDM

    apply = SliceLDM.apply_model

    def half(self, x, t, cond=None, context=None, y=None):
        h = x.shape[0] // 2
        out = apply(self, x[:h], t[:h], cond=None if cond is None else cond[:h], context=context, y=y)
        return torch.cat([out, out])

    monkeypatch.setattr(SliceLDM, "apply_model", half)


def _slice_altered(monkeypatch):
    from jointimagegeneration_torch.models import slice_ldm

    minmax = slice_ldm._minmax_slice

    def altered(s):
        out = minmax(s).clone()
        out[0, 0, 0, 0] = 1.0 - out[0, 0, 0, 0]
        return out

    monkeypatch.setattr(slice_ldm, "_minmax_slice", altered)


def _mask_unchanged(monkeypatch):
    from jointimagegeneration_torch.models.mask_sampler import MaskSampler

    monkeypatch.setattr(MaskSampler, "_step", lambda self, noise, xt, *args, **kw: xt)


def _label_altered(monkeypatch):
    from jointimagegeneration_torch.models import mask_sampler

    draw = mask_sampler.sample_one_hot

    def altered(noise, probs):
        out = draw(noise, probs).clone()
        out[0, 0, 0, 0] = out[0, 0, 0, 0].roll(1)
        return out

    monkeypatch.setattr(mask_sampler, "sample_one_hot", altered)


def _train_unchanged(monkeypatch):
    from jointimagegeneration_torch.train.state import EMATrainState

    monkeypatch.setattr(EMATrainState, "apply_gradients", lambda self, grads: True)


def _loss_altered(monkeypatch):
    from jointimagegeneration_torch.train import steps

    loss_fn = steps.gaussian_diffusion_loss

    def altered(*args, **kw):
        loss, metrics = loss_fn(*args, **kw)
        return loss * 1.01, dict(metrics, loss=loss * 1.01)

    monkeypatch.setattr(steps, "gaussian_diffusion_loss", altered)


def _ema_state(monkeypatch, **kw):
    """The train state built with the EMA settings `kw` in place of the
    cell's: the parameters train as they should, only the EMA is wrong."""
    from jointimagegeneration_torch.train.state import EMATrainState

    init = EMATrainState.__init__
    monkeypatch.setattr(EMATrainState, "__init__", lambda self, optimizer, **given: init(self, optimizer,
                                                                                         **dict(given, **kw)))


def _ema_frozen(monkeypatch):
    _ema_state(monkeypatch, ema_decay=1.0, ema_warmup=False)


def _ema_decay_zero(monkeypatch):
    _ema_state(monkeypatch, ema_decay=0.0)


FAULTS = [
    ("slices", _ddim_unchanged), ("slices", _half_batch), ("slices", _slice_altered),
    ("mask", _mask_unchanged), ("mask", _label_altered),
    ("train_ldm", _train_unchanged), ("train_ldm", _loss_altered), ("train_ldm", _ema_frozen),
    ("train_ldm", _ema_decay_zero),
]


@pytest.mark.parametrize("kind,fault", FAULTS, ids=[f"{k}-{f.__name__[1:]}" for k, f in FAULTS])
def test_broken_path_is_not_correct(kind, fault, monkeypatch):
    fault(monkeypatch)
    result = tiny.execute(tiny.tiny_run(kind))
    assert not result["correct"], result["checks"]
