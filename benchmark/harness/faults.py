"""Faults planted in the program under test, to see the comparison catch
them: each is a context manager that patches one of the program's classes
for the time of a run.  The CPU tests and ``calibrate.py`` use them; the
benchmark's own runs never do.

* ``state_unchanged``: the optimizer's step changes nothing;
* ``half_batch``: half of each batch is left out (training: the loss is
  the mean over the other half; encode and refine: the other half's
  answers stand in for the half left out);
* ``half_batch_late``, ``state_unchanged_late`` (training): the same, in
  every epoch after the first only, as a fault that comes after a warm-up
  epoch would (a stale graph replay, a lazy layout switch);
* ``answer_altered``: one answer of each batch says something else where it
  is produced (the first image's embedding is the second's; the first
  image's first class mask is inverted).
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch


def _train_half_batch():
    from samcarriestheburden_torch.train.loop import UNetTrainer

    inner = UNetTrainer.forward_loss

    def forward_loss(self, x, y, w, w_total=None):
        w = w.clone()
        w[max(1, x.shape[0] // 2):] = 0
        return inner(self, x, y, w)

    return mock.patch.object(UNetTrainer, "forward_loss", forward_loss)


def _train_state_unchanged():
    return mock.patch.object(torch.optim.AdamW, "step", lambda self, closure=None: None)


def _train_late(fault):
    """``fault`` in every training epoch after epoch 0 (which runs clean)."""
    def make():
        from samcarriestheburden_torch.train.loop import UNetTrainer

        inner = UNetTrainer.train_epoch

        def train_epoch(self, x, y, epoch):
            if epoch == 0:
                return inner(self, x, y, epoch)
            with fault():
                return inner(self, x, y, epoch)

        return mock.patch.object(UNetTrainer, "train_epoch", train_epoch)
    return make


def _encoder_output(fn):
    from samcarriestheburden_torch.models.image_encoder import ImageEncoderViT

    inner = ImageEncoderViT.forward

    def forward(self, *a, **k):
        return fn(inner(self, *a, **k))

    return mock.patch.object(ImageEncoderViT, "forward", forward)


def _encode_half_batch():
    def fn(out):
        h = out.shape[0] // 2
        out = out.clone()
        out[h:] = out[:out.shape[0] - h]
        return out
    return _encoder_output(fn)


def _encode_answer_altered():
    def fn(out):
        out = out.clone()
        out[0] = out[1 % out.shape[0]] if out.shape[0] > 1 else -out[0]
        return out
    return _encoder_output(fn)


def _enhance_output(fn):
    from samcarriestheburden_torch.engine.refinement import SegEnhance

    inner = SegEnhance.enhance_batch

    def enhance_batch(self, segs, names):
        refined, dice = inner(self, segs, names)
        return fn(refined.clone()), dice

    return mock.patch.object(SegEnhance, "enhance_batch", enhance_batch)


def _refine_half_batch():
    def fn(r):
        h = r.shape[0] // 2
        r[h:] = r[:r.shape[0] - h]
        return r
    return _enhance_output(fn)


def _refine_answer_altered():
    def fn(r):
        r[0, 0] = ~r[0, 0]
        return r
    return _enhance_output(fn)


FAULTS = {
    "train": {"state_unchanged": _train_state_unchanged, "half_batch": _train_half_batch,
              "state_unchanged_late": _train_late(_train_state_unchanged),
              "half_batch_late": _train_late(_train_half_batch)},
    "precompute": {"half_batch": _encode_half_batch, "answer_altered": _encode_answer_altered},
    "refine": {"half_batch": _refine_half_batch, "answer_altered": _refine_answer_altered},
}


def planted(driver: str, name: str):
    """The context manager that plants fault ``name`` in the program that
    driver ``driver`` runs."""
    if name is None:
        return contextlib.nullcontext()
    return FAULTS[driver][name]()
