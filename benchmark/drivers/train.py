"""U-Net training: the program's ``train/loop.py:UNetTrainer`` in the
paper's pseudo-label setting (shuffled full epochs with drop_last, random
affine augmentation, pos-weighted BCE, AdamW with the per-epoch cosine
schedule) over a seeded split of X-ray-like images and their bone masks,
which lives on the card.

Set-up builds one trainer from the seeded weights and runs epoch 0 through
``train_epoch``, the window's own call; epoch 0 also warms every shape the
window runs.  The window is whole epochs: it starts after an epoch has
ended and ends with the first epoch to end after ``seconds``; its work is
the samples of those epochs.

Correctness: the first steps of two epochs are observed (:class:`Watch`)
and followed by the plain float32 U-Net (``reference/unet.py``) on the
same data: epoch 0 from the seeded weights and a fresh AdamW (the start),
and the window's last epoch from the program's parameters and AdamW state
at that epoch's start (the steps the window timed, with that epoch's
learning rate and step count).  Compared are the steps' losses, the first
gradient's norm and the parameters' change per leaf (the worst leaf), and
the share of the first gradient's signs that differ.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import synth
from harness.core import Check, Window, judge
from harness.models import full_fp32, port_unet_config, reference_unet, seeded
from reference import unet as ref_unet


@dataclass
class Observed:
    """One epoch's first steps as the program took them, by parameter name:
    the epoch, AdamW's step count and moments at its start (None: the fresh
    state of epoch 0), the parameters at its start and after the last
    observed step, each observed step's loss, and the first step's
    gradient as AdamW took it, worked out from its first moment before and
    after that step."""
    epoch: int = 0
    adam_steps: int = 0
    loss: List[float] = field(default_factory=list)
    grad: Optional[Dict[str, torch.Tensor]] = None
    params: Optional[Dict[str, torch.Tensor]] = None
    start: Optional[Dict[str, torch.Tensor]] = None
    exp_avg: Optional[Dict[str, torch.Tensor]] = None
    exp_avg_sq: Optional[Dict[str, torch.Tensor]] = None


@dataclass
class State:
    trainer: object
    x: np.ndarray
    y: np.ndarray
    cfg: object
    observed: Observed
    watch: Optional["Watch"] = None
    window_observed: Optional[Observed] = None
    epoch: int = 0
    launches: Dict[str, int] = field(default_factory=dict)
    readings: Dict[str, float] = field(default_factory=dict)


def train_data(ctx):
    """(images (N, 1, H, W) float32 in [0, 1], masks (N, C, H, W) uint8)."""
    c, t = ctx.config, ctx.traffic
    n, chunk = c["train_samples"], t["draw_chunk"]
    xs, ys = [], []
    for i in range(0, n, chunk):
        img, m = synth.xrays(ctx.subseed(f"data{i}"), min(chunk, n - i), c["grid_hw"],
                             ctx.device, with_masks=True)
        xs.append((img.float() / 255.0)[:, None].cpu())
        ys.append(m.cpu())
    return torch.cat(xs).numpy(), torch.cat(ys).numpy()


@torch.no_grad()
def _copy(dst: List[torch.Tensor], src: List[torch.Tensor]) -> None:
    torch._foreach_copy_(dst, src)


class Watch:
    """The first ``steps`` steps of each epoch, observed on the card with
    no read-back: :meth:`begin` copies the parameters and AdamW's moments
    into buffers beside them, hooks on the trainer's step keep each
    observed step's loss (on the card), the first moment after step 1 and
    the parameters after step ``steps``.  Each epoch overwrites the last
    one's, so after the window they are its last epoch's; :meth:`take`
    moves them to the host.  A few device copies an epoch, no
    synchronisation."""

    def __init__(self, trainer, steps: int):
        self.trainer, self.steps = trainer, steps
        self.opt = trainer.optimizer
        self.names, self.params = zip(*trainer.model.named_parameters())
        self.beta1 = self.opt.param_groups[0]["betas"][0]
        self.buf = {k: [torch.empty_like(p) for p in self.params]
                    for k in ("start", "m0", "v0", "m1", "end")}
        self.loss: List[torch.Tensor] = []
        self.n = 0
        self.fresh = True
        self.epoch = self.adam_steps = 0
        inner = trainer.step

        def step(*a, **k):
            loss, dice = inner(*a, **k)
            if len(self.loss) < self.steps:
                self.loss.append(loss)
            return loss, dice

        trainer.step = step
        self.handle = self.opt.register_step_post_hook(self._post)

    def _moments(self, key: str) -> List[torch.Tensor]:
        """AdamW's moments (zeros where a step left it no state)."""
        return [self.opt.state[p].get(key, torch.zeros_like(p)) for p in self.params]

    def _post(self, optimizer, args, kwargs):
        self.n += 1
        if self.n == 1:
            _copy(self.buf["m1"], self._moments("exp_avg"))
        if self.n == self.steps:
            _copy(self.buf["end"], list(self.params))

    def begin(self, epoch: int) -> None:
        """Mark the start of ``epoch`` (before the trainer's call)."""
        state = self.opt.state.get(self.params[0], {})
        self.fresh = "exp_avg" not in state
        self.epoch, self.n, self.loss = epoch, 0, []
        self.adam_steps = 0 if self.fresh else int(state["step"])
        _copy(self.buf["start"], list(self.params))
        if not self.fresh:
            _copy(self.buf["m0"], self._moments("exp_avg"))
            _copy(self.buf["v0"], self._moments("exp_avg_sq"))

    def take(self) -> Observed:
        """The observed epoch on the host (empty where it took fewer steps)."""
        host = {k: dict(zip(self.names, (t.to("cpu", copy=True) for t in v)))
                for k, v in self.buf.items()}
        if self.n < self.steps or len(self.loss) < self.steps:
            return Observed(epoch=self.epoch)
        m0 = None if self.fresh else host["m0"]
        grad = {k: ((m.double() - (0 if m0 is None else self.beta1 * m0[k].double()))
                    / (1 - self.beta1)).float() for k, m in host["m1"].items()}
        return Observed(epoch=self.epoch, adam_steps=self.adam_steps,
                        loss=[float(v) for v in self.loss], grad=grad, params=host["end"],
                        start=host["start"], exp_avg=m0,
                        exp_avg_sq=None if self.fresh else host["v0"])

    def remove(self) -> None:
        self.handle.remove()
        del self.trainer.step
        self.buf = {}


def setup(ctx) -> State:
    from samcarriestheburden_torch.config import TrainConfig
    from samcarriestheburden_torch.train.loop import UNetTrainer

    c, t = ctx.config, ctx.traffic
    x, y = train_data(ctx)
    _, sd = seeded(lambda: ref_unet.UNet(c), ctx.subseed("unet"), ctx.device)
    cfg = TrainConfig(seed=ctx.subseed("train"), lr=c["lr"], batch_size=c["batch_size"],
                      weight_decay=c["weight_decay"], epochs=c["epochs"],
                      data_aug=c["data_aug"], lr_scheduler=c["lr_scheduler"],
                      sample_mode=c["sample_mode"], compute_dtype=c["compute_dtype"])
    trainer = UNetTrainer(port_unet_config(c), cfg, init_params=sd, device=ctx.device)
    del sd
    state = State(trainer, x, y, cfg, Observed())
    state.watch = Watch(trainer, t["check_steps"])
    state.watch.begin(0)
    with ctx.spans("trainer.train_epoch"):
        trainer.train_epoch(x, y, 0)
    state.observed = state.watch.take()
    state.epoch = 1
    return state


def window(state: State, ctx, seconds: float) -> Window:
    from samcarriestheburden_torch.kernels import LAUNCHES

    before = dict(LAUNCHES)
    tr, watch = state.trainer, state.watch
    steps = len(state.x) // state.cfg.batch_size
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    t_start = t_end = time.perf_counter()
    ends = []
    while t_end - t_start < seconds:
        watch.begin(state.epoch)
        with ctx.spans("trainer.train_epoch"):
            tr.train_epoch(state.x, state.y, state.epoch)
        state.epoch += 1
        t_end = time.perf_counter()
        ends.append(t_end)
    epochs = len(ends)
    state.launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    samples = epochs * steps * state.cfg.batch_size
    return Window(work=samples, seconds=t_end - t_start, t_start=t_start, attempted=samples,
                  counts={"epochs": epochs, "steps": epochs * steps,
                          "epoch_s": np.diff([t_start] + ends).tolist()})


def release(state: State) -> None:
    """The window's last epoch to the host (outside the window and its
    trace), then the program's state freed."""
    state.window_observed = state.watch.take()
    state.watch.remove()
    state.trainer = state.watch = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keep) -> List[float]:
    """Each leaf's |‖prog‖ - ‖ref‖| over max(‖ref‖, the median leaf's)."""
    pn = {k: float(prog[k].double().norm()) for k in keep}
    rn = {k: float(ref[k].double().norm()) for k in keep}
    med = float(np.median(list(rn.values())))
    return [abs(pn[k] - rn[k]) / max(rn[k], med) for k in keep]


def reference_steps(ctx, state: State, obs: Observed) -> dict:
    """The plain U-Net's steps over ``obs``'s epoch: from the seeded
    weights and a fresh AdamW at epoch 0, else from the program's
    parameters and AdamW state at that epoch's start."""
    c = ctx.config
    unet = reference_unet(c, ctx.subseed("unet"), ctx.device).train()
    start = None
    if obs.exp_avg is not None:
        dev = ctx.device
        unet.load_state_dict({k: v.to(dev) for k, v in obs.start.items()})
        start = {"exp_avg": {k: v.to(dev) for k, v in obs.exp_avg.items()},
                 "exp_avg_sq": {k: v.to(dev) for k, v in obs.exp_avg_sq.items()},
                 "steps": obs.adam_steps}
    x = torch.from_numpy(state.x).to(ctx.device)
    y = torch.from_numpy(state.y).to(ctx.device)
    pw = torch.tensor(c["pos_class_weight"], device=ctx.device).reshape(-1, 1, 1)
    with full_fp32():
        return ref_unet.train_steps(
            unet, x, y, seed=state.cfg.seed, steps=ctx.traffic["check_steps"],
            batch=c["batch_size"], lr=c["lr"], epochs=c["epochs"], strength=c["data_aug"],
            weight_decay=c["weight_decay"], mean=c["img_mean"], std=c["img_std"],
            pos_weight=pw, epoch=obs.epoch, start=start)


def compare(ctx, obs: Observed, ref: dict, prefix: str = "") -> dict:
    """Readings of the observed steps against the reference's: each step's
    relative loss gap (the worst, and the first step's), the first
    gradient's and the parameters' change per leaf (the worst leaf, and the
    median leaf), and the share of the first gradient's elements whose sign
    differs from the reference's (AdamW's first update from a fresh state
    is their sign).  Leaves whose reference gradient is under a thousandth
    of the median leaf's move by round-off alone under Adam and are left
    out.  Nothing observed (the epoch took fewer steps): no readings."""
    steps = ctx.traffic["check_steps"]
    if len(obs.loss) < steps or obs.grad is None or obs.params is None:
        return {}
    loss = [abs(p - r) / abs(r) for p, r in zip(obs.loss, ref["loss"])]
    gnorm = {k: float(g.double().norm()) for k, g in ref["grad"].items()}
    med = float(np.median(list(gnorm.values())))
    keep = [k for k, g in gnorm.items() if g >= 1e-3 * med]
    grad = _leaf_gaps(obs.grad, ref["grad"], keep)
    flips = sum(int((torch.sign(obs.grad[k]) != torch.sign(ref["grad"][k].cpu())).sum())
                for k in keep) / sum(obs.grad[k].numel() for k in keep)
    moved_p = {k: obs.params[k] - obs.start[k] for k in keep}
    moved_r = {k: ref["params"][k].cpu() - obs.start[k] for k in keep}
    update = _leaf_gaps(moved_p, moved_r, keep)
    out = {"loss_gap": max(loss), "loss1_gap": loss[0], "grad_gap": max(grad),
           "grad_sign_flips": flips,
           "grad_median_gap": float(np.median(grad)), "update_gap": max(update),
           "update_median_gap": float(np.median(update)),
           "leaves_left_out": len(gnorm) - len(keep)}
    return {prefix + k: v for k, v in out.items()}


def check(state: State, ctx) -> List[Check]:
    """Epoch 0 from the seeded weights (the start), and the window's last
    epoch from the program's state at its start (the steps the window
    timed)."""
    readings = compare(ctx, state.observed, reference_steps(ctx, state, state.observed))
    win = state.window_observed
    if win is not None and win.loss:
        readings.update(compare(ctx, win, reference_steps(ctx, state, win), "window_"))
        readings["window_epoch"] = win.epoch
    state.readings = readings
    return judge(readings, ctx.traffic["limits"])
