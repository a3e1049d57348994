"""U-Net training loops (JAX ``train/loop.py``, reference
unet_training/{forward_func,training,training_on_pseudo_labels}.py).

Reference semantics preserved: bootstrap sampling with replacement
(training.py:41-42), per-class pos-weighted BCE-with-logits
(forward_func.py:44-46), random affine augmentation under ``no_grad``,
AdamW + per-epoch cosine annealing to lr/100 (training.py:55-56), per-epoch
train/val BCE + NaN-aware Dice scalars and per-class histograms.

The split lives on the device (images fp32, labels uint8) and every step
gathers its batch there from indices sampled on the host, as JAX's
``_device_data`` does.  The sampling order is JAX's exactly
(``np.random.default_rng((seed, epoch))``); the augmentation's θ come from a
CPU ``torch.Generator`` keyed on ``seed * 100003 + epoch``, one draw per
step, so the card and the CPU warp with the same θ and a resumed run replays
its epoch.  Library calls only (cuDNN convolutions, ``torch.optim.AdamW``):
the JAX training step reaches no Pallas kernel.

Data-parallel (a ``mesh`` from ``parallel/mesh.py``, one card per process):
each global batch is padded to a multiple of the ranks (weight 0 on the pad
rows, JAX's ``pad_to_multiple``) and every rank takes its contiguous rows.
Every rank draws the global batch's θ and takes its rows, so its augmented
rows are the single-process run's.  Each rank's gradient is that of its
share ``sum(per_sample · w) / sum(w_global)`` of JAX's loss over the global
batch, and the step all-reduces their SUM: the single-process gradient of the
padded batch (not DDP's mean of local means, which weighs a padded rank's
rows wrong).  ``data_placement="sharded"`` keeps each rank's contiguous
block of the padded split on its card and sends each of a step's rows once,
from its owner to the rank that trains it, by an all-to-all (JAX: the split
on ``P('data')``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from samcarriestheburden_torch.config import (GRAZ_IMG_MEAN, GRAZ_IMG_STD, POS_CLASS_WEIGHT,
                                              TrainConfig, UNetConfig)
from samcarriestheburden_torch.device import resolve_device
from samcarriestheburden_torch.models.unet import UNet, build_unet
from samcarriestheburden_torch.ops.dice import multilabel_dice
from samcarriestheburden_torch.parallel import distributed as pdist
from samcarriestheburden_torch.parallel import mesh as pmesh
from samcarriestheburden_torch.parallel.mesh import Mesh
from samcarriestheburden_torch.train.augment import random_theta, warp_affine

COMPUTE_DTYPES = ("float32", "bfloat16")
DATA_PLACEMENTS = ("replicated", "sharded")


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    pos_weight: torch.Tensor) -> torch.Tensor:
    """torch BCEWithLogitsLoss(pos_weight=w): the mean of
    w·y·softplus(−x) + (1−y)·(x + softplus(−x))."""
    sp = F.softplus(-logits)
    return (pos_weight * targets * sp + (1 - targets) * (logits + sp)).mean()


def cosine_lr(epoch: float, base_lr: float, epochs: int, eta_min: float) -> float:
    """torch CosineAnnealingLR stepped per epoch, in closed form (training.py:56)."""
    return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * epoch / epochs)) / 2


def sample_order(cfg: TrainConfig, n: int, epoch: int) -> np.ndarray:
    """The epoch's sample indices, keyed on (seed, epoch) so that a resumed
    run replays the same schedule: ``data_sample_per_epoch`` draws with
    replacement (bootstrap), or a shuffled full epoch with drop_last."""
    rng = np.random.default_rng((cfg.seed, epoch))
    if cfg.sample_mode == "bootstrap":
        return rng.integers(0, n, cfg.data_sample_per_epoch)
    order = rng.permutation(n)
    return order[: (len(order) // cfg.batch_size) * cfg.batch_size]


def augment_generator(cfg: TrainConfig, epoch: int) -> torch.Generator:
    """The CPU generator of an epoch's θ: one (B, 2, 3) draw per step."""
    return torch.Generator().manual_seed(cfg.seed * 100003 + epoch)


class UNetTrainer:
    """One U-Net, its AdamW and the epoch count, on ``device`` (None: the
    card; raises without one)."""

    def __init__(self, unet_cfg: UNetConfig, train_cfg: TrainConfig,
                 init_params=None, mesh=None, device=None):
        """``mesh``: a ``parallel.mesh.Mesh`` over the group's ranks (None:
        one process); its device is the trainer's, and rank 0's initial
        parameters are broadcast to every rank."""
        if mesh is not None and (not isinstance(mesh, Mesh) or mesh.index is None):
            raise TypeError("mesh must be a parallel.mesh.Mesh over this process group")
        n_mesh = 1 if mesh is None else mesh.size
        if train_cfg.num_devices > 1 and train_cfg.num_devices != n_mesh:
            raise ValueError(f"num_devices={train_cfg.num_devices} needs a mesh of as many "
                             "ranks, one card each (torchrun --nproc-per-node "
                             f"{train_cfg.num_devices}); this trainer has {n_mesh}")
        if train_cfg.data_placement not in DATA_PLACEMENTS:
            raise ValueError(f"data_placement must be one of {DATA_PLACEMENTS}")
        if train_cfg.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}")
        self.unet_cfg = unet_cfg
        self.cfg = train_cfg
        self.mesh = mesh if n_mesh > 1 else None
        self.device = resolve_device(device if mesh is None else mesh.device)
        if isinstance(init_params, torch.nn.Module):
            init_params = init_params.state_dict()
        if init_params is None:
            self.model = build_unet(unet_cfg, device=self.device, seed=train_cfg.seed)
        else:
            self.model = build_unet(unet_cfg, device=self.device, state_dict=init_params)
        if self.mesh is not None:
            with torch.no_grad():
                for t, src in zip(self.model.state_dict().values(),
                                  pmesh.replicate(self.mesh,
                                                  list(self.model.state_dict().values()))):
                    t.copy_(src)
        self.model.train()
        self.optimizer = torch.optim.AdamW(self.model.parameters(), lr=train_cfg.lr,
                                           betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=train_cfg.weight_decay)
        self.epoch = 0
        self._eta_min = train_cfg.lr / 100
        nclass = unet_cfg.n_classes
        w = np.asarray(POS_CLASS_WEIGHT[:nclass], np.float32) \
            if nclass <= len(POS_CLASS_WEIGHT) else np.ones(nclass, np.float32)
        self.pos_weight = torch.from_numpy(w).reshape(-1, 1, 1).to(self.device)
        self._data_cache: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    @property
    def sharded(self) -> bool:
        """The split is partitioned over the ranks (``data_placement="sharded"``
        on a mesh); one process holds the whole split either way."""
        return self.mesh is not None and self.cfg.data_placement == "sharded"

    # ------------------------------------------------------------------

    @property
    def aug_method(self) -> str:
        """The 4-tap 'gather' warp (the faster one on the H100 and on the
        CPU), unless forced through ``cfg.aug_method``."""
        return self.cfg.aug_method or "gather"

    @property
    def epoch_scan(self) -> bool:
        return self.cfg.epoch_scan if self.cfg.epoch_scan is not None \
            else self.device.type == "cuda"

    def augment(self, x: torch.Tensor, y: torch.Tensor, theta: torch.Tensor):
        """Normalise and (with ``data_aug`` > 0) warp by ``theta``, outside
        autograd, like the reference's no_grad block (forward_func.py:34-42)."""
        with torch.no_grad():
            x = (x - GRAZ_IMG_MEAN) / GRAZ_IMG_STD
            if self.cfg.data_aug > 0:
                x, y = warp_affine(x, y, theta.to(x.device), method=self.aug_method)
        return x, y

    def forward_loss(self, x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                     w_total: Optional[torch.Tensor] = None):
        """(loss, logits): ``sum(per_sample · w) / w_total`` (default
        ``w.sum()``).  ``w`` (B,) marks real (1) and pad (0) rows, as JAX's
        does; with all ones the loss is torch's all-element mean.  On a mesh
        ``w_total`` is the global batch's, so the loss is this rank's share.
        bf16: the forward in bf16 on bf16 copies of the fp32 parameters
        (gradients flow back to them in fp32), the logits and the loss in
        fp32."""
        if self.cfg.compute_dtype == "bfloat16":
            p16 = {n: p.to(torch.bfloat16) for n, p in self.model.named_parameters()}
            logits = functional_call(self.model, p16, (x.to(torch.bfloat16),)).float()
        else:
            logits = self.model(x)
        sp = F.softplus(-logits)
        per_elem = self.pos_weight * y * sp + (1 - y) * (logits + sp)
        per_sample = per_elem.mean(dim=(1, 2, 3))
        return (per_sample * w).sum() / (w.sum() if w_total is None else w_total), logits

    def step(self, x: torch.Tensor, y: torch.Tensor, lr: float, w=None, w_total=None):
        """One optimizer step on an augmented batch: (loss, dice (B, C)),
        both still on the device; Dice of the pre-update logits against the
        augmented labels.  On a mesh ``x``, ``y``, ``w`` are this rank's rows
        and ``w_total`` the global batch's weight: the gradients and the loss
        are all-reduced (SUM) before the update, and the loss returned is the
        global batch's."""
        if w is None:
            w = torch.ones(x.shape[0], device=x.device)
        with torch.enable_grad():
            if w_total is None:
                loss, logits = self.forward_loss(x, y, w)
            else:
                loss, logits = self.forward_loss(x, y, w, w_total)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        loss = loss.detach()
        if self.mesh is not None:
            loss = self.reduce_gradients(loss)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        with torch.no_grad():
            dice = multilabel_dice(torch.sigmoid(logits) > 0.5, y > 0.5)
        return loss, dice

    def reduce_gradients(self, loss: torch.Tensor) -> torch.Tensor:
        """All-reduce (SUM) every parameter's gradient and the loss over the
        mesh, as one flat buffer; returns the summed loss."""
        params = [p for p in self.model.parameters() if p.grad is not None]
        flat = torch.cat([p.grad.reshape(-1) for p in params] + [loss.reshape(1)])
        flat = flat.to(pdist.comm_device())
        torch.distributed.all_reduce(flat, group=self.mesh.group)
        flat = flat.to(self.device)
        offset = 0
        for p in params:
            n = p.grad.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
            offset += n
        return flat[offset]

    def train_step(self, xd: torch.Tensor, yd: torch.Tensor, idx: torch.Tensor,
                   theta: torch.Tensor, lr: float):
        """Gather the batch ``idx`` on the device, augment, step (one process)."""
        x, y = self.augment(xd[idx], yd[idx].float(), theta)
        return self.step(x, y, lr)

    # ------------------------------------------------------------------

    def device_data(self, x: np.ndarray, y: np.ndarray):
        """The split on the device, uploaded once per array pair (images fp32,
        labels uint8: 4x smaller); the last two pairs (train, val) are kept.
        Sharded: this rank's contiguous block of the split padded to a
        multiple of the ranks."""
        key = (id(x), id(y), x.shape, y.shape)
        if key not in self._data_cache:
            xh = np.ascontiguousarray(x, np.float32)
            yh = np.asarray(y).astype(np.uint8)
            if self.sharded:
                xh, _ = pmesh.pad_to_multiple(xh, self.mesh.size)
                yh, _ = pmesh.pad_to_multiple(yh, self.mesh.size)
                xd, yd = pmesh.shard_batch(self.mesh, (torch.from_numpy(xh),
                                                       torch.from_numpy(yh)))
            else:
                xd = torch.from_numpy(xh).to(self.device)
                yd = torch.from_numpy(yh).to(self.device)
            if len(self._data_cache) >= 2:
                self._data_cache.pop(next(iter(self._data_cache)))
            self._data_cache[key] = (xd, yd)
        return self._data_cache[key]

    def local_batch(self, idx: np.ndarray):
        """This rank's part of the global batch ``idx``: (its row slice of the
        padded batch, its weights (rows,), the global weight, the count of
        real rows).  JAX pads with index 0 and weight 0."""
        idx_p, n_valid = pmesh.pad_to_multiple(np.asarray(idx, np.int64), self.mesh.size)
        rows = len(idx_p) // self.mesh.size
        mine = slice(self.mesh.index * rows, (self.mesh.index + 1) * rows)
        w = (np.arange(len(idx_p)) < n_valid).astype(np.float32)
        return idx_p, mine, torch.from_numpy(w[mine]).to(self.device), \
            torch.tensor(float(n_valid), device=self.device), n_valid

    def gather_rows(self, xd: torch.Tensor, yd: torch.Tensor, idx_p: np.ndarray, mine: slice):
        """This rank's rows ``idx_p[mine]`` of the split.  Sharded: one
        all-to-all per array sends each row once, from the rank whose block
        holds it to the rank whose slice of the batch trains it, exact."""
        if not self.sharded:
            idx = torch.from_numpy(idx_p[mine]).to(self.device)
            return xd[idx], yd[idx]
        n, me, block = self.mesh.size, self.mesh.index, xd.shape[0]
        owner = idx_p // block
        dest = np.arange(len(idx_p)) // (len(idx_p) // n)
        send = np.flatnonzero(owner == me)        # batch order, so grouped by destination
        pos = np.arange(mine.start, mine.stop)
        recv = pos[np.argsort(owner[pos], kind="stable")]    # grouped by owner, as sent
        send_counts = np.bincount(dest[send], minlength=n).tolist()
        recv_counts = np.bincount(owner[pos], minlength=n).tolist()
        local = torch.from_numpy(idx_p[send] - me * block).to(self.device)
        order = torch.from_numpy(np.argsort(recv - mine.start)).to(self.device)
        out = []
        for t in (xd, yd):
            buf = t[local].to(pdist.comm_device()).contiguous()
            got = torch.empty((len(pos), *t.shape[1:]), dtype=t.dtype, device=buf.device)
            torch.distributed.all_to_all_single(got, buf, recv_counts, send_counts,
                                                group=self.mesh.group)
            out.append(got.to(self.device)[order])
        return out

    def global_rows(self, t: torch.Tensor, n_valid: int) -> torch.Tensor:
        """The ranks' rows of a padded global batch, in order, pad rows dropped."""
        return pdist.all_gather_rows(t.contiguous())[:n_valid]

    def lr_at(self, epoch: int) -> float:
        if not self.cfg.lr_scheduler:
            return self.cfg.lr
        return cosine_lr(epoch, self.cfg.lr, self.cfg.epochs, self._eta_min)

    def batch_thetas(self, gen: torch.Generator, batches) -> List[torch.Tensor]:
        """One (B, 2, 3) θ draw per global batch, in step order (every rank
        draws them all, so each rank's rows get the single-process θ)."""
        return [random_theta(gen, len(b), self.cfg.data_aug) for b in batches]

    def train_epoch(self, x: np.ndarray, y: np.ndarray, epoch: int) -> Tuple[float, np.ndarray]:
        """One epoch (``sample_order``): returns the mean step loss and the
        (samples, C) Dice rows.  ``epoch_scan`` augments the whole epoch
        before its steps and reads the losses back once; the per-step path
        reads each step's; both give the same numbers."""
        cfg = self.cfg
        order = sample_order(cfg, len(x), epoch)
        lr = self.lr_at(epoch)
        xd, yd = self.device_data(x, y)
        gen = augment_generator(cfg, epoch)
        batches = [order[i:i + cfg.batch_size] for i in range(0, len(order), cfg.batch_size)]
        thetas = self.batch_thetas(gen, batches)
        if self.mesh is not None:
            return self._train_epoch_mesh(xd, yd, batches, thetas, lr, epoch)
        idx_all = torch.from_numpy(np.concatenate(batches).astype(np.int64)).to(self.device)
        idxs = torch.split(idx_all, [len(b) for b in batches])
        if self.epoch_scan:
            theta_all = torch.cat(thetas).to(self.device)
            thetas_d = torch.split(theta_all, [len(b) for b in batches])
            augmented = []
            for idx, theta in zip(idxs, thetas_d):
                xa, ya = self.augment(xd[idx], yd[idx].float(), theta)
                augmented.append((xa, ya.to(torch.uint8)))   # integer labels: exact
            out = [self.step(xa, ya.float(), lr) for xa, ya in augmented]
            losses = torch.stack([loss for loss, _ in out]).cpu().tolist()
            dice_rows = [dice.cpu().numpy() for _, dice in out]
        else:
            losses, dice_rows = [], []
            for idx, theta in zip(idxs, thetas):
                loss, dice = self.train_step(xd, yd, idx, theta, lr)
                losses.append(float(loss))
                dice_rows.append(dice.cpu().numpy())
        self.epoch = epoch + 1
        return float(np.mean(losses)), np.concatenate(dice_rows)

    def _train_epoch_mesh(self, xd, yd, batches, thetas, lr, epoch):
        """:meth:`train_epoch` on a mesh: each step on this rank's rows of the
        padded global batch (θ: the global draw's rows, identity on the pad
        rows), the loss and the Dice rows of the whole batch on every rank."""
        losses, dice_rows = [], []
        for b, theta in zip(batches, thetas):
            idx_p, mine, w, w_total, n_valid = self.local_batch(b)
            theta_p = torch.cat([theta, torch.eye(2, 3)[None].expand(
                len(idx_p) - len(b), 2, 3)])
            xb, yb = self.gather_rows(xd, yd, idx_p, mine)
            xa, ya = self.augment(xb, yb.float(), theta_p[mine])
            loss, dice = self.step(xa, ya, lr, w, w_total)
            losses.append(float(loss))
            dice_rows.append(self.global_rows(dice, n_valid).cpu().numpy())
        self.epoch = epoch + 1
        return float(np.mean(losses)), np.concatenate(dice_rows)

    @torch.no_grad()
    def evaluate(self, x: np.ndarray, y: np.ndarray) -> Tuple[float, np.ndarray]:
        """Mean BCE over the ``infer_batch_size`` batches, and the Dice rows;
        on a mesh every rank evaluates its rows of each batch and gets the
        whole batch's numbers."""
        xd, yd = self.device_data(x, y)
        bs = self.cfg.infer_batch_size
        losses, dices = [], []
        if self.mesh is not None:
            for i in range(0, len(x), bs):
                idx_p, mine, w, w_total, n_valid = self.local_batch(np.arange(i, min(i + bs,
                                                                                   len(x))))
                xb, yb = self.gather_rows(xd, yd, idx_p, mine)
                xb = (xb - GRAZ_IMG_MEAN) / GRAZ_IMG_STD
                yb = yb.float()
                loss, logits = self.forward_loss(xb, yb, w, w_total)
                loss = loss.reshape(1).to(pdist.comm_device())
                torch.distributed.all_reduce(loss, group=self.mesh.group)
                losses.append(float(loss))
                dice = multilabel_dice(torch.sigmoid(logits) > 0.5, yb > 0.5)
                dices.append(self.global_rows(dice, n_valid).cpu().numpy())
            return float(np.mean(losses)), np.concatenate(dices)
        for i in range(0, len(x), bs):
            xb = (xd[i:i + bs] - GRAZ_IMG_MEAN) / GRAZ_IMG_STD
            yb = yd[i:i + bs].float()
            loss, logits = self.forward_loss(xb, yb, torch.ones(xb.shape[0], device=xb.device))
            losses.append(float(loss))
            dices.append(multilabel_dice(torch.sigmoid(logits) > 0.5, yb > 0.5).cpu().numpy())
        return float(np.mean(losses)), np.concatenate(dices)

    @property
    def current_lr(self) -> float:
        return self.lr_at(self.epoch)


def train_unet(train_data, val_data, unet_cfg: UNetConfig, train_cfg: TrainConfig,
               logger=None, bone_labels=None, init_params=None, mesh=None,
               progress: bool = False, checkpoint_dir=None,
               checkpoint_every: int = 50, timer=None, device=None) -> Tuple[UNet, List[Dict]]:
    """The whole training run (reference training.py:64-72).

    train_data/val_data: (images (N,1,H,W) f32 in [0,1], masks (N,C,H,W)).
    ``checkpoint_dir`` enables a checkpoint every ``checkpoint_every`` epochs
    and at the end, and resumes from its latest (absent in the reference,
    SURVEY §5).  ``timer`` (a ``profiling.PhaseTimer``) accounts the
    ``train_epoch`` and ``evaluate`` phases.  ``device`` None: the card (on
    a ``mesh``: the mesh's).  On a mesh the checkpoints and the logger write
    on rank 0 only, and the other ranks wait for each checkpoint at a
    barrier; every rank resumes from the same file and returns the same
    model.  Returns (the trained U-Net, history).
    """
    from samcarriestheburden_torch.train import checkpoint as ckpt

    if timer is None:
        from samcarriestheburden_torch.profiling import PhaseTimer

        timer = PhaseTimer(sync=False)  # accounting nobody reads
    trainer = UNetTrainer(unet_cfg, train_cfg, init_params=init_params, mesh=mesh,
                          device=device)
    start_epoch = 0
    if checkpoint_dir is not None:
        latest = ckpt.latest_checkpoint(checkpoint_dir)
        if latest is not None:
            start_epoch = ckpt.restore_train_state(latest, trainer.model, trainer.optimizer)
            trainer.epoch = start_epoch
    x_tr, y_tr = train_data
    x_va, y_va = val_data
    history = []
    epochs = range(start_epoch, train_cfg.epochs)
    if progress:
        from tqdm import tqdm
        epochs = tqdm(epochs, desc="training", total=train_cfg.epochs, initial=start_epoch)
    for epoch in epochs:
        with timer.phase("train_epoch"):
            tr_loss, tr_dice = trainer.train_epoch(x_tr, y_tr, epoch)
        with timer.phase("evaluate"):
            va_loss, va_dice = trainer.evaluate(x_va, y_va)
        rec = {"epoch": epoch, "train_bce": tr_loss,
               "train_dice": float(np.nanmean(tr_dice)),
               "val_bce": va_loss, "val_dice": float(np.nanmean(va_dice)),
               "lr": trainer.current_lr}
        history.append(rec)
        if logger is not None and pdist.process_index() == 0:
            logger.report_scalar("BCE", "train", tr_loss, epoch)
            logger.report_scalar("Dice", "train", rec["train_dice"], epoch)
            logger.report_scalar("BCE", "val", va_loss, epoch)
            logger.report_scalar("Dice", "val", rec["val_dice"], epoch)
            if train_cfg.lr_scheduler:
                logger.report_scalar("Learning rate", "lr", rec["lr"], epoch)
            logger.report_histogram("Dice", "val", epoch,
                                    np.nanmean(va_dice, axis=0),
                                    xlabels=bone_labels, xaxis="class",
                                    yaxis="dice")
        if checkpoint_dir is not None and (
                (epoch + 1) % checkpoint_every == 0
                or epoch + 1 == train_cfg.epochs):
            if pdist.process_index() == 0:
                ckpt.save_train_state(checkpoint_dir, epoch + 1, trainer.model,
                                      trainer.optimizer)
            pdist.barrier()
    return trainer.model, history
