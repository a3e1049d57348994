"""The jobs that ``parallel/worker.py`` runs in each rank, and their seeded
data: the test harness of the multi-process path, kept apart from the
modules a user's run imports.  The two-process tests and ``chip_smoke.py``
read its specs and helpers; ``worker.py``'s docstring lists the jobs.

It holds a ``UNetTrainer`` subclass with the step's hooks (the planted
faults, a single-process reference from the same state, the float64
setting, ``precision_probe``), the seeded X-rays, maps and U-Net, and the
``dryrun``, ``train``, ``precompute``, ``nccl`` and ``cli`` jobs.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from samcarriestheburden_torch.parallel import distributed as pdist
from samcarriestheburden_torch.parallel import mesh as pmesh

#: the ``train`` job's spec and its defaults
TRAIN_SPEC = dict(base=4, n_last=4, classes=17, hw=[32, 24], n=8, batches=[4], samples=8,
                  data_aug=0.0, dtype="float32", placements=["replicated", "sharded"],
                  faults=[], reference=False, record=False, seed=0, tf32=False,
                  time_steps=0, float64=False, probe=False)
#: the ``precompute`` job's spec and its defaults (vit_t on the CPU)
PRECOMPUTE_SPEC = dict(model="vit_t", n=4, hw=[96, 64], batches=[1, 2], quantize=[None],
                       sweep=8, sweep_hw=[48, 32], img_batch=4, timed=0, timed_batch=8,
                       dtype="float32")
#: the planted faults of the data-parallel step (``chip_smoke.py`` phase 4o
#: must catch each): rank 1 keeps its own gradient though it joins the
#: all-reduce; DDP's mean of local means (the pad rows weighed as real); θ
#: drawn per rank instead of sliced from the global draw
PLANTED_FAULTS = ("skip_allreduce", "ddp_mean", "theta_per_rank")


def result(**kw) -> None:
    print("RESULT " + json.dumps(kw), flush=True)


def digest(model: torch.nn.Module) -> str:
    """The parameters' bits: equal digests on two ranks mean equal weights."""
    h = hashlib.sha256()
    for t in model.state_dict().values():
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return (torch.linalg.norm(a.double() - b.double())
            / torch.linalg.norm(b.double()).clamp_min(1e-300)).item()


def training_data(spec):
    """Seeded images in [0, 1] and sparse binary masks (JAX's two-process
    worker's data), the same on every rank."""
    rng = np.random.default_rng(spec["seed"])
    x = rng.random((spec["n"], 1, *spec["hw"])).astype(np.float32)
    y = (rng.random((spec["n"], spec["classes"], *spec["hw"])) > 0.7).astype(np.float32)
    return x, y


def trainer_class():
    """``UNetTrainer`` with the step's hooks: a planted fault, and each
    step's reference (a single-process trainer on this rank's device, from
    the same parameters, on the global batch it samples, augments and pads
    itself: JAX's loss over the padded batch, weight 0 on the pad rows) and
    record (the real rows)."""
    from samcarriestheburden_torch.train.augment import random_theta
    from samcarriestheburden_torch.train.loop import (UNetTrainer, augment_generator,
                                                      sample_order)

    class Trainer(UNetTrainer):
        fault = None
        probe = False             # precision_probe on each referenced step
        reference = None          # a single-process UNetTrainer on this rank's device
        record = None             # a list: each step's state, kept by rank 0
        steps = None              # each step's readings

        def train_epoch(self, x, y, epoch):
            cfg = self.cfg
            order = sample_order(cfg, len(x), epoch)
            self._batches = [order[i:i + cfg.batch_size]
                             for i in range(0, len(order), cfg.batch_size)]
            self._thetas = UNetTrainer.batch_thetas(self, augment_generator(cfg, epoch),
                                                    self._batches)
            self._data, self._step_i = (x, y), 0
            return super().train_epoch(x, y, epoch)

        def forward_loss(self, x, y, w, w_total=None):
            """The trainer's loss, on inputs in the model's precision (double
            where the harness runs the step in float64)."""
            dtype = next(self.model.parameters()).dtype
            return super().forward_loss(x.to(dtype), y.to(dtype), w, w_total)

        def batch_thetas(self, gen, batches):
            if self.fault != "theta_per_rank":
                return super().batch_thetas(gen, batches)
            out = []
            for b in batches:
                rows = -(-len(b) // self.mesh.size)
                out.append(torch.cat([random_theta(gen, rows, self.cfg.data_aug)]
                                     * self.mesh.size)[:len(b)])
            return out

        def reduce_gradients(self, loss):
            skip = self.fault == "skip_allreduce" and self.mesh.index == 1
            own = [p.grad.clone() for p in self.model.parameters()] if skip else None
            total = super().reduce_gradients(loss)
            if skip:
                for p, g in zip(self.model.parameters(), own):
                    p.grad.copy_(g)
            if self.reference is not None:
                self._reduced = [p.grad.clone() for p in self.model.parameters()]
            return total

        def precision_probe(self, state, xr, yr, wr, n_valid, grads) -> dict:
            """What fp32 rounding alone moves in one process's gradient, from
            ``state`` on this step's batch: on the first step the worst and
            the median tensor's relative L2 against the same gradient in
            float64; on a padded step the same against the gradient of the
            real rows alone (another batch size, other cuDNN algorithms)."""
            ref, names = self.reference, [n for n, _ in self.model.named_parameters()]
            own = next(ref.model.parameters()).dtype

            def grad_of(x, y, w, dtype):
                ref.model.load_state_dict(state)
                ref.model.to(dtype)
                ref.pos_weight = ref.pos_weight.to(dtype)
                with torch.enable_grad():
                    loss, _ = ref.forward_loss(x, y, w)
                    ref.optimizer.zero_grad(set_to_none=True)
                    loss.backward()
                out = [p.grad.clone() for p in ref.model.parameters()]
                ref.model.to(own)
                ref.pos_weight = ref.pos_weight.to(own)
                return out

            def spread(a, b):
                errs = sorted((rel_l2(x, y), n) for x, y, n in zip(a, b, names))
                return [errs[-1][0], errs[len(errs) // 2][0]]
            out = {}
            if self._step_i == 0:
                out["fp32_vs_fp64"] = spread(grads, grad_of(xr, yr, wr, torch.float64))
            if n_valid < xr.shape[0]:
                out["padded_vs_real_rows"] = spread(
                    grads, grad_of(xr[:n_valid], yr[:n_valid], wr[:n_valid], torch.float32))
            return out

        def reference_batch(self):
            """The single-process trainer's augmented global batch of this
            step, padded as the ranks pad it (index 0, identity θ, weight 0):
            (x, y, w) padded, and the count of real rows."""
            ref = self.reference
            xd, yd = ref.device_data(*self._data)
            b, theta = self._batches[self._step_i], self._thetas[self._step_i]
            idx_p, n_valid = pmesh.pad_to_multiple(np.asarray(b, np.int64), self.mesh.size)
            theta = torch.cat([theta, torch.eye(2, 3)[None].expand(len(idx_p) - len(b), 2, 3)])
            idx = torch.from_numpy(idx_p).to(ref.device)
            xr, yr = ref.augment(xd[idx], yd[idx].float(), theta)
            w = (torch.arange(len(idx_p), device=ref.device) < n_valid).float()
            return xr, yr, w, n_valid

        def step(self, x, y, lr, w=None, w_total=None):
            if self.mesh is None or w is None:
                return super().step(x, y, lr, w, w_total)
            keep = self.reference is not None
            before = {k: v.clone() for k, v in self.model.state_dict().items()} \
                if keep else None
            opt_before = None
            if self.record is not None and self.mesh.index == 0:
                opt_before = {n: {k: v.clone().cpu() for k, v in self.optimizer.state[p].items()}
                              for n, p in self.model.named_parameters()
                              if p in self.optimizer.state}
            if self.fault == "ddp_mean":
                loss, dice = super().step(x, y, lr, torch.ones_like(w),
                                          torch.tensor(float(x.shape[0] * self.mesh.size),
                                                       device=w.device))
            else:
                loss, dice = super().step(x, y, lr, w, w_total)
            reading = {"loss": float(loss), "lr": lr}
            if keep:
                ref = self.reference
                xr, yr, wr, n_valid = self.reference_batch()
                ref.model.load_state_dict(before)
                with torch.enable_grad():
                    ref_loss, _ = ref.forward_loss(xr, yr, wr)
                    ref.optimizer.zero_grad(set_to_none=True)
                    ref_loss.backward()
                grads = [p.grad.clone() for p in ref.model.parameters()]
                if self.probe:
                    reading.update(self.precision_probe(before, xr, yr, wr, n_valid, grads))
                reading["ref_loss"] = float(ref_loss)
                reading["loss_rel"] = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
                names = [n for n, _ in self.model.named_parameters()]
                reading["grad_rel"], reading["grad_worst"] = max(
                    (rel_l2(a, b), n) for a, b, n in zip(self._reduced, grads, names))
                if self.record is not None and self.mesh.index == 0:
                    self.record.append(dict(
                        params={k: v.cpu() for k, v in before.items()},
                        grads={n: g.cpu() for n, g in zip(names, self._reduced)},
                        after={k: v.detach().cpu().clone()
                               for k, v in self.model.state_dict().items()},
                        opt=opt_before, x=xr[:n_valid].cpu(), y=yr[:n_valid].cpu(),
                        loss=float(loss), lr=lr))
            self.steps.append(reading)
            self._step_i += 1
            return loss, dice

    return Trainer


def run_train(spec, mesh, out):
    """The ``train`` job (module docstring); ``spec`` may be a list of specs,
    run in turn."""
    for one in spec if isinstance(spec, list) else [spec]:
        train_runs({**TRAIN_SPEC, **one}, mesh, out)


def train_runs(spec, mesh, out):
    """One ``train`` spec: each run with the card's precision flags set as
    the spec says (fp32: deterministic cuDNN), restored after."""
    back = torch.backends
    flags = (back.cudnn.allow_tf32, back.cuda.matmul.allow_tf32, back.cudnn.deterministic)
    back.cudnn.allow_tf32 = back.cuda.matmul.allow_tf32 = spec["tf32"]
    back.cudnn.deterministic = spec["dtype"] == "float32"
    try:
        _train_runs(spec, mesh, out)
    finally:
        back.cudnn.allow_tf32, back.cuda.matmul.allow_tf32, back.cudnn.deterministic = flags
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()


def _train_runs(spec, mesh, out):
    from samcarriestheburden_torch.config import TrainConfig, UNetConfig

    x, y = training_data(spec)
    ucfg = UNetConfig(n_channels=1, n_classes=spec["classes"], base_channels=spec["base"],
                      n_last_channel=spec["n_last"])
    Trainer = trainer_class()
    runs = [(b, p, None) for b in spec["batches"] for p in spec["placements"]] \
        + [(spec["batches"][0], "replicated", f) for f in spec["faults"]]
    for batch, placement, fault in runs:
        cfg = TrainConfig(epochs=2, batch_size=batch,
                          data_sample_per_epoch=spec["samples"], data_aug=spec["data_aug"],
                          data_placement=placement, epoch_scan=False,
                          compute_dtype=spec["dtype"])
        trainer = Trainer(ucfg, cfg, mesh=mesh)
        trainer.fault, trainer.steps, trainer.probe = fault, [], spec["probe"]
        if (spec["reference"] or spec["record"]) and mesh.index == 0:
            trainer.reference = reference_trainer(Trainer, ucfg, cfg, mesh)
        if spec["float64"]:
            for t in (trainer, trainer.reference):
                if t is not None:
                    t.model.double()
                    t.pos_weight = t.pos_weight.double()
        if spec["record"]:
            trainer.record = []
        loss, dice = trainer.train_epoch(x, y, epoch=0)
        res = dict(rank=mesh.index, batch=batch, placement=placement, fault=fault,
                   float64=spec["float64"], hw=spec["hw"], epoch_loss=loss,
                   steps=trainer.steps, dice=np.nan_to_num(dice, nan=-1).tolist(),
                   digest=digest(trainer.model))
        if fault is None:
            va_loss, va_dice = trainer.evaluate(x, y)
            res.update(val_loss=va_loss, val_dice=np.nan_to_num(va_dice, nan=-1).tolist())
        if spec["time_steps"] and fault is None:
            res["ms_per_step"] = time_steps(trainer, x, y, spec)
        if trainer.record is not None and mesh.index == 0:
            torch.save(trainer.record, Path(out) / f"steps_{placement}_b{batch}.pt")
        result(job="train", **res)
        del trainer


def reference_trainer(Trainer, ucfg, cfg, mesh):
    """A single-process trainer on this rank's device, replicated placement,
    for the step-by-step reference."""
    from dataclasses import replace

    return Trainer(ucfg, replace(cfg, data_placement="replicated"), device=mesh.device)


def time_steps(trainer, x, y, spec) -> float:
    """ms per data-parallel step over ``time_steps`` steps of one epoch, all
    ranks between two barriers, after one warm-up epoch of as many steps."""
    from dataclasses import replace

    sync = torch.cuda.synchronize if trainer.device.type == "cuda" else (lambda: None)
    trainer.cfg = replace(trainer.cfg,
                          data_sample_per_epoch=trainer.cfg.batch_size * spec["time_steps"])
    trainer.reference = trainer.record = None
    trainer.train_epoch(x, y, epoch=1)
    pdist.barrier()
    sync()
    t0 = time.perf_counter()
    trainer.train_epoch(x, y, epoch=1)
    sync()
    pdist.barrier()
    return (time.perf_counter() - t0) * 1e3 / spec["time_steps"]


def seeded_xrays(n: int, hw, seed: int = 31):
    """``n`` seeded grayscale X-rays (HW uint8) by stem."""
    rng = np.random.default_rng(seed)
    gray = rng.integers(0, 256, (n, *hw), dtype=np.uint8)
    return {f"xray{i:02d}": g for i, g in enumerate(gray)}


def sweep_inputs(spec, xrays):
    """The sweep's stems, each with a seeded image on the U-Net grid and the
    X-ray whose embedding it reads (stem i: X-ray i mod n)."""
    rng = np.random.default_rng(32)
    names = list(xrays)
    stems = [f"map{i:02d}" for i in range(spec["sweep"])]
    grid = {s: rng.integers(0, 256, spec["sweep_hw"], dtype=np.uint8) for s in stems}
    source = {s: names[i % len(names)] for i, s in enumerate(stems)}
    return stems, grid, source


def seeded_unet(device, classes: int = 17, base: int = 64):
    """The sweep's U-Net: seeded, its output layer scaled so that a class
    covers a few percent of the pixels (``chip_smoke.py`` phase 4k's)."""
    from samcarriestheburden_torch.config import UNetConfig
    from samcarriestheburden_torch.models.unet import build_unet

    unet = build_unet(UNetConfig(n_classes=classes, base_channels=base), device=device, seed=0)
    with torch.no_grad():
        unet.outc.conv.weight.mul_(3)
        unet.outc.conv.bias.fill_(-3)
    return unet


def sam_model(name: str, device):
    from samcarriestheburden_torch.config import sam_vit_h_config, sam_vit_t_config
    from samcarriestheburden_torch.models.sam import build_sam

    cfg = {"vit_h": sam_vit_h_config, "vit_t": sam_vit_t_config}[name]()
    return build_sam(cfg, device=device, seed=0)


@contextlib.contextmanager
def profiled_busy(device):
    """Yields a dict that gets ``busy_ms``: the CUDA kernels' summed device
    time over the block, by ``torch.profiler`` (None where it saw none)."""
    got = {}
    if device.type != "cuda":
        yield got
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield got
        torch.cuda.synchronize()
    busy = sum(e.device_time_total for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None
               and "cuda" in str(e.device_type).lower()) / 1e3
    got["busy_ms"] = busy or None


def run_precompute(spec, mesh, out):
    """The ``precompute`` job (module docstring): the rank's shard encoded
    at each batch size and mode, counted; the timed runs; the sweep."""
    from samcarriestheburden_torch import kernels
    from samcarriestheburden_torch.cli.save_refined_segmentations import refine_images
    from samcarriestheburden_torch.data.h5io import MemoryEmbeddings, MemoryMasks
    from samcarriestheburden_torch.engine.decoder_head import SamMaskDecoderHead
    from samcarriestheburden_torch.engine.embeddings import encode_images, make_serving_encoder
    from samcarriestheburden_torch.engine.refinement import SamSegRefiner, SegEnhance

    spec = {**PRECOMPUTE_SPEC, **spec}
    dev = mesh.device
    cuda = dev.type == "cuda"
    dtype = getattr(torch, spec["dtype"])
    model = sam_model(spec["model"], dev)
    xrays = seeded_xrays(spec["n"], spec["hw"])
    mine = pdist.process_shard(list(xrays))
    read = xrays.__getitem__
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    stores = {}
    for quantize in spec["quantize"]:
        encode, packed = make_serving_encoder(model, dtype, quantize=quantize)
        for bs in spec["batches"]:
            store = MemoryEmbeddings(model.img_size)
            encode_images(encode, packed, mine[:1], read, store, img_size=model.img_size,
                          device=dev, batch_size=bs)            # warm-up
            store = MemoryEmbeddings(model.img_size)
            sync()
            kernels.reset_launches()
            encode_images(encode, packed, mine, read, store, img_size=model.img_size,
                          device=dev, batch_size=bs)
            sync()
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
            tag = f"{quantize or 'bf16'}_b{bs}"
            np.savez(Path(out) / f"emb_{tag}_rank{mesh.index}.npz",
                     **{s: store.features(s) for s in store.stems()})
            stores[(quantize, bs)] = store
            result(job="precompute", rank=mesh.index, tag=tag, stems=store.stems(),
                   calls=-(-len(mine) // bs), launches=launches)
        if spec["timed"]:
            timed = seeded_xrays(spec["timed"], spec["hw"], seed=33)
            tmine = pdist.process_shard(list(timed))

            def run():
                encode_images(encode, packed, tmine, timed.__getitem__,
                              MemoryEmbeddings(model.img_size), img_size=model.img_size,
                              device=dev, batch_size=spec["timed_batch"])
                sync()
            run()
            pdist.barrier()
            t0 = time.perf_counter()
            run()
            pdist.barrier()
            wall = time.perf_counter() - t0
            pdist.barrier()
            t1 = time.perf_counter()
            with profiled_busy(dev) as busy:
                run()
            pdist.barrier()
            result(job="precompute_timed", rank=mesh.index, tag=quantize or "bf16",
                   images=len(timed), wall_s=wall, images_per_s=len(timed) / wall,
                   profiled_wall_ms=(time.perf_counter() - t1) * 1e3,
                   busy_ms=busy.get("busy_ms"))
        del encode, packed

    if not spec["sweep"]:
        return
    stems, grid, source = sweep_inputs(spec, xrays)
    smine = pdist.process_shard(stems)
    emb = stores[(spec["quantize"][0], spec["batches"][0])]
    store = MemoryEmbeddings(model.img_size, {s: emb.features(source[s]) for s in smine},
                             {s: emb.sizes(source[s]) for s in smine})
    unet = seeded_unet(dev)
    head = SamMaskDecoderHead(None, spec["model"], store, device=dev, params=model,
                              cfg=model.cfg)
    enh = SegEnhance(SamSegRefiner(head, prompts2use=[["box"], ["pos_points", "neg_points"]]),
                     "highest_probability", "dilation", "square", 8)
    kernels.reset_launches()
    masks = MemoryMasks()
    refine_images(unet, enh, smine, grid.__getitem__, masks, img_batch=spec["img_batch"])
    sync()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    np.savez(Path(out) / f"sweep_rank{mesh.index}.npz",
             **{f"m_{s}": masks.masks(s) for s in smine},
             **{f"d_{s}": masks.estimated_dice(s) for s in smine})
    result(job="sweep", rank=mesh.index, stems=smine, launches=launches,
           batches=-(-len(smine) // spec["img_batch"]))


def run_dryrun(spec, mesh, out):
    """The ``dryrun`` job: one data-parallel U-Net step at base 4 and one
    strided encoder batch at ``vit_t``, each rank's numbers."""
    from samcarriestheburden_torch.config import TrainConfig, UNetConfig
    from samcarriestheburden_torch.engine.embeddings import make_serving_encoder
    from samcarriestheburden_torch.train.loop import UNetTrainer

    n = mesh.size
    rng = np.random.default_rng(0)
    trainer = UNetTrainer(UNetConfig(n_channels=1, n_classes=17, base_channels=4,
                                     n_last_channel=4),
                          TrainConfig(epochs=2, batch_size=2 * n, data_sample_per_epoch=2 * n,
                                      data_aug=0.03, epoch_scan=False), mesh=mesh)
    x = rng.random((2 * n, 1, 64, 48)).astype(np.float32)
    y = (rng.random((2 * n, 17, 64, 48)) > 0.7).astype(np.float32)
    loss, _ = trainer.train_epoch(x, y, epoch=0)
    model = sam_model("vit_t", mesh.device)
    size = model.img_size
    imgs = rng.integers(0, 255, (2 * n, 3, size, size)).astype(np.uint8)
    mine = pdist.process_shard(list(range(2 * n)))
    sizes = torch.full((len(mine), 2), size, dtype=torch.int32)
    encode, packed = make_serving_encoder(model, torch.float32)
    feats = encode(packed, torch.from_numpy(imgs[mine]).to(mesh.device), sizes.to(mesh.device))
    ok = bool(np.isfinite(loss)) and bool(torch.isfinite(feats).all())
    result(job="dryrun", rank=mesh.index, loss=loss, digest=digest(trainer.model),
           encoded=mine, feats_shape=list(feats.shape), finite=ok)
    if not ok:
        raise RuntimeError(f"rank {mesh.index}: non-finite dryrun output")


def run_cli(spec, args, out):
    """The ``cli`` job: the port's CLIs in the working directory
    ``spec["root"]`` (holding ``data/``), the first joining the group
    through ``--multihost`` (one process: no flags, the single-process
    reference): the embeddings, merged by rank 0 through ``--merge_shards``;
    the sweep with each refiner (part files in a group); AMG."""
    from samcarriestheburden_torch.cli import (amg, generate_img_embeddings,
                                               save_refined_segmentations)

    world = args.world
    os.chdir(spec["root"])
    tag, model_id = spec["tag"], spec["model_id"]
    mh = [] if world == 1 else ["--multihost", "--coordinator", args.coordinator,
                                "--num_processes", str(world), "--process_id", str(args.rank)]
    emb = f"data/emb_{tag}.h5"
    generate_img_embeddings.main(["--checkpoint", "data/tiny.npz", "--model_type", "vit_t",
                                  "--output", emb, "--batch_size", "1", "--dtype", "float32",
                                  "--cpu", *mh])
    if pdist.process_count() != world:
        raise RuntimeError(f"the CLI joined a group of {pdist.process_count()}, not {world}")
    pdist.barrier()
    if world > 1 and args.rank == 0:
        generate_img_embeddings.main(["--merge_shards", "--output", emb, "--cpu"])
    pdist.barrier()
    for refiner in ("sam", "rndwalk"):
        save_refined_segmentations.main(
            ["--model_id", model_id, "--n_files", "500", "--sam_checkpoint", "data/tiny.npz",
             "--sam_model_type", "vit_t", "--embeddings", emb, "--img_batch", "1", "--cpu",
             "--refiner", refiner])
        pdist.barrier()
    amg.main(["--checkpoint", "data/tiny.npz", "--model-type", "vit_t", "--input",
              "data/amg_in", "--output", f"out_amg_{tag}", "--points-per-side", "2",
              "--pred-iou-thresh", "-100", "--stability-score-thresh", "0", "--cpu"])
    pdist.barrier()
    result(job="cli", rank=args.rank, tag=tag)


def run_nccl(spec, mesh, out):
    """The ``nccl`` job, one rank per card: an all-reduce, a broadcast and a
    gather of rows checked on the card, then one training step."""
    dev = mesh.device
    t = torch.arange(1, 1025, dtype=torch.float32, device=dev) * (mesh.index + 1)
    torch.distributed.all_reduce(t)
    want = torch.arange(1, 1025, dtype=torch.float32, device=dev) \
        * (mesh.size * (mesh.size + 1) / 2)
    rows = pdist.all_gather_rows(torch.full((2, 3), float(mesh.index), device=dev))
    b = pmesh.replicate(mesh, torch.full((4,), float(mesh.index), device=dev))
    ok = bool(torch.equal(t, want)) and rows.shape == (2 * mesh.size, 3) \
        and bool((b == 0).all())
    result(job="nccl", rank=mesh.index, backend=pdist.backend(), all_reduce_ok=ok,
           device=str(dev))
    if not ok:
        raise RuntimeError(f"rank {mesh.index}: an NCCL collective gave the wrong values")
    if spec:
        run_train(spec, mesh, out)
