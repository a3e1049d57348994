"""The port's U-Net training (``samcarriestheburden_torch/train/loop.py``,
``checkpoint.py``, ``logging.py``, ``models/unet.py``'s ``remat``,
``models/convert.py:adamw_state_from_jax``) against the JAX package's
``train/`` on the CPU, from the same parameters (the port's seeded U-Net
carried to JAX's layout by ``unet_params_from_torch``, as the other U-Net
tests do: JAX's ``unet.init`` alone takes 9 s jitted, 29 s eager, on one
CPU core), at base 4, 48 x 32 images, batch 2.

How the trajectories are held.  Adam divides each element's gradient by its
own running RMS, so on its first steps an element whose gradient is at the
rounding noise of its tensor (|g| ~ 1e-7 of the tensor's norm, a structural
near-cancellation: an instance norm's bias feeds the next instance norm)
gets a full-size update whose sign the noise picks; JAX's own jitted and
eager gradients disagree on such elements, and JAX against itself with its
initial weights moved by one ulp drifts as far as the port does (per-tensor
relative L2 up to 0.3 after six steps).  So the two-epoch runs are held step
by step: the sampled order and every step's loss and Dice free-running; the
gradients and the AdamW update of every step from JAX's own state before it,
each parameter tensor within PARAM_RTOL; and from JAX's state after epoch 1,
where the moments are warm, epoch 2's parameters within PARAM_RTOL.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from samcarriestheburden_torch.config import TrainConfig, UNetConfig
from samcarriestheburden_torch.models.convert import (adamw_state_from_jax,
                                                      unet_params_from_torch,
                                                      unet_state_dict_from_jax)
from samcarriestheburden_torch.models.unet import build_unet
from samcarriestheburden_torch.train import checkpoint as tckpt
from samcarriestheburden_torch.train.logging import RunLogger
from samcarriestheburden_torch.train.loop import (UNetTrainer, bce_with_logits, cosine_lr,
                                                  sample_order, train_unet)
from samcarriestheburden_tpu.config import TrainConfig as JTrainConfig
from samcarriestheburden_tpu.config import UNetConfig as JUNetConfig
from samcarriestheburden_tpu.train import loop as jloop
from samcarriestheburden_tpu.train.logging import RunLogger as JRunLogger

# the tier-1 command runs six xdist workers on the machine's cores: one
# intra-op thread each, or their thread pools oversubscribe the cores
torch.set_num_threads(1)

#: per-step BCE, fp32: the same sums in another order
LOSS_RTOL = 1e-4
#: each parameter tensor's relative L2 (and each gradient's), fp32
PARAM_RTOL = 1e-4
#: bf16 forward: every layer's output rounded to 8 bits of mantissa, in
#: another order (XLA against oneDNN); the loss measured 2e-4 apart
BF16_LOSS_RTOL = 1e-3
#: bf16 logits against JAX's bf16 logits, relative to their largest value:
#: a few bf16 ulps (2^-8 each) through ten convolutions
BF16_LOGIT_RTOL = 3e-2
#: a logit this close to 0 (the sigmoid's 0.5 threshold) may land on the
#: other side in the other package; each such pixel moves its row's Dice,
#: 2|P∩Y| / (|P| + |Y|), by at most 3 / (|P| + |Y|)
TIE = 1e-3

UCFG = dict(n_channels=1, n_classes=3, base_channels=4, n_last_channel=4)
CFG = UNetConfig(**UCFG)
HW = (48, 32)


def toy_data(n=6, c=3, hw=HW, seed=0):
    """Images and, per image, one class that depends on it (learnable)."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, 1, *hw)).astype(np.float32)
    y = np.zeros((n, c, *hw), np.float32)
    for i in range(n):
        y[i, i % c] = (x[i, 0] > 0.5).astype(np.float32)
    return x, y


def tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def init_params(seed=0):
    """The same starting weights for both packages, in JAX's layout."""
    return unet_params_from_torch(build_unet(CFG, device="cpu", seed=seed).state_dict(), CFG)


def jax_trainer(**kw):
    return jloop.UNetTrainer(JUNetConfig(**UCFG), JTrainConfig(**kw),
                             init_params=jax.tree.map(jnp.asarray, init_params()))


def train_kw(mode, **kw):
    return dict(dict(epochs=4, batch_size=2, data_sample_per_epoch=4, data_aug=0.0,
                     sample_mode=mode, epoch_scan=False), **kw)


def record_jax_steps(jt):
    """Record every JAX train step: its state before, batch, lr, loss, Dice."""
    steps = []
    step = jt._train_step

    def hook(params, opt_state, x_all, y_all, idx, w, key, lr):
        out = step(params, opt_state, x_all, y_all, idx, w, key, lr)
        steps.append(dict(params=tree_np(params), opt_state=tree_np(opt_state),
                          idx=np.asarray(idx), lr=float(lr), loss=float(out[2]),
                          dice=np.asarray(out[3])))
        return out

    jt._train_step = hook
    return steps


def load_jax_state(trainer, params, opt_state):
    """JAX's params and AdamW state into a port trainer, through the converters."""
    trainer.model.load_state_dict(unet_state_dict_from_jax(params, CFG))
    adam = opt_state.inner_state[0]
    names = [n for n, _ in trainer.model.named_parameters()]
    trainer.optimizer.load_state_dict({
        "state": adamw_state_from_jax(adam.mu, adam.nu, adam.count, CFG, names),
        "param_groups": trainer.optimizer.state_dict()["param_groups"]})


def rel_l2(a, b) -> float:
    return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()


def worst_tensor(sd, ref):
    return max((rel_l2(sd[k], ref[k]), k) for k in ref)


@pytest.fixture(scope="module")
def jax_runs():
    """Two epochs of the JAX trainer in each sampling mode (fp32, no
    augmentation), every step recorded, and its state after each epoch."""
    x, y = toy_data()
    jt = jax_trainer(**train_kw("bootstrap"))
    init = tree_np(jt.state.params)
    grad = jax.jit(jax.grad(lambda p, xb, yb, w: jt._forward_loss(p, xb, yb, w)[0]))
    update = jax.jit(jt.optimizer.update)
    compiled = jt._train_step
    runs = {}
    for mode in ("bootstrap", "shuffle"):
        # one trainer (one compiled step: the sampling is on the host), reset
        jt.cfg = jt.cfg.replace(sample_mode=mode)
        jt.state = jloop.TrainState(params=jax.tree.map(jnp.asarray, init),
                                    opt_state=jt.optimizer.init(init))
        jt._train_step = compiled
        steps = record_jax_steps(jt)
        epochs = []
        for epoch in range(2):
            n0 = len(steps)
            loss, dice = jt.train_epoch(x, y, epoch)
            epochs.append(dict(loss=loss, dice=dice, steps=steps[n0:],
                               params=tree_np(jt.state.params),
                               opt_state=tree_np(jt.state.opt_state)))
        runs[mode] = dict(init=init, epochs=epochs, eval=jt.evaluate(x, y),
                          lr=jt.current_lr)
    return x, y, dict(runs, grad=grad, update=update)


def test_bce_and_cosine_lr_match_jax_and_torch():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 3, 8, 8)).astype(np.float32) * 4
    targets = (rng.random((2, 3, 8, 8)) > 0.5).astype(np.float32)
    w = np.asarray([1.0, 5.0, 0.5], np.float32).reshape(-1, 1, 1)
    ours = bce_with_logits(torch.from_numpy(logits), torch.from_numpy(targets),
                           torch.from_numpy(w)).item()
    np.testing.assert_allclose(ours, float(jloop.bce_with_logits(logits, targets, w)),
                               rtol=1e-6)
    theirs = F.binary_cross_entropy_with_logits(torch.from_numpy(logits),
                                                torch.from_numpy(targets),
                                                pos_weight=torch.from_numpy(w)).item()
    np.testing.assert_allclose(ours, theirs, rtol=1e-6)
    for epoch in (0, 1, 100, 349, 350):
        np.testing.assert_allclose(cosine_lr(epoch, 1e-3, 350, 1e-5),
                                   float(jloop.cosine_lr(np.float32(epoch), 1e-3, 350, 1e-5)),
                                   rtol=1e-6)


@pytest.mark.parametrize("mode", ["bootstrap", "shuffle"])
def test_two_epochs_against_the_jax_trainer(jax_runs, mode):
    """Free-running from the same params: the same sampled order, every
    step's loss within LOSS_RTOL, its Dice rows equal away from threshold
    ties, the epoch's mean loss; then every step again from JAX's state
    before it: the gradients, and the AdamW update of the same gradients,
    each tensor within PARAM_RTOL."""
    x, y, runs = jax_runs
    run = runs[mode]
    cfg = TrainConfig(**train_kw(mode))
    pt = UNetTrainer(CFG, cfg, init_params=unet_state_dict_from_jax(run["init"], CFG),
                     device="cpu")
    seen = []
    step = pt.step
    forward_loss = pt.forward_loss

    def recording_forward_loss(xb, yb, w):
        loss, logits = forward_loss(xb, yb, w)
        seen.append((logits.detach().clone(), yb.clone()))
        return loss, logits

    def recording_step(xb, yb, lr):
        loss, dice = step(xb, yb, lr)
        seen[-1] = (seen[-1], float(loss), dice.numpy(), lr)
        return loss, dice

    pt.forward_loss, pt.step = recording_forward_loss, recording_step
    for epoch, rec in enumerate(run["epochs"]):
        n0 = len(seen)
        loss, dice = pt.train_epoch(x, y, epoch)
        ours = seen[n0:]
        order = sample_order(cfg, len(x), epoch)
        assert len(ours) == len(rec["steps"]) == len(order) // cfg.batch_size
        for s, (((logits, yb), t_loss, t_dice, lr), j) in enumerate(zip(ours, rec["steps"])):
            np.testing.assert_array_equal(j["idx"], order[s * 2:(s + 1) * 2])
            np.testing.assert_allclose(lr, j["lr"], rtol=1e-6)
            np.testing.assert_allclose(t_loss, j["loss"], rtol=LOSS_RTOL)
            ties = (logits.abs() <= TIE).flatten(2).sum(2)
            card = ((logits > 0).float() + yb).flatten(2).sum(2)
            bound = (3 * ties / card.clamp_min(1)).numpy() + 1e-6
            assert np.array_equal(np.isnan(t_dice), np.isnan(j["dice"]))
            assert (np.nan_to_num(np.abs(t_dice - j["dice"])) <= bound).all()
        np.testing.assert_allclose(loss, rec["loss"], rtol=LOSS_RTOL)
        assert dice.shape == rec["dice"].shape

    # every step from JAX's state before it
    xd, yd = pt.device_data(x, y)
    for epoch, rec in enumerate(run["epochs"]):
        for j in rec["steps"]:
            idx = torch.from_numpy(j["idx"]).long()
            xb, yb = pt.augment(xd[idx], yd[idx].float(), torch.zeros(2, 2, 3))
            g_tree = runs["grad"](j["params"], jnp.asarray(xb.numpy()),
                                  jnp.asarray(yb.numpy()), jnp.ones(2))
            g_jax = unet_state_dict_from_jax(tree_np(g_tree), CFG)
            load_jax_state(pt, j["params"], j["opt_state"])
            loss, logits = pt.forward_loss(xb, yb, torch.ones(2))
            pt.optimizer.zero_grad()
            loss.backward()
            np.testing.assert_allclose(loss.item(), j["loss"], rtol=LOSS_RTOL)
            grads = {n: p.grad for n, p in pt.model.named_parameters()}
            err, name = worst_tensor(grads, g_jax)
            assert err <= PARAM_RTOL, (epoch, name, err)
            # the update of JAX's gradients from JAX's state: optax's and torch's AdamW
            load_jax_state(pt, j["params"], j["opt_state"])
            for n, p in pt.model.named_parameters():
                p.grad = g_jax[n].clone()
            for group in pt.optimizer.param_groups:
                group["lr"] = pt.lr_at(epoch)
            pt.optimizer.step()
            opt_state = jax.tree.map(jnp.asarray, j["opt_state"])
            opt_state.hyperparams["learning_rate"] = jnp.float32(j["lr"])
            updates, _ = runs["update"](g_tree, opt_state, j["params"])
            want = unet_state_dict_from_jax(tree_np(jax.tree.map(
                lambda p, u: p + u, j["params"], updates)), CFG)
            err, name = worst_tensor(pt.model.state_dict(), want)
            assert err <= PARAM_RTOL, (epoch, name, err)


@pytest.mark.parametrize("mode", ["bootstrap", "shuffle"])
def test_resume_from_the_jax_state_after_epoch_1(jax_runs, mode):
    """JAX's params and AdamW moments after epoch 1 into a fresh port
    trainer; epoch 2 against JAX's epoch 2: every parameter tensor within
    PARAM_RTOL, the mean loss within LOSS_RTOL, and evaluate against JAX's."""
    x, y, runs = jax_runs
    run = runs[mode]
    first, second = run["epochs"]
    pt = UNetTrainer(CFG, TrainConfig(**train_kw(mode)),
                     init_params=unet_state_dict_from_jax(first["params"], CFG), device="cpu")
    load_jax_state(pt, first["params"], first["opt_state"])
    assert all(s["step"].item() == len(first["steps"]) for s in pt.optimizer.state.values())
    loss, _ = pt.train_epoch(x, y, 1)
    np.testing.assert_allclose(loss, second["loss"], rtol=LOSS_RTOL)
    err, name = worst_tensor(pt.model.state_dict(), unet_state_dict_from_jax(second["params"],
                                                                             CFG))
    assert err <= PARAM_RTOL, (name, err)
    assert pt.epoch == 2
    np.testing.assert_allclose(pt.current_lr, run["lr"], rtol=1e-6)
    # evaluate: JAX's params after epoch 2 in both
    pt.model.load_state_dict(unet_state_dict_from_jax(second["params"], CFG))
    va_loss, va_dice = pt.evaluate(x, y)
    j_loss, j_dice = run["eval"]
    np.testing.assert_allclose(va_loss, j_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(va_dice, j_dice, atol=1e-6)


def test_the_bf16_path_against_jax_bf16():
    """compute_dtype="bfloat16" against the JAX trainer's, from JAX's state
    before each of its steps: the bf16 logits within BF16_LOGIT_RTOL of
    their largest value, the loss within BF16_LOSS_RTOL; the master
    parameters and the loss stay fp32."""
    x, y = toy_data()
    kw = train_kw("bootstrap", compute_dtype="bfloat16")
    jt = jax_trainer(**kw)
    steps = record_jax_steps(jt)
    for epoch in range(2):
        jt.train_epoch(x, y, epoch)
    pt = UNetTrainer(CFG, TrainConfig(**kw), init_params=unet_state_dict_from_jax(
        steps[0]["params"], CFG), device="cpu")
    xd, yd = pt.device_data(x, y)
    fwd = jax.jit(lambda p, xb, yb: jt._forward_loss(p, xb, yb, jnp.ones(2)))
    for j in steps:
        idx = torch.from_numpy(j["idx"]).long()
        xb, yb = pt.augment(xd[idx], yd[idx].float(), torch.zeros(2, 2, 3))
        j_loss, (j_logits, _) = fwd(j["params"], jnp.asarray(xb.numpy()), jnp.asarray(yb.numpy()))
        load_jax_state(pt, j["params"], j["opt_state"])
        loss, logits = pt.forward_loss(xb, yb, torch.ones(2))
        assert loss.dtype == logits.dtype == torch.float32
        scale = np.abs(np.asarray(j_logits)).max()
        assert np.abs(logits.detach().numpy() - np.asarray(j_logits)).max() \
            <= BF16_LOGIT_RTOL * scale
        np.testing.assert_allclose(loss.item(), j["loss"], rtol=BF16_LOSS_RTOL)
        pt.step(xb, yb, j["lr"])
        assert all(p.dtype == torch.float32 for p in pt.model.parameters())


def test_epoch_scan_equals_per_step():
    """Augmenting the whole epoch first gives the per-step path's numbers
    exactly (the same θ, the same ops), with augmentation on."""
    x, y = toy_data(n=4)
    out = {}
    for scan in (False, True):
        cfg = TrainConfig(epochs=2, batch_size=2, data_sample_per_epoch=4, data_aug=0.03,
                          epoch_scan=scan)
        model, hist = train_unet((x, y), (x, y), CFG, cfg, device="cpu")
        out[scan] = (model.state_dict(), hist)
    for k, v in out[False][0].items():
        assert torch.equal(v, out[True][0][k]), k
    assert out[False][1] == out[True][1]


@pytest.mark.parametrize("method", ["gather", "matmul"])
def test_training_with_augmentation_learns(method):
    x, y = toy_data(n=4)
    cfg = TrainConfig(epochs=3, batch_size=2, data_sample_per_epoch=4, data_aug=0.03,
                      aug_method=method, lr=3e-3)
    _, hist = train_unet((x, y), (x, y), CFG, cfg, device="cpu")
    assert len(hist) == 3 and all(np.isfinite(h["train_bce"]) for h in hist)
    assert hist[-1]["val_bce"] < hist[0]["val_bce"]


def test_remat_gives_the_plain_logits_and_gradients():
    model = build_unet(CFG, device="cpu", seed=0).train()
    x = torch.from_numpy(toy_data(n=2)[0])
    grads = []
    for remat in (False, True):
        model.zero_grad()
        logits = model(x, remat=remat)
        (logits ** 2).mean().backward()
        grads.append((logits.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}))
    assert torch.equal(grads[0][0], grads[1][0])
    for n, g in grads[0][1].items():
        assert torch.equal(g, grads[1][1][n]), n


def test_checkpoint_resume_is_exact(tmp_path):
    """Interrupted training resumes exactly from the saved epoch: weights,
    AdamW's moments and steps, the epoch, the sampling and the θ."""
    x, y = toy_data(n=4)
    cfg = TrainConfig(epochs=4, batch_size=2, data_sample_per_epoch=4, data_aug=0.03)
    full, hist_full = train_unet((x, y), (x, y), CFG, cfg, device="cpu")
    ck = tmp_path / "ckpt"
    train_unet((x, y), (x, y), CFG, cfg, device="cpu", checkpoint_dir=ck, checkpoint_every=2)
    assert sorted(p.name for p in ck.iterdir()) == ["epoch_00002", "epoch_00004"]
    import shutil
    shutil.rmtree(ck / "epoch_00004")                    # a crash after epoch 2
    assert tckpt.latest_checkpoint(ck).name == "epoch_00002"
    resumed, hist = train_unet((x, y), (x, y), CFG, cfg, device="cpu", checkpoint_dir=ck,
                               checkpoint_every=2)
    assert [h["epoch"] for h in hist] == [2, 3] and hist == hist_full[2:]
    for k, v in full.state_dict().items():
        assert torch.equal(v, resumed.state_dict()[k]), k
    assert tckpt.latest_checkpoint(tmp_path / "none") is None


def test_run_logger_writes_the_jax_format(tmp_path):
    calls = [("report_scalar", ("BCE", "train", 0.5, 0)), ("report_scalar", ("BCE", "val", 0.4, 1)),
             ("report_histogram", ("Dice", "val", 0, [0.1, float("nan")], ["a", "b"], "class",
                                   "dice"))]
    logs = []
    for cls, root in ((RunLogger, tmp_path / "port"), (JRunLogger, tmp_path / "jax")):
        log = cls("proj/x", "task a", tags=["t"], config={"lr": 1e-3}, root=str(root))
        for name, args in calls:
            getattr(log, name)(*args)
        assert log.scalars()[1]["value"] == 0.4
        log.close()
        meta = json.loads((log.dir / "meta.json").read_text())
        meta.pop("created")
        logs.append((log.dir.relative_to(root).parent, log.dir.name.rsplit("-", 2)[0], meta,
                     (log.dir / "scalars.jsonl").read_text(),
                     (log.dir / "histograms.jsonl").read_text()))
    assert logs[0] == logs[1]


def test_one_card_only():
    for kw in (dict(num_devices=2), dict(data_placement="sharded")):
        with pytest.raises(NotImplementedError):
            UNetTrainer(CFG, TrainConfig(**kw), device="cpu")
    with pytest.raises(NotImplementedError):
        UNetTrainer(CFG, TrainConfig(), mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        UNetTrainer(CFG, TrainConfig(compute_dtype="float16"), device="cpu")
