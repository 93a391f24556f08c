"""The port's trainer vs the JAX package's, on the CPU in f32.

Tiny models (base width 4-8, depth 2, 32x32 frames) with every weight and
BatchNorm statistic drawn from numpy and carried into the port through
``models/bridge.py``; uint8 batches from a numpy seed. Each test states
its tolerance. The JAX side's compiled steps are shared through
module-scoped fixtures, one model per family.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_based_frame_interpolation_torch.config import (
    LossConfig as TLoss, ModelConfig as TConfig, TrainConfig as TTrain)
from ai_based_frame_interpolation_torch.data.loader import (
    TripletLoader as TLoader)
from ai_based_frame_interpolation_torch.data.synthetic import (
    write_scene_tree)
from ai_based_frame_interpolation_torch.data.triplets import (
    scan_triplets, split_triplets)
from ai_based_frame_interpolation_torch.infer.engine import (
    InterpolationEngine)
from ai_based_frame_interpolation_torch.models import build_model as t_build
from ai_based_frame_interpolation_torch.models.bridge import flax_to_state_dict
from ai_based_frame_interpolation_torch.models.unet import (
    DoubleConv as TDoubleConv)
from ai_based_frame_interpolation_torch.ops.census import (
    census_loss, census_transform)
from ai_based_frame_interpolation_torch.ops.ssim import combined_loss
from ai_based_frame_interpolation_torch.train import loop as tl
from ai_based_frame_interpolation_torch.train.checkpoint import (
    Checkpointer, load_variables, save_variables)
from ai_based_frame_interpolation_tpu.config import (
    LossConfig as JLoss, ModelConfig as JConfig, TrainConfig as JTrain)
from ai_based_frame_interpolation_tpu.data.loader import (
    TripletLoader as JLoader)
from ai_based_frame_interpolation_tpu.models import build_model as j_build
from ai_based_frame_interpolation_tpu.models.unet import (
    DoubleConv as JDoubleConv)
from ai_based_frame_interpolation_tpu.ops.census import (
    census_loss as j_census_loss)
from ai_based_frame_interpolation_tpu.ops.ssim import (
    combined_loss as j_combined_loss)
from ai_based_frame_interpolation_tpu.parallel.mesh import make_mesh
from ai_based_frame_interpolation_tpu.train import loop as jl

from test_torch_unet import random_variables

HW = (32, 32)
B = 4
LR = 1e-3
# (model config, loss config): each family with the loss terms it trains.
# The census term is held against JAX's on the same inputs
# (test_loss_terms_match_jax), not through a model: its soft sign has a
# slope of 141 per unit of prediction at 0, so the models' f32 rounding
# noise (1e-6 of |8|) would move it by 1e-4
CASES = {
    "unet": (dict(base_width=4, depth=2, space_to_depth=4, residual=True,
                  refine_width=8, upsample="half_pixel"), {}),
    "flow": (dict(arch="flow", base_width=4, depth=2, flow_scale=2,
                  refine_width=4, max_flow=4),
             dict(flow_smooth_weight=0.1, flow_photo_weight=0.1)),
    "tower": (dict(arch="tower", base_width=8, depth=2, space_to_depth=2,
                   residual=True, refine_width=4, slim_decoder=True), {}),
    # the bidirectional field (its F10 in the photometric loss) through a
    # cascade stage, whose out conv is drawn, not zero, so it moves the field
    "flow_bidir_cascade": (dict(arch="flow", base_width=4, depth=2,
                                flow_scale=2, refine_width=4, max_flow=4,
                                flow_bidir=True, flow_cascade=1),
                           dict(flow_smooth_weight=0.1,
                                flow_photo_weight=0.1)),
}


# JAX's loss and gradients, compiled once per family and batch shape
J_LOSS_AND_GRADS = jax.jit(
    jax.value_and_grad(jl._loss_and_updates, has_aux=True),
    static_argnums=(2, 4))


def _batch(seed=0, n=B, hw=HW):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, 256, (n, *hw, 1), dtype=np.uint8)
            for k in ("f0", "f1", "gt")}


class Case:
    """One family: the JAX model and its variables, and a factory of port
    models on the same weights."""

    def __init__(self, name):
        kw, loss = CASES[name]
        self.kw = kw
        self.jmodel = j_build(JConfig(**kw), jnp.float32)
        self.variables = random_variables(kw, HW, seed=1)
        self.state_dict = flax_to_state_dict(self.variables)
        self.jloss = JLoss(**loss)
        self.tloss = TLoss(**loss)

    def port(self):
        model = t_build(TConfig(**self.kw), torch.float32)
        model.load_state_dict(self.state_dict)
        return model

    def jstate(self, **train_kw):
        v = jax.tree.map(jnp.asarray, self.variables)
        return jl.create_train_state(self.jmodel, v,
                                     JTrain(learning_rate=LR, **train_kw))

    def tstate(self, **train_kw):
        return tl.create_train_state(self.port(), None,
                                     TTrain(learning_rate=LR, **train_kw),
                                     "cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's steps on one CPU thread: the tiny models' ops gain
    nothing from more, and the suite's workers share the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cases():
    return {name: Case(name) for name in CASES}


@pytest.fixture(scope="module")
def jax_first_step(cases):
    """JAX's state after one plain step of the U-Net on ``_batch(1)``."""
    case = cases["unet"]
    return jl.train_step(case.jstate(), _batch(1), case.jloss)


def _named(tree, stats):
    """A Flax params-shaped tree (grads, Adam moments) under port names."""
    sd = flax_to_state_dict({"params": jax.tree.map(np.asarray, tree),
                             "batch_stats": stats})
    return {k: v.numpy() for k, v in sd.items()}


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def test_batchnorm_train_mode_and_running_update_match_flax():
    # one DoubleConv, f32, batch statistics over (N, H, W) and Flax's
    # running-statistic rule (momentum 0.9, biased variance): 1e-6 relative
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 10, 12, 5)).astype(np.float32)
    jm = JDoubleConv(out_ch=6, compute_dtype=jnp.float32)
    shapes = jax.eval_shape(lambda a: jm.init(jax.random.key(0), a,
                                              train=False), x)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, leaf: (rng.uniform(0.5, 1.5, leaf.shape) if "var" in
                         jax.tree_util.keystr(p) or "scale" in
                         jax.tree_util.keystr(p) else
                         rng.standard_normal(leaf.shape) * 0.3)
        .astype(np.float32), shapes)
    want, mutated = jax.jit(lambda v, a: jm.apply(
        v, a, train=True, mutable=["batch_stats"]))(variables, x)
    tm = TDoubleConv(5, 6)
    p, s = variables["params"], variables["batch_stats"]
    with torch.no_grad():
        for i in (1, 2):
            getattr(tm, f"conv{i}").weight.copy_(torch.from_numpy(
                np.transpose(p[f"conv{i}"]["kernel"], (3, 2, 0, 1))))
            bn = getattr(tm, f"bn{i}")
            bn.weight.copy_(torch.from_numpy(p[f"bn{i}"]["scale"]))
            bn.bias.copy_(torch.from_numpy(p[f"bn{i}"]["bias"]))
            bn.running_mean.copy_(torch.from_numpy(s[f"bn{i}"]["mean"]))
            bn.running_var.copy_(torch.from_numpy(s[f"bn{i}"]["var"]))
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2), torch.float32,
             train=True)
    assert _rel(got.detach().permute(0, 2, 3, 1).numpy(),
                np.asarray(want)) <= 1e-6
    for i in (1, 2):
        bn = getattr(tm, f"bn{i}")
        new = mutated["batch_stats"][f"bn{i}"]
        assert _rel(bn.running_mean.numpy(), np.asarray(new["mean"])) <= 1e-6
        assert _rel(bn.running_var.numpy(), np.asarray(new["var"])) <= 1e-6
    # the inference forward reads the updated running statistics
    tm(torch.from_numpy(x).permute(0, 3, 1, 2), torch.float32)
    assert _rel(tm.bn2.running_var.numpy(),
                np.asarray(mutated["batch_stats"]["bn2"]["var"])) <= 1e-6


@pytest.mark.parametrize("term", ["combined", "census_gray", "census_rgb",
                                  "smoothness", "photometric"])
def test_loss_terms_match_jax(term):
    # each term on the same f32 NHWC inputs: within 1e-5, and its gradient
    # in the prediction (the flow for the flow terms) within 1e-4 of the
    # gradient's largest value
    from ai_based_frame_interpolation_tpu.ops.warp import backward_warp
    from ai_based_frame_interpolation_torch.ops.warp import (
        backward_warp as t_warp)

    rng = np.random.default_rng(5)
    c = 3 if term == "census_rgb" else 1
    window = 3 if term == "census_rgb" else 7
    pred, gt, f0, f1 = (rng.uniform(-1, 1, (2, 20, 24, c)).astype(np.float32)
                        for _ in range(4))
    flow = rng.uniform(-3, 3, (2, 20, 24, 2)).astype(np.float32)
    x = flow if term in ("smoothness", "photometric") else pred

    def jax_term(x):
        if term == "combined":
            return j_combined_loss(x, gt)
        if term.startswith("census"):
            return j_census_loss(x, gt, window)
        if term == "smoothness":
            return jl.flow_smoothness(x, 0.5 * (f0 + f1), 10.0)
        return (jnp.mean(jnp.abs(backward_warp(f0, -x) - f1)) +
                jnp.mean(jnp.abs(backward_warp(f1, x) - f0)))

    def port_term(x):
        t = torch.from_numpy
        if term == "combined":
            return combined_loss(x, t(gt))
        if term.startswith("census"):
            return census_loss(x, t(gt), window)
        if term == "smoothness":
            return tl.flow_smoothness(x, 0.5 * (t(f0) + t(f1)), 10.0)
        return (torch.mean(torch.abs(t_warp(t(f0), -x, "gather4") - t(f1)))
                + torch.mean(torch.abs(t_warp(t(f1), x, "gather4") - t(f0))))

    want, jg = jax.jit(jax.value_and_grad(jax_term))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = port_term(tx)
    got.backward()
    assert abs(float(got) - float(want)) <= 1e-5
    jg = np.asarray(jg)
    assert np.max(np.abs(tx.grad.numpy() - jg)) <= 1e-4 * np.max(np.abs(jg))


@pytest.mark.parametrize("window", [2, 1, 8])
def test_census_rejects_even_or_small_windows(window):
    with pytest.raises(ValueError, match="odd >= 3"):
        census_transform(torch.zeros(1, 8, 8, 1), window)


@pytest.mark.parametrize("name", list(CASES))
def test_loss_gradients_and_batch_stats_match_jax(cases, name):
    # per parameter: max |g_port - g_jax| <= 1e-4 max |g_jax|; the loss
    # within 1e-4 relative (f32 convs summed in another order: the random
    # weights' predictions reach |8|, off by 1e-6 of that); the updated
    # running statistics within 1e-6 relative, 2e-6 for the bidirectional
    # cascade: its weights put a batch mean of 0.133 at down1's first
    # BatchNorm, where JAX's f32 statistic sits 1.6e-7 (1.2e-6 of it) from
    # an f64 run of the same forward and the port's 7e-9
    case = cases[name]
    stat_bound = 2e-6 if name == "flow_bidir_cascade" else 1e-6
    batch = _batch(1)
    v = jax.tree.map(jnp.asarray, case.variables)
    (jloss, jstats), jgrads = J_LOSS_AND_GRADS(
        v["params"], v["batch_stats"], case.jmodel.apply, batch, case.jloss)
    model = case.port()
    loss = tl._grads(model, tl._on(batch, torch.device("cpu")), case.tloss, 1)
    assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    want = _named(jgrads, case.variables["batch_stats"])
    for pname, p in model.named_parameters():
        g, w = p.grad.numpy(), want[pname]
        assert np.max(np.abs(g - w)) <= 1e-4 * np.max(np.abs(w)), pname
        assert np.any(g != 0), pname
    stats = _named(case.variables["params"], jax.tree.map(np.asarray, jstats))
    for bname, b in model.named_buffers():
        if "running" in bname:
            assert _rel(b.numpy(), stats[bname]) <= stat_bound, bname


def _opt_moments(state):
    """Adam's (mu, nu) by port name, and its step count, from the port."""
    mu, nu, steps = {}, {}, set()
    for name, p in state.model.named_parameters():
        s = state.tx.state[p]
        mu[name], nu[name] = s["exp_avg"].numpy(), s["exp_avg_sq"].numpy()
        steps.add(int(s["step"]))
    return mu, nu, steps


@pytest.mark.parametrize("mode", ["plain", "grad_accum_and_ema"])
def test_train_step_matches_optax(cases, jax_first_step, mode):
    # one step from the same weights: every parameter within 1e-6 of JAX's
    # where |g_JAX| > 1e-6 and within lr everywhere. Adam's first step is
    # -lr g / (|g| + eps), so |g_JAX| > 1e-6 where JAX's step exceeds
    # lr / (1 + eps / 1e-6). BatchNorm statistics within 1e-6 relative;
    # the EMA (decay 0.9) within a tenth of lr; grad_accum=2 runs two
    # microbatches of 4
    case = cases["unet"]
    kw = {} if mode == "plain" else dict(grad_accum=2, ema_decay=0.9)
    batch = _batch(1, n=B if mode == "plain" else 2 * B)
    p0 = _named(case.variables["params"], case.variables["batch_stats"])
    js, jloss = jax_first_step if mode == "plain" else jl.train_step(
        case.jstate(**kw), batch, case.jloss, ema_decay=0.9, grad_accum=2)
    ts = case.tstate(**kw)
    ts, loss = tl.train_step(ts, batch, case.tloss,
                             ema_decay=kw.get("ema_decay", 0.0),
                             grad_accum=kw.get("grad_accum", 1))
    assert ts.step == 1 and int(js.step) == 1
    assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    jstats = jax.tree.map(np.asarray, js.batch_stats)
    want = _named(js.params, jstats)
    for name, p in ts.model.named_parameters():
        d = np.abs(p.detach().numpy() - want[name])
        assert d.max() <= LR * (1 + 1e-3), name
        big = np.abs(want[name] - p0[name]) > LR / (1 + 1e-8 / 1e-6)
        assert np.all(d[big] <= 1e-6), name
        if kw:
            e = np.asarray(_named(js.ema_params, jstats)[name])
            assert np.all(np.abs(ts.ema_params[name].numpy() - e)
                          <= 0.1 * LR * (1 + 1e-3)), name
    for bname, b in ts.model.named_buffers():
        if "running" in bname:
            assert _rel(b.numpy(), want[bname]) <= 1e-6, bname


def test_nan_guard_matches_optax(cases, jax_first_step):
    # a non-finite loss: the parameters and BatchNorm statistics stay bit
    # for bit, Adam's moments decay by 0.9 and 0.999 (1e-6 relative) and
    # its count advances, as optax's do (zero gradients through
    # scale_by_adam: mu 0.9 mu, nu 0.999 nu, count + 1; JAX's own NaN step
    # is tests/test_train.py's); the moments hold the first step's
    # gradients, so they agree with optax's after that step as the
    # gradients do (mu within 1e-4 of its largest value, nu, a square,
    # 2e-4)
    case = cases["unet"]
    good = _batch(1)
    bad = dict(good, gt=np.full(good["gt"].shape, np.nan, np.float32))
    js, _ = jax_first_step
    ts = case.tstate()
    ts, _ = tl.train_step(ts, good, case.tloss)
    mu1, nu1, _ = _opt_moments(ts)
    mu1 = {k: v.copy() for k, v in mu1.items()}
    nu1 = {k: v.copy() for k, v in nu1.items()}
    before = {k: v.clone() for k, v in ts.model.state_dict().items()}
    ts, loss = tl.train_step(ts, bad, case.tloss)
    assert not np.isfinite(float(loss))
    for k, v in ts.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    mu, nu, steps = _opt_moments(ts)
    assert steps == {2} and ts.step == 2
    adam = js.opt_state.inner_state[0]
    assert int(adam.count) == 1
    stats = case.variables["batch_stats"]
    jmu, jnu = _named(adam.mu, stats), _named(adam.nu, stats)
    for name in mu:
        assert _rel(mu[name], np.float32(0.9) * mu1[name]) <= 1e-6, name
        assert _rel(nu[name], np.float32(0.999) * nu1[name]) <= 1e-6, name
        assert _rel(mu1[name], jmu[name]) <= 1e-4, name
        assert _rel(nu1[name], jnu[name]) <= 2e-4, name


@pytest.mark.parametrize("name", ["unet", "flow"])
def test_eval_step_matches_jax(cases, name):
    # inference forward on the running statistics (EMA weights scored):
    # loss within 1e-5, PSNR within 1e-3 dB, SSIM within 2e-4
    case = cases[name]
    batch = _batch(4)
    js = case.jstate(ema_decay=0.5)
    jm = jl.eval_step(js, batch, case.jloss, use_ema=True)
    ts = case.tstate(ema_decay=0.5)
    m = tl.eval_step(ts, batch, case.tloss, use_ema=True)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5
    assert abs(float(m["psnr"]) - float(jm["psnr"])) <= 1e-3
    assert abs(float(m["ssim"]) - float(jm["ssim"])) <= 2e-4


PLATEAU = {
    "improving": [5.0, 4.0, 3.0, 2.0],
    "flat_past_patience": [1.0] + [1.0] * 5,
    "noise_within_eps": [1.0, 1.0 - 1e-13, 1.0 + 1e-3, 0.99, 0.99, 0.99],
    "nan": [1.0, float("nan"), float("nan"), float("nan"), 0.5],
}


@pytest.mark.parametrize("seq", list(PLATEAU), ids=list(PLATEAU))
def test_plateau_scheduler_equals_jax(seq):
    # exact: the same lr after every epoch and the same internal state
    tp, jp = tl.PlateauScheduler(0.5, 2), jl.PlateauScheduler(0.5, 2)
    lr_t = lr_j = 1e-3
    for metric in PLATEAU[seq]:
        lr_t, lr_j = tp.update(metric, lr_t), jp.update(metric, lr_j)
        assert lr_t == lr_j
        assert (tp.best, tp.bad_epochs) == (jp.best, jp.bad_epochs) or \
            (np.isnan(tp.best) and np.isnan(jp.best))


@pytest.fixture(scope="module")
def scene_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scenes"))
    write_scene_tree(root, num_videos=2, num_frames=6, height=32, width=32,
                     seed=7)
    return split_triplets(scan_triplets(root), 0.25, seed=0)


def _t_loaders(scene_tree):
    train_t, val_t = scene_tree
    kw = dict(batch_size=2, height=32, width=32, num_workers=2,
              device="cpu")
    return (TLoader(train_t, seed=1, **kw),
            TLoader(val_t, shuffle=False, drop_remainder=False, **kw))


def _train(case, scene_tree, epochs, ckpt=None, start_epoch=0, state=None,
           history=None, log_fn=lambda s: None, cfg_kw=()):
    ttl, tvl = _t_loaders(scene_tree)
    cfg = TTrain(epochs=epochs, batch_size=2, learning_rate=LR,
                 ema_decay=0.5, loss=case.tloss, **dict(cfg_kw))
    return tl.train_model(case.port(), None, ttl, tvl, cfg, device="cpu",
                          checkpointer=ckpt, log_fn=log_fn,
                          start_epoch=start_epoch, state=state,
                          history=history)


@pytest.fixture(scope="module")
def port_run(cases, scene_tree):
    """The port's uninterrupted 2-epoch run of the U-Net (EMA 0.5): its
    state, history and log lines."""
    logs = []
    state, hist = _train(cases["unet"], scene_tree, 2, log_fn=logs.append)
    return state, hist, logs


def test_train_model_matches_jax(cases, scene_tree, port_run):
    # 2 epochs, 3 steps each, EMA on: train and val loss within 1e-4
    # relative per epoch, the LR history equal, the same log lines' shape
    case = cases["unet"]
    train_t, val_t = scene_tree
    kw = dict(batch_size=2, height=32, width=32, num_workers=2)
    jtl = JLoader(train_t, seed=1, **kw)
    jvl = JLoader(val_t, shuffle=False, drop_remainder=False, **kw)
    cfg = dict(epochs=2, batch_size=2, learning_rate=LR, ema_decay=0.5,
               loss=case.jloss)
    v = jax.tree.map(jnp.asarray, case.variables)
    _, jh = jl.train_model(case.jmodel, v, jtl, jvl, JTrain(**cfg),
                           mesh=make_mesh(1), log_fn=lambda s: None)
    _, th, logs = port_run
    for a, b in ((th.train_loss, jh.train_loss), (th.val_loss, jh.val_loss)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=0)
    assert th.lr == jh.lr
    assert len(logs) == 2 and logs[1].startswith("epoch 2/2  train ")


def test_save_every_thins_latest_but_keeps_best(cases, scene_tree):
    # JAX's policy: "latest" every save_every epochs and at the last one,
    # "best" whenever the val loss improves; and a loader that yields no
    # batch is refused before any step
    class Recorder:
        def __init__(self):
            self.calls = []

        def save(self, state, epoch, history=None, best=False, latest=True):
            self.calls.append((epoch, best, latest, state.step))

    rec = Recorder()
    _, hist = _train(cases["unet"], scene_tree, 3, ckpt=rec,
                     cfg_kw=dict(save_every=2))
    best, want = float("inf"), []
    for epoch, val in enumerate(hist.val_loss):
        improved = val < best
        best = min(best, val)
        latest = (epoch + 1) % 2 == 0 or epoch == 2
        if improved or latest:
            want.append((epoch, improved, latest, 3 * (epoch + 1)))
    assert rec.calls == want
    empty = TLoader(scene_tree[0], 100, device="cpu")
    with pytest.raises(ValueError, match="zero batches"):
        tl.train_model(cases["unet"].port(), None, empty, [], TTrain(),
                       device="cpu")


def test_resume_is_bit_identical_and_exports(cases, scene_tree, port_run,
                                             tmp_path):
    # 2 epochs in one run against 1 epoch, a restore of "latest" into a
    # fresh state and 1 more: parameters, buffers, EMA, Adam's state and
    # the step bit for bit; then the EMA export through from_checkpoint
    # within 1 LSB of an engine built on the same state (it is exact)
    case = cases["unet"]
    full, hist, _ = port_run
    ckpt = Checkpointer(str(tmp_path / "b"), device="cpu")
    _train(case, scene_tree, 1, ckpt)
    fresh = case.tstate(ema_decay=0.5)
    fresh, epoch, hd = ckpt.restore(fresh, which="latest")
    assert epoch == 1 and fresh.step == 3
    resumed, hist2 = _train(case, scene_tree, 2, ckpt, start_epoch=1,
                            state=fresh, history=tl.History(**hd))
    assert resumed.step == full.step == 6
    assert hist2.train_loss == hist.train_loss
    for k, v in full.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k
    for k, v in full.ema_params.items():
        assert torch.equal(v, resumed.ema_params[k]), k
    mu, nu, steps = _opt_moments(full)
    mu2, nu2, steps2 = _opt_moments(resumed)
    assert steps == steps2 == {6}
    for k in mu:
        np.testing.assert_array_equal(mu[k], mu2[k])
        np.testing.assert_array_equal(nu[k], nu2[k])

    cfg = TConfig(**case.kw)
    out = str(tmp_path / "export")
    save_variables(out, resumed.variables(use_ema=True), cfg)
    variables, loaded = load_variables(out)
    assert loaded == cfg
    for k, v in resumed.variables(use_ema=True).items():
        assert torch.equal(variables[k], v), k
    eng = InterpolationEngine.from_checkpoint(out, device="cpu")
    ref = InterpolationEngine(t_build(cfg), variables, device="cpu")
    b = _batch(6, n=2)
    got, want = (e.interpolate_batch(b["f0"], b["f1"]) for e in (eng, ref))
    assert np.max(np.abs(got.astype(int) - want.astype(int))) <= 1
    # a .pth is the reference's format (tests/test_torch_checkpoint_import
    # .py): a missing one is a missing file
    with pytest.raises(FileNotFoundError):
        InterpolationEngine.from_checkpoint(str(tmp_path / "best_model.pth"),
                                            device="cpu")
    with pytest.raises(FileNotFoundError):
        InterpolationEngine.from_checkpoint(str(tmp_path / "nothing"),
                                            device="cpu")


# the kernel wrappers of the port and the plain versions the training
# forward must not call either
WRAPPERS = ("refine_head", "refine_head_reference", "refine_head_direct",
            "refine_head_dconv", "sample_fused", "sample_fused_reference",
            "double_conv_fused", "up_double_conv_fused", "conv_direct",
            "head_out_direct", "ssim_eval_fused", "ssim_eval_tiled",
            "ssim_eval_auto")


def _patch_wrappers(monkeypatch, make):
    import sys

    for mod in [m for n, m in sys.modules.items()
                if n.startswith("ai_based_frame_interpolation_torch")]:
        for name in WRAPPERS:
            if callable(getattr(mod, name, None)):
                monkeypatch.setattr(mod, name, make(name, getattr(mod, name)))


@pytest.mark.parametrize("name", ["unet", "flow"])
def test_train_step_reaches_no_wrapper_and_eval_reaches_the_kernels(
        cases, name, monkeypatch):
    # a train step with every wrapper made to raise; then an eval step
    # with each counted: the head, the sampler (flow) and the SSIM entry
    case = cases[name]
    ts = case.tstate(ema_decay=0.5)

    def refuse(n, fn):
        def call(*a, **k):
            raise AssertionError(f"the training forward reached {n}")
        return call

    with monkeypatch.context() as mp:
        _patch_wrappers(mp, refuse)
        ts, loss = tl.train_step(ts, _batch(5), case.tloss, ema_decay=0.5)
    assert np.isfinite(float(loss))
    calls = dict.fromkeys(WRAPPERS, 0)

    def count(n, fn):
        def call(*a, **k):
            calls[n] += 1
            return fn(*a, **k)
        return call

    _patch_wrappers(monkeypatch, count)
    m = tl.eval_step(ts, _batch(5), case.tloss, use_ema=True)
    assert np.isfinite(float(m["loss"]))
    assert calls["refine_head"] == 1 and calls["ssim_eval_auto"] == 1
    assert calls["sample_fused"] == (name == "flow")


def test_entry_points_need_a_card_or_cpu(scene_tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    cfg = TTrain(epochs=1)
    mcfg = TConfig(base_width=4, depth=2)
    model = t_build(mcfg, torch.float32)
    save_variables(str(tmp_path / "v"), model.state_dict(), mcfg)
    for call in (lambda: TLoader(scene_tree[0], 2),
                 lambda: Checkpointer(str(tmp_path / "c")),
                 lambda: tl.create_train_state(model, None, cfg),
                 lambda: tl.train_model(model, None, [], [], cfg),
                 lambda: InterpolationEngine.from_checkpoint(
                     str(tmp_path / "v"))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.cuda
def test_wrappers_refuse_grad_on_the_card():
    # on CUDA tensors under grad each wrapper raises for a grad-requiring
    # input or weight (its kernel has no backward); under no_grad it runs
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are CUDA only")
    from ai_based_frame_interpolation_torch.ops.conv_direct import (
        conv_direct, head_out_direct)
    from ai_based_frame_interpolation_torch.ops.dconv_fused import (
        double_conv_fused, up_double_conv_fused)
    from ai_based_frame_interpolation_torch.ops.refine import refine_head
    from ai_based_frame_interpolation_torch.ops.warp_fused import sample_fused

    def cuda(*shape, grad=False):
        return torch.zeros(shape, device="cuda", requires_grad=grad)

    model = t_build(TConfig(**CASES["unet"][0]), torch.bfloat16).cuda()
    y, x = cuda(1, 32, 32, 1), cuda(1, 32, 32, 8)
    w, b = cuda(8, 8, 3, 3, grad=True), cuda(8)
    calls = {
        "refine_head": lambda: refine_head(y, (y, y), model.head_params()),
        "sample_fused": lambda: sample_fused(
            y, y, cuda(1, 32, 32, 2, grad=True), cuda(1, 32, 32, 1),
            cuda(1)),
        "double_conv_fused": lambda: double_conv_fused(x, w, b, w, b),
        "up_double_conv_fused": lambda: up_double_conv_fused(
            x, cuda(1, 16, 16, 8), w, b, w, b),
        "conv_direct": lambda: conv_direct(x, cuda(9, 8, 8, grad=True), b),
        "head_out_direct": lambda: head_out_direct(x, cuda(8, 1, grad=True),
                                                   cuda(1), y)}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}: .*no backward"):
            call()
    with torch.no_grad():
        refine_head(y, (y, y), model.head_params())
