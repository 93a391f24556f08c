"""The port's data parallel (``parallel/``, the trainer over ranks, the
rank-sharded loader, ``cli train --num-devices``, the meshed engine) vs
the port's single-process code and the JAX package's meshes, on the CPU.

Rank processes are spawned twice, over gloo on 127.0.0.1: 4 ranks once
by the command line's launcher (:func:`dp_launch`, module-scoped: every
step-level case at once, the results handed back through files, while
this process computes the single-process and JAX references; then rank
0 fails on purpose), and 2 ranks by ``cli train --num-devices 2``; the
tests read their results. JAX is
imported inside the tests only, so a rank process imports torch and the
port alone. Tiny f32 models, weights drawn from numpy and bridged from
Flax (``models/bridge.py``); each test states its tolerance.
"""

import contextlib
import io
import json
import os
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ai_based_frame_interpolation_torch import cli as t_cli
from ai_based_frame_interpolation_torch.config import (
    LossConfig as TLoss, ModelConfig as TConfig, TrainConfig as TTrain)
from ai_based_frame_interpolation_torch.data.loader import (
    TripletLoader as TLoader)
from ai_based_frame_interpolation_torch.data.synthetic import (
    write_scene_tree)
from ai_based_frame_interpolation_torch.data.triplets import (
    scan_triplets)
from ai_based_frame_interpolation_torch.infer.engine import (
    InterpolationEngine as TEngine)
from ai_based_frame_interpolation_torch.models import build_model as t_build
from ai_based_frame_interpolation_torch.parallel import (
    Mesh, choose_spec, free_port, make_mesh, maybe_init_distributed,
    pad_batch_to_devices, put_frames, shard_items)
from ai_based_frame_interpolation_torch.parallel.mesh import local_device
from ai_based_frame_interpolation_torch.parallel.sharding import (
    replicas_agree)
from ai_based_frame_interpolation_torch.train import loop as tl
from ai_based_frame_interpolation_torch.train.checkpoint import Checkpointer

WORLD = 4
B = 8
HW = (32, 32)
LR = 1e-3
# each family with the loss terms it trains: the U-Net of
# test_torch_train.py, the flow config of test_train.py's sharded flow
# step (the pyramid warp) with both flow terms on
CASES = {
    "unet": (dict(base_width=4, depth=2, space_to_depth=4, residual=True,
                  refine_width=8, upsample="half_pixel"), {}),
    "flow": (dict(arch="flow", base_width=4, refine_width=4,
                  warp_impl="pyramid", max_flow=8),
             dict(flow_smooth_weight=0.1, flow_photo_weight=0.1)),
}
# the steps the 4 ranks take: (family, TrainConfig's step fields)
STEPS = {
    "plain": ("unet", {}),
    "grad_accum_and_ema": ("unet", dict(grad_accum=2, ema_decay=0.9)),
    "flow": ("flow", {}),
}
# the steps also held against JAX's sharded step: the flow family's
# single-process step is held against JAX's in test_torch_train.py (its
# sharded compile alone would take 10 s of this file's 40)
JAX_STEPS = ["plain", "grad_accum_and_ema"]
EVAL_B = 5                    # 4 ranks: parts of 2, 2, 1 + 1 pad, 0 + 2 pads


def _batch(seed=0, n=B, hw=HW):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, 256, (n, *hw, 1), dtype=np.uint8)
            for k in ("f0", "f1", "gt")}


def _nan_batch():
    """``_batch(2)`` with gt as f32 and non-finite on rank 1's items only."""
    batch = dict(_batch(2))
    gt = batch["gt"].astype(np.float32)
    gt[shard_items(B, _rank_mesh(1))[0]] = np.nan
    batch["gt"] = gt
    return batch


def _rank_mesh(rank, world=WORLD):
    """The mesh rank ``rank`` of a ``world``-rank group sees (no group)."""
    return Mesh((torch.device("cpu"),), "data", world, rank, grouped=True)


def _state(weights, family, kw):
    cfg = TTrain(learning_rate=LR, **kw)
    model = t_build(TConfig(**CASES[family][0]), torch.float32)
    model.load_state_dict(weights[family])
    return tl.create_train_state(model, None, cfg, "cpu")


def _step(state, batch, family, kw, mesh=None):
    return tl.train_step(state, batch, TLoss(**CASES[family][1]),
                         ema_decay=kw.get("ema_decay", 0.0),
                         grad_accum=kw.get("grad_accum", 1), mesh=mesh)


def _record(state, loss):
    model = state.model
    return {"loss": float(loss),
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()},
            "stats": {n: b.clone() for n, b in model.named_buffers()
                      if "running" in n},
            "ema": ({n: e.clone() for n, e in state.ema_params.items()}
                    if state.ema_params is not None else None)}


def _shared(state):
    """What must be the same on every rank: parameters, buffers, EMA."""
    out = list(state.model.state_dict().values())
    return out + list((state.ema_params or {}).values())


def _rank_worker(rank, root, port):
    """One of the 4 ranks: every step-level case on its part of the global
    batches; its results to ``<root>/rank<rank>.pt``. Then rank 0 raises
    while the others wait for it at a barrier."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=WORLD, rank=rank)
    try:
        weights = torch.load(os.path.join(root, "weights.pt"))
        mesh = make_mesh(devices=["cpu"] * WORLD)
        assert (mesh.size, mesh.rank, mesh.grouped) == (WORLD, rank, True)
        out = {}
        batch = _batch(1)
        for name, (family, kw) in STEPS.items():
            state = _state(weights, family, kw)
            idx, _ = shard_items(B, mesh, kw.get("grad_accum", 1))
            state, loss = _step(state, {k: v[idx] for k, v in batch.items()},
                                family, kw, mesh)
            out[name] = _record(state, loss)
            out[name]["agree"] = replicas_agree(_shared(state), mesh)

        # a non-finite frame on rank 1 only, after one good step
        state = _state(weights, "unet", {})
        state, _ = _step(state, {k: put_frames(v, mesh)
                                 for k, v in batch.items()}, "unet", {}, mesh)
        before = [t.clone() for t in state.model.state_dict().values()]
        state, loss = _step(state, {k: put_frames(v, mesh) for k, v in
                                    _nan_batch().items()}, "unet", {}, mesh)
        out["nan"] = {"loss": float(loss), "unchanged": all(
            torch.equal(a, b) for a, b in
            zip(before, state.model.state_dict().values())),
            "agree": replicas_agree(_shared(state), mesh)}

        # validation of a global batch the ranks do not divide
        state = _state(weights, "unet", dict(ema_decay=0.5))
        idx, n_valid = shard_items(EVAL_B, mesh)
        part = {k: v[idx] for k, v in _batch(4, n=EVAL_B).items()}
        part["valid"] = torch.arange(len(idx)) < n_valid
        m = tl.eval_step(state, part, TLoss(), use_ema=True, mesh=mesh)
        out["eval"] = {k: float(v) for k, v in m.items()}

        # a checkpoint directory of each rank's own, as on hosts that share
        # no filesystem: rank 0 writes its own, and every rank restores
        # what rank 0 reads there
        own = os.path.join(root, f"ckpt{rank}")
        ckpt = Checkpointer(own, device="cpu")
        ckpt.save(state, epoch=0, history=None, best=True)
        template = _state(weights, "unet", dict(ema_decay=0.5))
        with torch.no_grad():
            for p in template.model.parameters():
                p.zero_()
        got, epoch, _ = ckpt.restore(template, which="best")
        out["ckpt"] = {"has": ckpt.has_checkpoint("latest"),
                       "epoch": epoch, "files": sorted(os.listdir(own)),
                       "same": all(torch.equal(a, b) for a, b in zip(
                           _shared(got), _shared(state)))}
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
        dist.barrier()
        if rank == 0:
            raise RuntimeError("rank 0 fails on purpose")
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def variables():
    """Each family's Flax variables, drawn from numpy."""
    from test_torch_unet import random_variables

    return {f: random_variables(kw, HW, seed=1)
            for f, (kw, _) in CASES.items()}


@pytest.fixture(scope="module")
def weights(variables):
    from ai_based_frame_interpolation_torch.models.bridge import (
        flax_to_state_dict)

    return {f: flax_to_state_dict(v) for f, v in variables.items()}


@pytest.fixture(scope="module")
def dp_launch(weights, tmp_path_factory):
    """The 4 ranks, started through ``cli``'s launcher on a thread: (the
    thread, its [exit code, stderr], the ranks' directory)."""
    root = str(tmp_path_factory.mktemp("ranks"))
    torch.save(weights, os.path.join(root, "weights.pt"))
    result = []

    def launch():
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = t_cli._spawn_workers(_rank_worker, WORLD,
                                      (root, free_port()))
        result.extend([rc, err.getvalue()])

    thread = threading.Thread(target=launch)
    thread.start()
    yield thread, result, root
    thread.join()


@pytest.fixture(scope="module")
def dp_run(dp_launch, single, jax_steps):
    """The 4 ranks' results, a list indexed by rank; the single-process
    and JAX steps run in this process while the ranks run."""
    thread, _, root = dp_launch
    thread.join()
    return [torch.load(os.path.join(root, f"rank{r}.pt"))
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def single(weights):
    """The single-process steps on the same global batch."""
    out = {}
    for name, (family, kw) in STEPS.items():
        state, loss = _step(_state(weights, family, kw), _batch(1), family,
                            kw)
        out[name] = _record(state, loss)
    return out


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


@pytest.mark.parametrize("name", list(STEPS))
def test_dp_step_matches_the_single_process_step(dp_run, single, name):
    # gradients after the all-reduce within 1e-5 of each one's largest
    # value; the loss and the BatchNorm running statistics (global-batch
    # statistics on 4 ranks) within 1e-6 relative
    got, want = dp_run[0][name], single[name]
    assert _rel(got["loss"], want["loss"]) <= 1e-6
    for pname, g in got["grads"].items():
        w = want["grads"][pname].numpy()
        assert np.max(np.abs(g.numpy() - w)) <= 1e-5 * np.max(np.abs(w)), \
            pname
    for bname, s in got["stats"].items():
        assert _rel(s.numpy(), want["stats"][bname].numpy()) <= 1e-6, bname


@pytest.mark.parametrize("name", list(STEPS) + ["nan"])
def test_every_rank_holds_the_same_state(dp_run, name):
    # rank 0's parameters, buffers and EMA on every rank bit for bit (a
    # broadcast of rank 0's, compared on each rank), and the same loss
    assert all(r[name]["agree"] for r in dp_run)
    losses = {r[name]["loss"] for r in dp_run}
    assert len(losses) == 1 or all(np.isnan(x) for x in losses)


def _named(tree, stats):
    """A Flax params-shaped tree under port names, numpy."""
    import jax

    from ai_based_frame_interpolation_torch.models.bridge import (
        flax_to_state_dict)

    sd = flax_to_state_dict({"params": jax.tree.map(np.asarray, tree),
                             "batch_stats": jax.tree.map(np.asarray, stats)})
    return {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def jax_steps(variables):
    """JAX's ``train_step`` on a 4-device CPU mesh, the global batch
    placed with ``batch_sharding`` (tests/test_train.py's recipe)."""
    import jax
    import jax.numpy as jnp

    from ai_based_frame_interpolation_tpu.config import (
        LossConfig as JLoss, ModelConfig as JConfig, TrainConfig as JTrain)
    from ai_based_frame_interpolation_tpu.models import build_model as jb
    from ai_based_frame_interpolation_tpu.parallel.mesh import (
        batch_sharding, make_mesh as j_mesh, replicated)
    from ai_based_frame_interpolation_tpu.train import loop as jl

    mesh = j_mesh(devices=jax.devices("cpu")[:WORLD])
    batch = {k: jax.device_put(v, batch_sharding(mesh))
             for k, v in _batch(1).items()}
    out = {}
    for name in JAX_STEPS:
        family, kw = STEPS[name]
        model = jb(JConfig(**CASES[family][0]), jnp.float32)
        v = jax.tree.map(jnp.asarray, variables[family])
        state = jax.device_put(jl.create_train_state(
            model, v, JTrain(learning_rate=LR, **kw)), replicated(mesh))
        out[name] = jl.train_step(state, batch, JLoss(**CASES[family][1]),
                                  **kw)
    return out


@pytest.mark.parametrize("name", JAX_STEPS)
def test_dp_step_matches_jax_on_a_4_device_mesh(dp_run, jax_steps, variables,
                                                name):
    # test_torch_train.py::test_train_step_matches_optax's tolerances:
    # every parameter within lr of JAX's, and within 1e-6 where JAX's step
    # exceeds lr / (1 + eps / 1e-6) (|g| > 1e-6); BatchNorm statistics
    # within 1e-6 relative; the EMA within a tenth of lr
    family, kw = STEPS[name]
    js, jloss = jax_steps[name]
    got = dp_run[0][name]
    assert abs(got["loss"] - float(jloss)) <= 1e-4 * abs(float(jloss))
    p0 = _named(variables[family]["params"], variables[family]["batch_stats"])
    want = _named(js.params, js.batch_stats)
    ema = _named(js.ema_params, js.batch_stats) if kw else None
    for pname, p in got["params"].items():
        d = np.abs(p.numpy() - want[pname])
        assert d.max() <= LR * (1 + 1e-3), pname
        big = np.abs(want[pname] - p0[pname]) > LR / (1 + 1e-8 / 1e-6)
        assert np.all(d[big] <= 1e-6), pname
        if ema is not None:
            assert np.all(np.abs(got["ema"][pname].numpy() - ema[pname])
                          <= 0.1 * LR * (1 + 1e-3)), pname
    for bname, s in got["stats"].items():
        assert _rel(s.numpy(), want[bname]) <= 1e-6, bname


def test_a_non_finite_frame_on_one_rank_skips_the_step_everywhere(dp_run):
    # the global loss is non-finite on every rank, so every rank skips:
    # parameters and statistics bit for bit as before the step
    for r in dp_run:
        assert not np.isfinite(r["nan"]["loss"])
        assert r["nan"]["unchanged"]


def test_eval_step_over_ranks_equals_the_single_process_one(dp_run, weights):
    # a global batch of 5 on 4 ranks (padded parts, the pads masked out):
    # loss and SSIM within 1e-6, PSNR within 1e-4 dB of eval_step on the
    # whole batch in one process, on every rank
    state = _state(weights, "unet", dict(ema_decay=0.5))
    want = tl.eval_step(state, _batch(4, n=EVAL_B), TLoss(), use_ema=True)
    for r in dp_run:
        got = r["eval"]
        assert abs(got["loss"] - float(want["loss"])) <= 1e-6
        assert abs(got["ssim"] - float(want["ssim"])) <= 1e-6
        assert abs(got["psnr"] - float(want["psnr"])) <= 1e-4


def test_checkpoints_are_read_on_rank_0_and_broadcast(dp_run):
    # each rank's checkpoint directory its own: rank 0 alone wrote (in
    # its own), and every rank restored rank 0's state bit for bit and
    # saw its checkpoint, its own directory empty
    for rank, r in enumerate(dp_run):
        ck = r["ckpt"]
        assert ck["has"] and ck["same"] and ck["epoch"] == 1
        assert ck["files"] == ([] if rank else [
            "best", "best_meta.json", "latest", "latest_meta.json"])


def test_world_size_one_is_bit_for_bit_the_plain_step(weights):
    # a process group of one rank through the distributed code (the
    # all-reduces of the gradients and the loss run) and the step without
    # a mesh: the same parameters, statistics, EMA and loss, bit for bit
    family, kw = STEPS["grad_accum_and_ema"]
    plain, loss_p = _step(_state(weights, family, kw), _batch(1), family, kw)
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(devices=["cpu"])
        assert mesh.grouped and mesh.size == 1
        state, loss = _step(_state(weights, family, kw), _batch(1), family,
                            kw, mesh)
    finally:
        dist.destroy_process_group()
    assert torch.equal(loss, loss_p)
    for t, u in zip(_shared(state), _shared(plain)):
        assert torch.equal(t, u)


@pytest.mark.parametrize("grad_accum, world", [(2, 3), (4, 4)])
def test_a_microbatch_the_ranks_do_not_divide_raises(grad_accum, world):
    # a recorded difference: JAX re-lays such a batch silently
    with pytest.raises(ValueError, match=f"{B // grad_accum} items.*"
                                         f"across {world} ranks"):
        shard_items(B, _rank_mesh(0, world), grad_accum)


def test_shard_items_lays_microbatches_as_jax_reshapes_them():
    # rank r of 4 holds [k m + r m/4, k m + (r+1) m/4) of microbatch k
    parts = [shard_items(16, _rank_mesh(r), 2)[0] for r in range(WORLD)]
    assert [list(p) for p in parts] == [[0, 1, 8, 9], [2, 3, 10, 11],
                                        [4, 5, 12, 13], [6, 7, 14, 15]]
    # the padded case: parts of ceil(5/4) = 2, the pads repeat an item
    got = [shard_items(5, _rank_mesh(r)) for r in range(WORLD)]
    assert [(list(i), n) for i, n in got] == [
        ([0, 1], 2), ([2, 3], 2), ([4, 4], 1), ([4, 4], 0)]
    assert pad_batch_to_devices(5, _rank_mesh(0)) == 8


# -- the loader ---------------------------------------------------------

LOADERS = {
    "shuffled_augmented_remainder": dict(batch_size=8, seed=3, augment=True,
                                         drop_remainder=False),
    "grad_accum_2": dict(batch_size=8, seed=1, grad_accum=2),
    "corrupt_first_item_of_rank_1": dict(batch_size=8, shuffle=False,
                                         drop_remainder=False),
    "corrupt_first_item_of_the_batch": dict(batch_size=8, shuffle=False),
}


@pytest.fixture(scope="module")
def scene_triplets(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("loader_scenes"))
    write_scene_tree(root, num_videos=2, num_frames=11, height=24, width=32,
                     seed=5)
    return scan_triplets(root)


@pytest.mark.parametrize("name", list(LOADERS))
def test_rank_parts_put_together_are_jax_batches(scene_triplets, name,
                                                 tmp_path):
    # 4 ranks' parts of each global batch, put back in shard_items' order
    # (the padding of the last batch dropped by its mask), equal the JAX
    # loader's unsharded batches bit for bit, two epochs; a corrupt file
    # where rank 1's part starts repeats rank 0's last item, one at the
    # batch's start shifts the batch as JAX's does
    from ai_based_frame_interpolation_tpu.data.loader import (
        TripletLoader as JLoader)

    triplets = list(scene_triplets)
    bad_at = {"corrupt_first_item_of_rank_1": B // WORLD,
              "corrupt_first_item_of_the_batch": 0}.get(name)
    if bad_at is not None:
        t = triplets[bad_at]
        bad = tmp_path / "scene_bad"
        bad.mkdir()
        for i in range(3):
            src = os.path.join(t.video_dir, os.path.basename(t.paths()[i]))
            data = open(src, "rb").read()
            (bad / f"frame_{i:03d}.png").write_bytes(
                data[:40] if i == 0 else data)
        triplets[bad_at] = scan_triplets(str(tmp_path))[0]
    kw = dict(LOADERS[name], height=24, width=32, num_workers=2)
    grad_accum = kw.pop("grad_accum", 1)
    ranks = [TLoader(triplets, mesh=_rank_mesh(r), grad_accum=grad_accum,
                     **kw) for r in range(WORLD)]
    jl = JLoader(triplets, **kw)
    assert all(len(t) == len(jl) for t in ranks)
    for _ in range(2):
        want = list(jl)
        got = [list(t) for t in ranks]
        assert all(len(g) == len(want) for g in got)
        for b, w in enumerate(want):
            n = len(w["f0"])
            order = np.concatenate([shard_items(n, _rank_mesh(r),
                                                grad_accum)[0][:nv]
                                    for r in range(WORLD) for nv in
                                    [shard_items(n, _rank_mesh(r),
                                                 grad_accum)[1]]])
            for k in ("f0", "f1", "gt"):
                parts = [g[b][k][:int(g[b]["valid"].sum())] if "valid" in
                         g[b] else g[b][k] for g in got]
                whole = torch.cat(parts).numpy()
                np.testing.assert_array_equal(whole, w[k][order])


# -- the command line ---------------------------------------------------

@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """``cli train`` on 1 and on 2 CPU processes, the same global batch:
    10 triplets, 3 train (batch 2: one step) and 7 val (batches of 2, 2,
    2 and 1, the last a batch the 2 ranks do not divide)."""
    root = tmp_path_factory.mktemp("cli")
    data = str(root / "data")
    write_scene_tree(data, num_videos=2, num_frames=7, height=32, width=32,
                     seed=3)
    runs = {}
    for n in (1, 2):
        ckpt = str(root / f"ckpt{n}")
        rc = t_cli.main(["train", "--data-dir", data, "--epochs", "1",
                         "--batch-size", "2", "--base-width", "4",
                         "--height", "32", "--width", "32",
                         "--checkpoint-dir", ckpt, "--num-workers", "1",
                         "--val-split", "0.7", "--device", "cpu",
                         "--num-devices", str(n)])
        with open(os.path.join(ckpt, "latest_meta.json")) as f:
            runs[n] = (rc, ckpt, json.load(f)["history"])
    return data, runs


def test_cli_train_on_two_processes_matches_one(cli_runs):
    # one step at the default lr 1e-4, then validation (the last val
    # batch padded on rank 1 and masked): train and val loss within 1e-5;
    # the metrics of the uint8 predictions within test_torch_train.py's
    # eval tolerances (PSNR 1e-3 dB, SSIM 2e-4); the same lr history.
    # Adam's first step moves each parameter by +-lr whatever |g|, so the
    # gradient components at f32 noise level (about 3% are under 1e-6
    # here) can take opposite signs in the two summation orders: the
    # parameters agree within lr, not bit for bit, which can move a
    # rounded pixel by 1, and each further step widens the gap in
    # proportion to lr
    _, runs = cli_runs
    (rc1, _, h1), (rc2, _, h2) = runs[1], runs[2]
    assert rc1 == rc2 == 0
    for key, tol in (("train_loss", 1e-5), ("val_loss", 1e-5),
                     ("val_psnr", 1e-3), ("val_ssim", 2e-4)):
        assert len(h1[key]) == len(h2[key]) == 1
        assert abs(h1[key][0] - h2[key][0]) <= tol, key
    assert h1["lr"] == h2["lr"]


def test_cli_train_on_two_processes_exports_once(cli_runs):
    # rank 0 alone writes: the export loads through from_checkpoint, and
    # no temporary file is left from a second writer
    _, runs = cli_runs
    _, ckpt, _ = runs[2]
    assert not [f for f in os.listdir(ckpt) if f.endswith(".tmp")]
    eng = TEngine.from_checkpoint(ckpt, compute_dtype=torch.float32,
                                  device="cpu")
    f = np.zeros((32, 32, 1), np.uint8)
    assert eng.interpolate_pair(f, f).shape == (32, 32, 1)


def test_a_failing_worker_fails_the_command(dp_run, dp_launch):
    # the launcher cmd_train returns from (_spawn_workers): rank 0 raised
    # after the 4 ranks wrote their results, ranks 1-3 waiting for it at
    # a barrier were ended, and the command's code is 1, with rank 0's
    # error
    _, (rc, err), _ = dp_launch
    assert rc == 1
    assert "a training worker failed" in err
    assert "rank 0 fails on purpose" in err


@pytest.mark.parametrize("call", ["local_device", "make_mesh",
                                  "maybe_init_distributed",
                                  "cli_train_under_torchrun"])
def test_without_a_card_nothing_falls_back_to_the_cpu(call, monkeypatch,
                                                      tmp_path):
    # the port's rule for every entry point: the card unless the caller
    # asks for the CPU (devices=["cpu", ...], gloo, --device cpu)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    run = {"local_device": local_device, "make_mesh": make_mesh,
           "maybe_init_distributed": maybe_init_distributed,
           "cli_train_under_torchrun": lambda: t_cli.main([
               "train", "--data-dir", str(tmp_path), "--num-devices",
               "1"])}[call]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
    assert not dist.is_initialized()
    assert make_mesh(devices=["cpu", "cpu"]).size == 2


# -- the engine ---------------------------------------------------------

@pytest.mark.parametrize("batch, height, want", [
    (16, 64, ("data",)), (1, 64, (None, "data")), (3, 65, ())])
def test_choose_spec_equals_jax(batch, height, want):
    import jax

    from ai_based_frame_interpolation_tpu.parallel.mesh import (
        make_mesh as j_mesh)
    from ai_based_frame_interpolation_tpu.parallel.sharding import (
        choose_spec as j_choose)

    mesh = make_mesh(devices=["cpu"] * 8)
    got = choose_spec(batch, height, mesh)
    assert got == want == tuple(j_choose(batch, height, j_mesh(
        devices=jax.devices("cpu"))))


ENGINES = {"unet": dict(base_width=4),
           "flow": dict(arch="flow", base_width=4, flow_scale=2)}


@pytest.fixture(scope="module")
def engines():
    """Per family: the port's meshed engine over two CPU "cards", its
    unmeshed engine, JAX's meshed engine over 2 CPU devices, all f32 on
    the same numpy weights."""
    import jax
    import jax.numpy as jnp

    from ai_based_frame_interpolation_tpu.config import (
        ModelConfig as JConfig)
    from ai_based_frame_interpolation_tpu.infer.engine import (
        InterpolationEngine as JEngine)
    from ai_based_frame_interpolation_tpu.models import build_model as jb
    from ai_based_frame_interpolation_tpu.parallel.mesh import (
        make_mesh as j_mesh)
    from test_torch_unet import random_variables

    out = {}
    for fam, kw in ENGINES.items():
        v = random_variables(kw, (64, 64), seed=2)
        mesh = make_mesh(devices=["cpu", "cpu"])
        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            jeng = JEngine(jb(JConfig(**kw), jnp.float32),
                           jax.device_put(v, cpu), compute_dtype=jnp.float32,
                           mesh=j_mesh(devices=jax.devices("cpu")[:2]))
        tk = dict(compute_dtype=torch.float32, device="cpu")
        out[fam] = (TEngine.from_flax_variables(v, TConfig(**kw), mesh=mesh,
                                                **tk),
                    TEngine.from_flax_variables(v, TConfig(**kw), **tk),
                    jeng)
    return out


@pytest.mark.parametrize("fam", list(ENGINES))
def test_meshed_engine_matches_jax_and_the_unmeshed_one(engines, fam):
    # batch 8 split 4 + 4: within 1 LSB of the unmeshed engine and of
    # JAX's meshed engine (the flow family by test_parallel_infer.py's
    # _assert_flow_close rule); both replicas' heads ran
    from test_parallel_infer import _assert_flow_close

    meshed, plain, jeng = engines[fam]
    assert len(meshed.replicas) == 2
    gen = np.random.default_rng(7)
    f1, f2 = (gen.integers(0, 255, (8, 64, 64, 1), np.uint8)
              for _ in range(2))
    got = meshed.interpolate_batch(f1, f2)
    assert int(np.abs(got.astype(int) - plain.interpolate_batch(
        f1, f2).astype(int)).max()) <= 1
    want = jeng.interpolate_batch(f1, f2)
    if fam == "flow":
        _assert_flow_close(got, want)
    else:
        assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1


@pytest.mark.parametrize("fam", list(ENGINES))
def test_height_split_matches_jax_and_the_unmeshed_one(engines, fam):
    # batch 1 on 2 cards: JAX splits H (test_parallel_infer.py's spatial
    # tests); the port runs each pass over row windows: within 1 LSB of
    # the unmeshed engine and of JAX's (the flow family by
    # _assert_flow_close)
    from test_parallel_infer import _assert_flow_close

    meshed, plain, jeng = engines[fam]
    gen = np.random.default_rng(9)
    f1, f2 = (gen.integers(0, 255, (64, 64, 1), np.uint8) for _ in range(2))
    got = meshed.interpolate_pair(f1, f2)
    assert int(np.abs(got.astype(int) - plain.interpolate_pair(
        f1, f2).astype(int)).max()) <= 1
    want = jeng.interpolate_pair(f1, f2)
    if fam == "flow":
        _assert_flow_close(got, want)
    else:
        assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1


# configs whose windows cut the frame: (config, frame height, windows that
# must be shorter than the padded frame)
SPLITS = {
    # production-shaped at base 8: 1088 rows, 17 units of 64 cut 9/8; the
    # flow config's 512-row halo would make the first window the whole
    # 1088-row frame, so it takes 1216 rows, 19 units cut 10/9
    "unet_prod": (dict(base_width=8, space_to_depth=4, residual=True,
                       refine_width=8, upsample="half_pixel"), 1088, 1),
    "flow_prod": (dict(arch="flow", base_width=8, flow_scale=4,
                       refine_width=16, max_flow=16), 1216, 2),
    # the align-corners decoder: 512 rows, 32 units of 16 cut 16/16
    "align_corners": (dict(base_width=4), 512, 2),
}


def _mesh_pair(kw, **extra):
    """The unmeshed and the 2-part meshed f32 CPU engines on the same
    random weights."""
    tk = dict(compute_dtype=torch.float32, device="cpu", **extra)
    cfg = TConfig(**kw)
    return (TEngine.random_init(cfg, seed=4, **tk),
            TEngine.random_init(cfg, seed=4,
                                mesh=make_mesh(devices=["cpu", "cpu"]), **tk))


@pytest.mark.parametrize("name", list(SPLITS))
def test_height_split_windows_keep_the_whole_frames_rows(name):
    from ai_based_frame_interpolation_torch.parallel.sharding import (
        halo_rows, row_parts)

    kw, h, shorter = SPLITS[name]
    plain, meshed = _mesh_pair(kw)
    cfg = plain.cfg
    parts = row_parts(h, 2, cfg.pad_multiple, halo_rows(cfg))
    assert len(parts) == 2
    assert sum(hi - lo < h for _, _, lo, hi in parts) >= shorter, parts
    gen = np.random.default_rng(10)
    f1, f2 = (gen.integers(0, 255, (1, h, 64, 1), np.uint8)
              for _ in range(2))
    got = meshed.interpolate_batch(f1, f2)
    assert int(np.abs(got.astype(int) - plain.interpolate_batch(
        f1, f2).astype(int)).max()) <= 1


def test_row_parts_cut_at_the_pad_multiple():
    from ai_based_frame_interpolation_torch.parallel.sharding import (
        halo_rows, row_parts)

    # 1080p at the production U-Net's halo: windows of 1024 and 960 rows
    assert halo_rows(TConfig(**SPLITS["unet_prod"][0])) == 448
    assert row_parts(1088, 2, 64, 448) == [(0, 576, 0, 1024),
                                            (576, 1088, 128, 1088)]
    # 4K: 34 units cut 17/17, windows of 1536
    assert row_parts(2176, 2, 64, 448) == [(0, 1088, 0, 1536),
                                            (1088, 2176, 640, 2176)]
    # 1080p at the production flow config's halo: the first window would
    # be the whole frame, so the first card runs it alone
    assert halo_rows(TConfig(**SPLITS["flow_prod"][0])) == 512
    assert row_parts(1088, 2, 64, 512) == [(0, 1088, 0, 1088)]
    # 6 units on 8 parts: the last two do not run; no halo bound: one part
    assert [p[:2] for p in row_parts(96, 8, 16, 16)] == [
        (0, 16), (16, 32), (32, 48), (48, 64), (64, 80), (80, 96)]
    assert row_parts(64, 2, 16, None) == [(0, 64, 0, 64)]
    assert halo_rows(TConfig(arch="flow", warp_impl="gather4")) is None


def test_a_process_groups_mesh_refuses_a_height_split():
    with pytest.raises(ValueError, match="splits the batch"):
        put_frames(np.zeros((1, 64, 8, 1), np.uint8), _rank_mesh(0, 2))


@pytest.mark.parametrize("kind", ["unet_video", "flow_retime",
                                  "tower_stream"])
def test_height_split_streams_match_the_unmeshed_engine(kind):
    # 3 pairs at batch_pairs 2: the batch of 2 pairs splits by batch, the
    # 1-pair tail by height (the tower's 3-frame step by height); 256 rows
    # so the windows cut
    kw = {"unet_video": dict(base_width=4),
          "flow_retime": dict(arch="flow", base_width=4, flow_scale=2),
          "tower_stream": dict(arch="tower", base_width=8)}[kind]
    plain, meshed = _mesh_pair(kw)
    gen = np.random.default_rng(11)
    frames = list(gen.integers(0, 255, (4, 256, 32, 1), np.uint8))

    def run(engine):
        if kind == "flow_retime":
            return list(engine.retime_video_frames(frames, 2.5,
                                                   batch_pairs=2))
        return list(engine.interpolate_video_frames(frames, 2,
                                                    batch_pairs=2))

    got, want = run(meshed), run(plain)
    assert len(got) == len(want) > 4
    assert max(int(np.abs(a.astype(int) - b.astype(int)).max())
               for a, b in zip(got, want)) <= 1


# how far one input row reaches, per config (the perturbed model's
# forward in f32 at 1152x64): the config, then build_model's options and
# whether the U-Net's decoder fuses its upsample (UP_POLYPHASE)
REACH = {
    "unet_prod": (SPLITS["unet_prod"][0], {}, False),
    "flow_prod": (SPLITS["flow_prod"][0], {}, False),
    "flow_bidir_cascade": (dict(SPLITS["flow_prod"][0], flow_bidir=True,
                                flow_cascade=1), {}, False),
    "flow_pyramid": (dict(SPLITS["flow_prod"][0], warp_impl="pyramid"), {},
                     False),
    "align_corners": (dict(base_width=4), {}, False),
    "unet_polyphase": (SPLITS["unet_prod"][0], {}, True),
    "unet_core_pack": (SPLITS["unet_prod"][0], dict(folded=True, pack=2),
                       False),
    "tower": (dict(arch="tower", base_width=8, space_to_depth=4,
                   residual=True, refine_width=8, time_conditioned=True,
                   slim_decoder=True), {}, False),
}


@pytest.mark.parametrize("name", list(REACH))
def test_halo_rows_is_wide_enough(name, monkeypatch):
    # one row of frame 1 moved at three heights: no output row farther
    # than halo_rows from that row's block of pad_multiple rows moves
    from ai_based_frame_interpolation_torch.models import unet as t_unet
    from ai_based_frame_interpolation_torch.parallel.sharding import (
        halo_rows)

    kw, opts, polyphase = REACH[name]
    monkeypatch.setattr(t_unet, "UP_POLYPHASE", polyphase)
    cfg = TConfig(**kw)
    torch.manual_seed(12)
    model = t_build(cfg, torch.float32, **opts).eval()
    if opts.get("pack", 1) > 1:
        # every packed item on the same weights, as the engine's packed core
        model.load_state_dict(t_unet.tile_params_packed(t_build(
            cfg, torch.float32, folded=True).state_dict(), opts["pack"]))
    m, halo = cfg.pad_multiple, halo_rows(cfg)
    gen = np.random.default_rng(12)
    x1, x2 = (torch.from_numpy(gen.uniform(-1, 1, (1, 1, 1152, 64))
                               .astype(np.float32)) for _ in range(2))
    rows = (300, 577, 842)
    a = x1.repeat(4, 1, 1, 1)
    for i, p in enumerate(rows):
        a[i + 1, :, p] += 0.5
    with torch.no_grad():
        y = model(a, x2.repeat(4, 1, 1, 1))
    for i, p in enumerate(rows):
        moved = torch.nonzero((y[i + 1] != y[0]).any(0).any(-1))[:, 0]
        first, last = int(moved.min()), int(moved.max())
        block = p - p % m
        assert block - first <= halo and last - (block + m - 1) <= halo, (
            p, first, last, halo)


def test_the_windowed_align_corners_upsample_is_the_whole_ones():
    # given rows=(first, total), each window's output rows whose taps lie
    # in the window are the whole map's, bit for bit in f32 (ops/resize.py
    # and the option core's channels-last form)
    from ai_based_frame_interpolation_torch.models.core_t import (
        _upsample2x_t)
    from ai_based_frame_interpolation_torch.ops.resize import (
        _align_corners_taps, upsample2x_align_corners)

    gen = np.random.default_rng(13)
    x = torch.from_numpy(gen.standard_normal((2, 3, 64, 12))
                         .astype(np.float32))
    full = upsample2x_align_corners(x)
    full_t = _upsample2x_t(x.permute(0, 2, 3, 1))
    assert torch.equal(upsample2x_align_corners(x, (0, 64)), full)
    lo, hi, _ = _align_corners_taps(64)
    for first, n in ((0, 16), (16, 32), (40, 24), (8, 40)):
        win = x[:, :, first:first + n]
        o = np.arange(2 * first, 2 * (first + n))
        inside = torch.from_numpy((lo[o] >= first) & (hi[o] < first + n))
        assert int(inside.sum()) >= 2 * n - 2
        got = upsample2x_align_corners(win, (first, 64))
        assert torch.equal(got[:, :, inside], full[:, :, o[inside]])
        got_t = _upsample2x_t(win.permute(0, 2, 3, 1), (first, 64))
        assert torch.equal(got_t[:, inside], full_t[:, o[inside]])


def test_meshed_engine_replicates_where_nothing_divides(engines):
    # batch 3 at height 65 on 2 cards: JAX replicates; the first card runs
    # it, the same output as the unmeshed engine
    meshed, plain, _ = engines["unet"]
    gen = np.random.default_rng(8)
    f1, f2 = (gen.integers(0, 255, (3, 65, 48, 1), np.uint8)
              for _ in range(2))
    np.testing.assert_array_equal(meshed.interpolate_batch(f1, f2),
                                  plain.interpolate_batch(f1, f2))
