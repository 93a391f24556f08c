"""The reference's ``.pth`` import and export of the port against the JAX
package's (``train/checkpoint.py``), on the CPU.

The state dicts follow the reference's key schema
(``unet.inc.double_conv.0.weight`` ...) at base width 4, every array drawn
from a seeded numpy generator. Tolerances:

- the imported model's uint8 frames against the JAX engine on the JAX
  import of the same dict, both in f32: 1 LSB (the repo's cross-program
  tolerance; f32 convolutions summed in another order);
- the export, against JAX's ``export_state_dict`` on the same (bridged)
  weights, and every array that crosses between the two programs in a
  ``.pth``: bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_based_frame_interpolation_torch.config import ModelConfig as TConfig
from ai_based_frame_interpolation_torch.infer.engine import (
    InterpolationEngine as TEngine)
from ai_based_frame_interpolation_torch.models import build_model as t_build
from ai_based_frame_interpolation_torch.models.bridge import flax_to_state_dict
from ai_based_frame_interpolation_torch.train import checkpoint as t_ckpt
from ai_based_frame_interpolation_tpu.config import ModelConfig as JConfig
from ai_based_frame_interpolation_tpu.infer.engine import (
    InterpolationEngine as JEngine)
from ai_based_frame_interpolation_tpu.models import build_model as j_build
from ai_based_frame_interpolation_tpu.train import checkpoint as j_ckpt
from test_torch_unet import random_variables

BASE = 4
HW = (32, 32)


def reference_state_dict(seed, bilinear=True, base=BASE, channels=1):
    """A reference-format U-Net state dict (depth 4) of numpy arrays, with
    the reference's ``num_batches_tracked``."""
    gen = np.random.default_rng(seed)
    sd = {}

    def conv(key, cout, cin, k=3):
        sd[key] = (gen.standard_normal((cout, cin, k, k))
                   / np.sqrt(k * k * cin)).astype(np.float32)

    def double_conv(prefix, cin, mid, cout):
        conv(f"{prefix}.0.weight", mid, cin)
        conv(f"{prefix}.3.weight", cout, mid)
        for idx, ch in ((1, mid), (4, cout)):
            sd[f"{prefix}.{idx}.weight"] = gen.uniform(0.6, 1.4, ch).astype(
                np.float32)
            sd[f"{prefix}.{idx}.bias"] = (0.05 * gen.standard_normal(ch)
                                          ).astype(np.float32)
            sd[f"{prefix}.{idx}.running_mean"] = (
                0.05 * gen.standard_normal(ch)).astype(np.float32)
            sd[f"{prefix}.{idx}.running_var"] = gen.uniform(
                0.5, 1.5, ch).astype(np.float32)
            sd[f"{prefix}.{idx}.num_batches_tracked"] = np.array(10)

    b = base
    bottom = 8 * b if bilinear else 16 * b
    double_conv("unet.inc.double_conv", 2 * channels, b, b)
    for k, (cin, cout) in enumerate(
            [(b, 2 * b), (2 * b, 4 * b), (4 * b, 8 * b), (8 * b, bottom)], 1):
        double_conv(f"unet.down{k}.maxpool_conv.1.double_conv", cin, cout,
                    cout)
    if bilinear:
        for k, (cin, mid, cout) in enumerate(
                [(16 * b, 8 * b, 4 * b), (8 * b, 4 * b, 2 * b),
                 (4 * b, 2 * b, b), (2 * b, b, b)], 1):
            double_conv(f"unet.up{k}.conv.double_conv", cin, mid, cout)
    else:
        for k, (cin, cout) in enumerate(
                [(16 * b, 8 * b), (8 * b, 4 * b), (4 * b, 2 * b),
                 (2 * b, b)], 1):
            sd[f"unet.up{k}.up.weight"] = (gen.standard_normal(
                (cin, cin // 2, 2, 2)) / np.sqrt(4 * cin)).astype(np.float32)
            sd[f"unet.up{k}.up.bias"] = (0.05 * gen.standard_normal(
                cin // 2)).astype(np.float32)
            double_conv(f"unet.up{k}.conv.double_conv", cin, cout, cout)
    conv("unet.outc.conv.weight", channels, b, k=1)
    sd["unet.outc.conv.bias"] = (0.05 * gen.standard_normal(channels)
                                 ).astype(np.float32)
    return sd


def _arrays(sd):
    return {k: v for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def _u8_pair(seed, n=2):
    gen = np.random.default_rng(seed)
    return [gen.integers(0, 256, (n, *HW, 1), dtype=np.uint8)
            for _ in range(2)]


def _save_reference(path, sd, wrapped=True):
    tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    torch.save({"epoch": 3, "model_state_dict": tensors, "train_loss": 0.1,
                "val_loss": 0.2} if wrapped else tensors, path)
    return path


@pytest.mark.parametrize("bilinear", [True, False])
def test_import_runs_the_jax_import(bilinear):
    sd = reference_state_dict(1, bilinear)
    kw = dict(base_width=BASE, bilinear=bilinear)
    variables = j_ckpt.import_state_dict(_arrays(sd), JConfig(**kw))
    jeng = JEngine(j_build(JConfig(**kw), jnp.float32), variables,
                   compute_dtype=jnp.float32)
    state = t_ckpt.import_state_dict(_arrays(sd), TConfig(**kw))
    teng = TEngine(t_build(TConfig(**kw), torch.float32), state,
                   compute_dtype=torch.float32, device="cpu")
    f1, f2 = _u8_pair(2)
    got, want = teng.interpolate_batch(f1, f2), jeng.interpolate_batch(f1, f2)
    assert got.shape == want.shape == f1.shape
    assert np.max(np.abs(got.astype(int) - want.astype(int))) <= 1
    # the import's bilinear inference, as JAX's, and the config it implies
    inferred = t_ckpt.import_state_dict(_arrays(sd))
    assert inferred.keys() == state.keys() and all(
        torch.equal(inferred[k], state[k]) for k in state)
    assert t_ckpt.pth_config(state) == TConfig(**kw)


@pytest.mark.parametrize("bilinear", [True, False])
def test_export_state_dict_equals_jax_bit_for_bit(bilinear):
    kw = dict(base_width=BASE, bilinear=bilinear)
    variables = random_variables(kw, HW, seed=3)
    want = j_ckpt.export_state_dict(variables, JConfig(**kw))
    got = t_ckpt.export_state_dict(flax_to_state_dict(variables),
                                   TConfig(**kw))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        assert np.array_equal(got[k], np.asarray(want[k])), k
    # and the import inverts it
    back = t_ckpt.import_state_dict(got, TConfig(**kw))
    bridged = flax_to_state_dict(variables)
    assert back.keys() == bridged.keys() and all(
        torch.equal(back[k], bridged[k]) for k in back)


def test_export_refuses_weights_the_reference_has_no_place_for():
    model = t_build(TConfig(base_width=BASE, space_to_depth=2,
                            refine_width=8))
    with pytest.raises(ValueError, match="no place for"):
        t_ckpt.export_state_dict(model.state_dict(),
                                 TConfig(base_width=BASE, space_to_depth=2,
                                         refine_width=8))


def test_a_pth_of_either_program_loads_in_the_other(tmp_path):
    kw = dict(base_width=BASE)
    variables = random_variables(kw, HW, seed=4)
    state = flax_to_state_dict(variables)
    # JAX writes, the port reads
    j_path = j_ckpt.export_pth(str(tmp_path / "jax.pth"), variables,
                               JConfig(**kw), epoch=5)
    got = t_ckpt.import_pth(j_path)
    assert got.keys() == state.keys() and all(
        torch.equal(got[k], state[k]) for k in state)
    # the port writes, JAX reads
    t_path = t_ckpt.export_pth(str(tmp_path / "port.pth"), state,
                               TConfig(**kw), epoch=5, val_loss=0.25)
    back = j_ckpt.import_pth(t_path, JConfig(**kw))
    flat_j = flax_to_state_dict(back)
    assert flat_j.keys() == state.keys() and all(
        torch.equal(flat_j[k], state[k]) for k in state)
    raw_t = torch.load(t_path, weights_only=False)
    raw_j = torch.load(j_path, weights_only=False)
    assert {k: raw_t[k] for k in ("epoch", "train_loss")} == \
        {k: raw_j[k] for k in ("epoch", "train_loss")}
    assert raw_t["val_loss"] == 0.25
    assert list(raw_t["model_state_dict"]) == list(raw_j["model_state_dict"])
    for k, v in raw_j["model_state_dict"].items():
        assert torch.equal(raw_t["model_state_dict"][k], v), k


@pytest.mark.parametrize("wrapped", [True, False])
def test_from_checkpoint_on_a_pth(tmp_path, wrapped):
    sd = reference_state_dict(5, bilinear=not wrapped)
    path = _save_reference(str(tmp_path / "best_model.pth"), sd, wrapped)
    eng = TEngine.from_checkpoint(path, compute_dtype=torch.float32,
                                  device="cpu")
    # no config: the reference's, with the weights' width and decoder
    assert eng.cfg == TConfig(base_width=BASE, bilinear=not wrapped)
    ref = TEngine(t_build(eng.cfg, torch.float32),
                  t_ckpt.import_state_dict(_arrays(sd), eng.cfg),
                  compute_dtype=torch.float32, device="cpu")
    f1, f2 = _u8_pair(6)
    assert np.array_equal(eng.interpolate_batch(f1, f2),
                          ref.interpolate_batch(f1, f2))
    # a given config wins; the JAX engine runs the same file to 1 LSB
    jcfg = JConfig(base_width=BASE, bilinear=not wrapped)
    jeng = JEngine.from_checkpoint(path, jcfg, compute_dtype=jnp.float32)
    got = TEngine.from_checkpoint(path, TConfig(**jcfg.__dict__),
                                  compute_dtype=torch.float32, device="cpu")
    diff = np.abs(got.interpolate_batch(f1, f2).astype(int)
                  - jeng.interpolate_batch(f1, f2).astype(int))
    assert diff.max() <= 1
    with pytest.raises(FileNotFoundError):
        TEngine.from_checkpoint(str(tmp_path / "missing.pth"), device="cpu")
