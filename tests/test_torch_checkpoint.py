"""The port's checkpoints (`moco_tpu_torch/checkpoint.py`) against the JAX
package's on the CPU: the reference-dialect export read in both directions
bit for bit, the backbone features of a JAX export, the dialect table and
the surgery's refusals, full-state save and restore bit for bit, a resumed
tiny pretrain against an uninterrupted one, the walk-back past a step that
fails its manifest, and the sidecar layout both packages share."""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu import checkpoint as jckpt
from moco_tpu.models import build_backbone as jbuild_backbone
from moco_tpu.models import resnet as jresnet
from moco_tpu.resilience import integrity as jintegrity
from moco_tpu_torch import checkpoint as ckpt
from moco_tpu_torch import train
from moco_tpu_torch.config import get_preset
from moco_tpu_torch.models import build_backbone, resnet
from moco_tpu_torch.resilience import integrity
from moco_tpu_torch.train_state import create_train_state
from moco_tpu_torch.train_step import build_encoder, build_train_step
from moco_tpu_torch.weights import params_from_jax

TINY = dict(arch="resnet_tiny", image_size=32, batch_size=8, num_negatives=32, embed_dim=16,
            compute_dtype="float32", print_freq=1, dataset="synthetic")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_encoder(kind):
    """A flax encoder and its (params, batch_stats) with non-trivial BN
    statistics: a tiny Bottleneck ResNet with the v2 MLP head, or
    `resnet_tiny` (BasicBlocks) with a plain fc head."""
    if kind == "bottleneck_mlp":
        model = jresnet.ResNet(stage_sizes=(1, 1), block_cls=jresnet.Bottleneck, width=8,
                               num_classes=16, mlp_head=True)
    else:
        model = jresnet.ResNetTiny(num_classes=16)
    images = jnp.asarray(np.random.RandomState(1).rand(4, 32, 32, 3).astype(np.float32))
    variables = model.init(jax.random.key(0), images[:1], train=False)
    # one train-mode forward moves the running statistics off their init
    _, mut = model.apply(variables, images, train=True, mutable=["batch_stats"])
    return model, _np_tree(variables["params"]), _np_tree(mut["batch_stats"])


def _port_encoder(kind, params, stats):
    if kind == "bottleneck_mlp":
        model = resnet.ResNet((1, 1), resnet.Bottleneck, width=8, num_classes=16,
                              mlp_head=True)
    else:
        model = resnet.build_resnet("resnet_tiny", num_classes=16)
    model.load_state_dict(params_from_jax(params, stats), strict=True)
    return model


def _assert_trees_equal(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = jax.tree_util.tree_leaves_with_path(b)
    assert [jax.tree_util.keystr(p) for p, _ in la] == [jax.tree_util.keystr(p) for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert np.asarray(x).dtype == np.asarray(y).dtype, jax.tree_util.keystr(p)
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=jax.tree_util.keystr(p))


@pytest.mark.parametrize("kind", ["bottleneck_mlp", "tiny_basic"])
def test_port_export_equals_jax_export_key_for_key(kind, tmp_path):
    """The same weights exported by each package: the same names, dtypes
    and bits (so the same `.npz`)."""
    _model, params, stats = _jax_encoder(kind)
    jflat = jckpt.export_encoder_q(types.SimpleNamespace(params_q=params, batch_stats_q=stats),
                                   str(tmp_path / "jax.npz"))
    state = types.SimpleNamespace(model_q=_port_encoder(kind, params, stats))
    flat = ckpt.export_encoder_q(state, str(tmp_path / "port.npz"))
    assert sorted(flat) == sorted(jflat)
    on_disk = dict(np.load(tmp_path / "port.npz"))
    for key, ref in jflat.items():
        assert flat[key].dtype == ref.dtype == on_disk[key].dtype, key
        np.testing.assert_array_equal(flat[key], ref, err_msg=key)
        np.testing.assert_array_equal(on_disk[key], ref, err_msg=key)


@pytest.mark.parametrize("kind", ["bottleneck_mlp", "tiny_basic"])
def test_port_export_read_by_jax_gives_the_same_trees(kind, tmp_path):
    """The JAX package's `load_pretrained_backbone` of the port's export:
    the original flax backbone trees bit for bit, the head dropped."""
    _model, params, stats = _jax_encoder(kind)
    path = str(tmp_path / "port.npz")
    ckpt.export_encoder_q(types.SimpleNamespace(model_q=_port_encoder(kind, params, stats)),
                          path)
    got_params, got_stats = jckpt.load_pretrained_backbone(path)
    backbone = {k: v for k, v in params.items() if not k.startswith("fc")}
    _assert_trees_equal(got_params, backbone)
    _assert_trees_equal(got_stats, stats)


def test_jax_export_gives_the_jax_backbone_features(tmp_path):
    """A JAX export of `resnet_tiny`, loaded by the port's surgery: pooled
    eval-mode features equal the JAX backbone's on the same images (f32
    convs summed in another order: within 1e-4)."""
    _model, params, stats = _jax_encoder("tiny_basic")
    path = str(tmp_path / "jax.npz")
    jckpt.export_encoder_q(types.SimpleNamespace(params_q=params, batch_stats_q=stats), path)
    images = np.random.RandomState(2).randn(6, 32, 32, 3).astype(np.float32)
    jmodel = jbuild_backbone("resnet_tiny")
    backbone = {k: v for k, v in params.items() if not k.startswith("fc")}
    ref = jmodel.apply({"params": backbone, "batch_stats": stats}, jnp.asarray(images),
                       train=False)
    model = ckpt.load_for_inference(path, "resnet_tiny", device="cpu")
    assert not model.training and not any(p.requires_grad for p in model.parameters())
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    assert got.shape == ref.shape == (6, model.feature_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_detect_dialect_and_surgery_refusals(tmp_path):
    _model, params, stats = _jax_encoder("tiny_basic")
    state = types.SimpleNamespace(model_q=_port_encoder("tiny_basic", params, stats))
    path = str(tmp_path / "tiny.npz")
    flat = ckpt.export_encoder_q(state, path)
    assert ckpt.detect_dialect(flat) == jckpt.detect_dialect(flat) == "torchvision_encoder_q"
    tree = {"backbone/conv1/kernel": np.zeros(1)}
    assert ckpt.detect_dialect(tree) == jckpt.detect_dialect(tree) == "v3_tree"
    timm = {"patch_embed.proj.weight": np.zeros(1)}
    assert ckpt.detect_dialect(timm) == "timm_vit"
    with pytest.raises(ValueError, match="no known dialect"):
        ckpt.detect_dialect({"weights": np.zeros(1)})
    # a wrong arch: the surgery names what is missing and what is extra
    with pytest.raises(ValueError, match=r"surgery mismatch for arch 'resnet18': "
                                         r"missing \[.*layer1_1.*\], extra \[\]"):
        ckpt.load_for_inference(path, "resnet18", device="cpu")
    # a wrong width of the right names fails the strict load
    wide = dict(flat, **{"module.encoder_q.conv1.weight": np.zeros((8, 3, 7, 7), np.float32)})
    np.savez(tmp_path / "wide.npz", **wide)
    with pytest.raises(RuntimeError, match="size mismatch"):
        ckpt.load_for_inference(str(tmp_path / "wide.npz"), "resnet_tiny", device="cpu")
    np.savez(tmp_path / "timm.npz", **timm)
    # the timm dialect is read by `timm_to_vit` (the ViT is ported): a file
    # without the ViT's entries fails on the first one it needs
    with pytest.raises(KeyError, match="cls_token"):
        ckpt.load_pretrained_backbone(str(tmp_path / "timm.npz"))


def test_backbone_tree_dialect_round_trips_with_jax(tmp_path):
    """`backbone/` exports: the port's reads back as the same state, and
    the JAX package reads it as the flax trees."""
    _model, params, stats = _jax_encoder("bottleneck_mlp")
    backbone = {k: v for k, v in params.items() if not k.startswith("fc")}
    sd = params_from_jax(backbone, stats)
    path = str(tmp_path / "tree.npz")
    ckpt.export_backbone_tree(sd, path)
    got = ckpt.load_pretrained_backbone(path)
    assert got.keys() == sd.keys() and all(torch.equal(got[k], sd[k]) for k in sd)
    jparams, jstats = jckpt.load_pretrained_backbone(path)
    _assert_trees_equal(jparams, backbone)
    _assert_trees_equal(jstats, stats)


def test_safetensors_export_and_its_missing_package(tmp_path, monkeypatch):
    _model, params, stats = _jax_encoder("tiny_basic")
    state = types.SimpleNamespace(model_q=_port_encoder("tiny_basic", params, stats))
    path = str(tmp_path / "enc.safetensors")
    flat = ckpt.export_encoder_q(state, path)
    back = ckpt.import_encoder_q(path)
    assert back.keys() == flat.keys() and all(np.array_equal(back[k], flat[k]) for k in flat)
    # without the package: an error that says so, and no file in its place
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.numpy", None)
    other = str(tmp_path / "other.safetensors")
    with pytest.raises(ImportError, match="needs the `safetensors` package"):
        ckpt.export_encoder_q(state, other)
    assert not os.path.exists(other) and not os.path.exists(other + ".npz")
    with pytest.raises(ImportError, match="needs the `safetensors` package"):
        ckpt.import_encoder_q(path)


# ---------------------------------------------------------------------------
# full state
# ---------------------------------------------------------------------------


def _stepped_state(seed=0, steps=1):
    """A tiny state after `steps` steps on the CPU: momentum buffers exist,
    the queue and both generators have moved."""
    config = get_preset("imagenet-moco-v2").replace(**TINY)
    state = create_train_state(config, build_encoder(config), "cpu", seed=seed)
    step = build_train_step(config, steps_per_epoch=4)
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        im = torch.from_numpy(rng.randn(2, 8, 32, 32, 3).astype(np.float32))
        step(state, im[0], im[1])
        torch.rand(3, generator=state.data_generator)
    return config, state


def _assert_states_equal(a, b):
    for name in ("model_q", "model_k"):
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), f"{name}.{k}"
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys() and oa["state"]
    for i in oa["state"]:
        assert torch.equal(oa["state"][i]["momentum_buffer"], ob["state"][i]["momentum_buffer"])
    assert torch.equal(a.queue, b.queue)
    assert (a.step, a.queue_ptr) == (b.step, b.queue_ptr)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert torch.equal(a.data_generator.get_state(), b.data_generator.get_state())


def test_full_state_round_trip_is_bit_exact(tmp_path):
    config, state = _stepped_state(seed=0, steps=2)
    mgr = ckpt.checkpoint_manager(str(tmp_path))
    ckpt.save_checkpoint(mgr, state, state.step, position=(0, 2))
    assert mgr.all_steps() == [2] and integrity.verify_step(str(tmp_path), 2) is None
    _, fresh = _stepped_state(seed=5, steps=1)
    restored = ckpt.restore_checkpoint(mgr, fresh)
    assert restored is fresh
    _assert_states_equal(restored, state)
    # both restored generators draw what the saved ones draw next
    assert torch.equal(torch.rand(4, generator=restored.generator),
                       torch.rand(4, generator=state.generator))
    assert torch.equal(torch.rand(4, generator=restored.data_generator),
                       torch.rand(4, generator=state.data_generator))
    assert ckpt.read_position(str(tmp_path), 2) == (0, 2)


@pytest.mark.parametrize("steps_per_epoch", [2, 3])
def test_resumed_pretrain_equals_an_uninterrupted_one(steps_per_epoch, tmp_path):
    """4 steps in one run against 2 steps, a checkpoint, and a resumed run
    to step 4: the same losses of steps 3-4 and the same final state, bit
    for bit. At 3 steps an epoch the checkpoint falls mid-epoch, and the
    resumed epoch skips the 2 batches it already used."""
    config = get_preset("imagenet-moco-v2").replace(**TINY, steps_per_epoch=steps_per_epoch)
    quiet = dict(device="cpu", on_step=lambda *a: None)
    full, full_hist = train.train(config.replace(ckpt_dir=str(tmp_path / "a")), max_steps=4,
                                  **quiet)
    cut = config.replace(ckpt_dir=str(tmp_path / "b"))
    first, _ = train.train(cut, max_steps=2, **quiet)
    assert first.step == 2 and ckpt.read_position(str(tmp_path / "b"), 2) == (
        (1, 0) if steps_per_epoch == 2 else (0, 2))
    resumed, hist = train.train(cut.replace(resume="auto"), max_steps=4, **quiet)
    assert [h["loss"] for h in hist] == [h["loss"] for h in full_hist[2:]]
    _assert_states_equal(resumed, full)


def test_resume_auto_without_a_checkpoint_starts_fresh(tmp_path):
    config = get_preset("imagenet-moco-v2").replace(**TINY)
    quiet = dict(device="cpu", on_step=lambda *a: None)
    _, fresh = train.train(config, max_steps=2, **quiet)
    state, auto = train.train(config.replace(ckpt_dir=str(tmp_path), resume="auto"),
                              max_steps=2, **quiet)
    assert [h["loss"] for h in auto] == [h["loss"] for h in fresh]
    assert state.step == 2 and ckpt.checkpoint_manager(str(tmp_path)).all_steps() == [2]


def test_resume_forms_step_and_path(tmp_path):
    config, state = _stepped_state(steps=1)
    mgr = ckpt.checkpoint_manager(str(tmp_path))
    ckpt.save_checkpoint(mgr, state, 1)
    _, later = _stepped_state(steps=3)
    ckpt.save_checkpoint(mgr, later, 3)
    _, target = _stepped_state(seed=7, steps=0)
    assert ckpt.maybe_resume(mgr, target, "") is target and target.step == 0
    _assert_states_equal(ckpt.maybe_resume(mgr, target, "1"), state)
    _assert_states_equal(ckpt.maybe_resume(None, target, str(tmp_path / "3")), later)
    _assert_states_equal(ckpt.maybe_resume(mgr, target, "auto"), later)
    with pytest.raises(ValueError, match="step directory"):
        ckpt.maybe_resume(mgr, target, str(tmp_path / "latest"))
    with pytest.raises(ValueError, match="needs a checkpoint directory"):
        ckpt.maybe_resume(None, target, "auto")


def test_walk_back_past_a_step_that_fails_its_manifest(tmp_path, capsys):
    """Newest first: step 3's file no longer matches its manifest and step
    2's is torn with no manifest; `auto` restores step 1. An explicit step
    3 fails hard."""
    mgr = ckpt.checkpoint_manager(str(tmp_path))
    states = {}
    for s in (1, 2, 3):
        _, states[s] = _stepped_state(steps=s)
        ckpt.save_checkpoint(mgr, states[s], s)
    with open(os.path.join(mgr.step_dir(3), ckpt.STATE_FILE), "r+b") as f:
        f.seek(100)
        byte = f.read(1)
        f.seek(100)
        f.write(bytes([byte[0] ^ 0xFF]))
    assert "digest mismatch" in integrity.verify_step(str(tmp_path), 3)
    assert "digest mismatch" in jintegrity.verify_step(str(tmp_path), 3)
    os.remove(integrity.manifest_path(str(tmp_path), 2))
    path2 = os.path.join(mgr.step_dir(2), ckpt.STATE_FILE)
    os.truncate(path2, os.path.getsize(path2) // 2)
    _, target = _stepped_state(seed=9)
    restored = ckpt.maybe_resume(mgr, target, "auto")
    _assert_states_equal(restored, states[1])
    err = capsys.readouterr().err
    assert "step 3 fails (digest mismatch" in err and "restored OLDER step 1" in err
    with pytest.raises(Exception):
        ckpt.restore_checkpoint(mgr, target, 3)
    for s in (1, 2):
        os.remove(os.path.join(mgr.step_dir(s), ckpt.STATE_FILE))
    with pytest.raises(FileNotFoundError, match="no restorable checkpoint"):
        ckpt.restore_checkpoint(mgr, target)


def test_max_to_keep_prunes_steps_and_their_sidecars(tmp_path):
    _, state = _stepped_state()
    mgr = ckpt.checkpoint_manager(str(tmp_path), max_to_keep=3)
    for s in range(1, 6):
        ckpt.save_checkpoint(mgr, state, s, position=(s, 0))
    assert mgr.all_steps() == [3, 4, 5]
    assert sorted(os.listdir(tmp_path / ".integrity")) == ["3.json", "4.json", "5.json"]
    assert sorted(os.listdir(tmp_path / ".position")) == ["3.json", "4.json", "5.json"]
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp")]


def test_sidecar_layout_is_the_jax_packages(tmp_path):
    """The same paths, and each package reads what the other wrote."""
    d = str(tmp_path)
    assert integrity.position_path(d, 7) == jintegrity.position_path(d, 7)
    assert integrity.manifest_path(d, 7) == jintegrity.manifest_path(d, 7)
    jckpt.write_position(d, 7, (2, 5))
    assert ckpt.read_position(d, 7) == (2, 5)
    ckpt.write_position(d, 8, (3, 1))
    assert jckpt.read_position(d, 8) == (3, 1)
    os.makedirs(tmp_path / "7")
    (tmp_path / "7" / "a.bin").write_bytes(b"abc")
    assert integrity.write_manifest(d, 7) == jintegrity.write_manifest(d, 7)
    assert integrity.verify_step(d, 7) is None and jintegrity.verify_step(d, 7) is None
    assert integrity.digest_file(str(tmp_path / "7" / "a.bin")) == \
        jintegrity.digest_file(str(tmp_path / "7" / "a.bin"))


def test_train_exports_the_encoder_it_trained(tmp_path):
    config = get_preset("imagenet-moco-v2").replace(**TINY, export_path=str(tmp_path / "e.npz"))
    state, _ = train.train(config, max_steps=1, device="cpu", on_step=lambda *a: None)
    flat = ckpt.import_encoder_q(str(tmp_path / "e.npz"))
    assert ckpt.detect_dialect(flat) == "torchvision_encoder_q"
    sd = state.model_q.state_dict()
    np.testing.assert_array_equal(flat["module.encoder_q.layer2.0.downsample.0.weight"],
                                  sd["layer2_0.downsample_conv.weight"].numpy())
    np.testing.assert_array_equal(flat["module.encoder_q.fc.2.bias"], sd["fc.bias"].numpy())
    model = ckpt.load_for_inference(str(tmp_path / "e.npz"), "resnet_tiny", device="cpu")
    backbone = build_backbone("resnet_tiny").state_dict()
    assert model.state_dict().keys() == backbone.keys()
