"""The port's evaluation path against the JAX package's on the CPU: the eval
transform, `stage_eval_batch`, `encode_dataset` on carried-over weights,
the linear probe's train step and `validate`, the kNN monitor and its
split; and the probe's own guarantees: `sanity_check` against the file on
disk, epoch-granular resume, `--evaluate`, and no quiet CPU fallback."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from moco_tpu import config as jconfig
from moco_tpu import train as jtrain
from moco_tpu.data import augment as jaug
from moco_tpu.data import datasets as jdatasets
from moco_tpu.data import loader as jloader
from moco_tpu.evals import knn as jknn_eval
from moco_tpu.evals import lincls as jlincls
from moco_tpu.models import build_backbone as jbuild_backbone
from moco_tpu_torch import checkpoint as ckpt
from moco_tpu_torch import train
from moco_tpu_torch.config import EvalConfig, get_preset
from moco_tpu_torch.data import augment as aug
from moco_tpu_torch.data import datasets
from moco_tpu_torch.data.loader import stage_eval_batch
from moco_tpu_torch.evals import knn as knn_eval
from moco_tpu_torch.evals import lincls
from moco_tpu_torch.models import build_backbone
from moco_tpu_torch.weights import params_from_jax

# f32 transforms in the same op order; matmul sums in another order: ~1e-6
TOL = dict(rtol=1e-5, atol=2e-6)
# f32 ResNet forwards, the same weights, sums in another order
FEAT_TOL = dict(rtol=1e-4, atol=1e-5)


def _extents_batch(seed, b=6, h=40, w=48):
    """uint8 canvases whose content fills per-sample extents, some
    portrait images staged transposed (rot = 1)."""
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    ext = np.stack([rng.randint(20, h + 1, b), rng.randint(20, w + 1, b),
                    np.arange(b) % 2], axis=1).astype(np.int32)
    return imgs, ext


@pytest.mark.parametrize("crop_frac", [0.875, 1.0])
def test_eval_transform_matches_jax(crop_frac):
    imgs, ext = _extents_batch(0)
    cfg_j = jaug.eval_aug_config(16, crop_frac=crop_frac)
    ref = jaug.augment_batch(jnp.asarray(imgs), jax.random.key(0), cfg_j, jnp.asarray(ext))
    cfg = aug.eval_aug_config(16, crop_frac=crop_frac)
    assert cfg.deterministic and cfg.crop_frac == crop_frac
    got = aug.augment_batch(torch.from_numpy(imgs), None, cfg, torch.from_numpy(ext))
    assert got.shape == (6, 16, 16, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    full = aug.augment_batch(torch.from_numpy(imgs), None, cfg)  # no extents: the canvas
    ref_full = jaug.augment_batch(jnp.asarray(imgs), jax.random.key(0), cfg_j)
    np.testing.assert_allclose(full.numpy(), np.asarray(ref_full), **TOL)


def test_default_eval_crop_frac_and_probe_train_transform():
    for size in (32, 95, 96, 224):
        assert aug.default_eval_crop_frac(size) == jaug.default_eval_crop_frac(size)
    cfg = lincls.train_aug_config(32)
    imgs, ext = _extents_batch(1)
    gen = torch.Generator().manual_seed(3)
    out = aug.augment_batch(torch.from_numpy(imgs), gen, cfg, torch.from_numpy(ext))
    again = aug.augment_batch(torch.from_numpy(imgs), torch.Generator().manual_seed(3), cfg,
                              torch.from_numpy(ext))
    assert out.shape == (6, 32, 32, 3) and torch.equal(out, again)
    assert (cfg.min_scale, cfg.jitter_prob, cfg.grayscale_prob, cfg.blur_prob,
            cfg.flip_prob) == (0.08, 0.0, 0.0, 0.0, 0.5)


@pytest.mark.parametrize("pad_label", [None, -1])
def test_stage_eval_batch_pads_like_jax(pad_label):
    imgs, ext = _extents_batch(2, b=5)
    labels = np.arange(5, dtype=np.int32)
    ref = jloader.stage_eval_batch((imgs, labels, ext), 8, None, pad_label=pad_label)
    got = stage_eval_batch((imgs, labels, ext), 8, "cpu", pad_label=pad_label)
    assert got[0].shape == (8, 40, 48, 3) and got[1].dtype == torch.int64
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert len(got[1]) == (8 if pad_label is not None else 5)


@pytest.fixture(scope="module")
def tiny_backbone():
    """`resnet_tiny` in flax (random weights, BN statistics moved by one
    train-mode forward) and the same weights in the port's backbone."""
    jmodel = jbuild_backbone("resnet_tiny")
    images = jnp.asarray(np.random.RandomState(4).rand(8, 32, 32, 3).astype(np.float32))
    variables = jmodel.init(jax.random.key(1), images[:1], train=False)
    _, mut = jmodel.apply(variables, images, train=True, mutable=["batch_stats"])
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, mut["batch_stats"])
    model = build_backbone("resnet_tiny")
    model.load_state_dict(params_from_jax(params, stats), strict=True)
    return jmodel, params, stats, model.eval()


def test_encode_dataset_matches_jax(tiny_backbone):
    """40 images in batches of 16: the last batch is padded and trimmed."""
    jmodel, params, stats, model = tiny_backbone
    jset = jdatasets.SyntheticDataset(num_samples=40, image_size=32, seed=3)
    tset = datasets.SyntheticDataset(num_samples=40, image_size=32, seed=3)
    ref, ref_labels = jknn_eval.encode_dataset(jmodel, params, stats, jset,
                                               jconfig.EvalConfig(image_size=32), batch=16)
    got, labels = knn_eval.encode_dataset(model, tset, EvalConfig(image_size=32), batch=16)
    assert got.shape == (40, model.feature_dim) and labels.dtype == torch.int64
    np.testing.assert_array_equal(labels.numpy(), ref_labels)
    np.testing.assert_allclose(got.numpy(), ref, **FEAT_TOL)
    np.testing.assert_allclose(got.norm(dim=1).numpy(), 1.0, rtol=1e-6)
    sub, _ = knn_eval.encode_dataset(model, tset, EvalConfig(image_size=32), batch=16,
                                     indices=np.array([7, 3, 30]))
    np.testing.assert_allclose(sub.numpy(), got.numpy()[[7, 3, 30]], rtol=1e-6, atol=1e-7)


def test_probe_steps_and_validate_match_jax(tiny_backbone):
    """Two SGD steps of the classifier (lr 30, momentum 0.9: the second uses
    the momentum) on pre-augmented images from the same init, then
    `validate` over 40 images whose last batch pads labels with -1."""
    jmodel, params, stats, model = tiny_backbone
    classes, lr = 10, 30.0
    fc_j = jlincls.init_classifier(jax.random.key(0), model.feature_dim, classes)
    tx = optax.chain(optax.add_decayed_weights(0.0), optax.sgd(lr, momentum=0.9))
    opt_state = tx.init(fc_j)
    jtrain_step, jeval_step = jlincls.build_lincls_steps(jmodel, tx)
    fc = torch.nn.Linear(model.feature_dim, classes)
    with torch.no_grad():
        fc.weight.copy_(torch.tensor(np.asarray(fc_j["w"]).T))
        fc.bias.copy_(torch.tensor(np.asarray(fc_j["b"])))
    opt = torch.optim.SGD(fc.parameters(), lr=lr, momentum=0.9, weight_decay=0.0)
    train_step, eval_step = lincls.build_lincls_steps(model, fc, opt)
    rng = np.random.RandomState(5)
    for _ in range(2):
        images = rng.randn(16, 32, 32, 3).astype(np.float32)
        labels = rng.randint(0, classes, 16)
        fc_j, opt_state, m_j = jtrain_step(fc_j, opt_state, params, stats,
                                           jnp.asarray(images), jnp.asarray(labels))
        m = train_step(torch.from_numpy(images), torch.from_numpy(labels), lr)
        np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]), rtol=1e-5)
        assert float(m["acc1"]) == float(m_j["acc1"])
    # |w| ~ 1e-2 moved by lr 30 x gradients ~ 1e-2: 1e-4 of the largest entry
    np.testing.assert_allclose(fc.weight.detach().numpy(), np.asarray(fc_j["w"]).T,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(fc.bias.detach().numpy(), np.asarray(fc_j["b"]),
                               rtol=1e-4, atol=1e-5)
    assert not model.training
    config = EvalConfig(image_size=32, batch_size=16)
    jset = jdatasets.SyntheticDataset(num_samples=40, image_size=32, seed=6)
    tset = datasets.SyntheticDataset(num_samples=40, image_size=32, seed=6)
    ref = jlincls.validate(jeval_step, fc_j, params, stats, jset,
                           jconfig.EvalConfig(image_size=32, batch_size=16), None)
    got = lincls.validate(eval_step, tset, config, "cpu")
    np.testing.assert_allclose(got, ref, rtol=1e-9)


def test_init_classifier_draws_n_0_001_and_zero_bias():
    fc = lincls.init_classifier(torch.Generator().manual_seed(0), 512, 1000)
    again = lincls.init_classifier(torch.Generator().manual_seed(0), 512, 1000)
    w = fc.weight.detach()
    assert torch.equal(w, again.weight.detach()) and not fc.bias.detach().any()
    assert abs(float(w.std()) - 0.01) < 2e-4 and abs(float(w.mean())) < 2e-4


def test_sanity_check_fails_on_a_changed_weight(tiny_backbone):
    *_, model = tiny_backbone
    ref = {k: v.clone() for k, v in model.state_dict().items()}
    lincls.sanity_check(model.state_dict(), ref)
    changed = dict(ref, **{"layer1_0.conv2.weight": ref["layer1_0.conv2.weight"].clone()})
    changed["layer1_0.conv2.weight"][0, 0, 0, 0] += 1e-7
    with pytest.raises(AssertionError, match="layer1_0.conv2.weight"):
        lincls.sanity_check(changed, ref)
    stat = dict(ref, **{"bn1.running_var": ref["bn1.running_var"] * 1.0001})
    with pytest.raises(AssertionError, match="bn1.running_var"):
        lincls.sanity_check(stat, ref)
    with pytest.raises(AssertionError, match="empty"):
        lincls.sanity_check(model.state_dict(), {})
    with pytest.raises(AssertionError, match="names differ"):
        lincls.sanity_check({k: v for k, v in ref.items() if k != "bn1.bias"}, ref)


@pytest.fixture(scope="module")
def exported(tmp_path_factory, tiny_backbone):
    """A pretrain export of `resnet_tiny` (the backbone plus a 16-d head)."""
    *_, model = tiny_backbone
    enc = build_backbone("resnet_tiny", num_classes=16)
    enc.load_state_dict(model.state_dict(), strict=False)
    path = str(tmp_path_factory.mktemp("export") / "enc.npz")
    ckpt.export_encoder_q(types.SimpleNamespace(model_q=enc), path)
    return path


def _probe_config(exported, **kw):
    return get_preset("imagenet-lincls").replace(**{
        **dict(pretrained=exported, arch="resnet_tiny", dataset="synthetic", image_size=32,
               num_classes=10, batch_size=16, epochs=2, print_freq=100, staging_workers=2),
        **kw})


def _probe(config, **kw):
    train_set = datasets.SyntheticDataset(num_samples=48, image_size=32)
    val_set = datasets.SyntheticDataset(num_samples=40, image_size=32, seed=999)
    return lincls.train_lincls(config, device="cpu", dataset=train_set, val_dataset=val_set,
                               **kw)


def test_probe_resume_and_evaluate(exported, tmp_path):
    """Two epochs in one run against one epoch, a probe checkpoint, and a
    run resumed with `auto`: the same classifier bit for bit. Then
    `--evaluate` of the resumed probe reports the last epoch's accuracy."""
    fc_full, best_full = _probe(_probe_config(exported, ckpt_dir=str(tmp_path / "a")))
    cut = _probe_config(exported, ckpt_dir=str(tmp_path / "b"))
    _probe(cut.replace(epochs=2), max_steps=3)  # one epoch of 3 steps
    assert ckpt.checkpoint_manager(str(tmp_path / "b")).all_steps() == [3]
    fc, best = _probe(cut.replace(resume="auto"))
    assert ckpt.checkpoint_manager(str(tmp_path / "b")).all_steps() == [3, 6]
    assert torch.equal(fc.weight, fc_full.weight) and torch.equal(fc.bias, fc_full.bias)
    assert best == best_full
    fc_eval, acc1 = _probe(cut.replace(resume="auto", evaluate=True))
    assert torch.equal(fc_eval.weight, fc.weight)
    assert 0.0 <= acc1 <= 100.0


def test_probe_sanity_check_reads_the_file(exported, monkeypatch):
    """A backbone that differs from the file on disk by one weight fails
    the probe's final check."""
    real = lincls.load_for_inference

    def nudged(*a, **kw):
        model = real(*a, **kw)
        with torch.no_grad():
            model.conv1.weight[0, 0, 0, 0] += 1e-3
        return model

    monkeypatch.setattr(lincls, "load_for_inference", nudged)
    with pytest.raises(AssertionError, match="conv1.weight"):
        _probe(_probe_config(exported, epochs=1))


def test_eval_entry_points_raise_without_cuda(exported, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flags = ["--pretrained", exported, "--arch", "resnet_tiny", "--dataset", "synthetic",
             "--image-size", "32"]
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        lincls.main(flags)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        knn_eval.main(flags)


def test_knn_cli_runs_on_the_cpu(exported, capsys):
    acc = knn_eval.main(["--pretrained", exported, "--arch", "resnet_tiny", "--dataset",
                         "synthetic", "--image-size", "32", "--num-classes", "10",
                         "--knn-bank-chunk", "256", "--device", "cpu"])
    assert 0.0 <= acc <= 1.0 and "kNN top-1" in capsys.readouterr().out


def test_monitor_val_split_matches_jax(tmp_path):
    """None for synthetic data; a held-out texture draw of the same classes
    (the same bytes as the JAX package's); the CIFAR test batch."""
    cfg = get_preset("imagenet-moco-v2").replace(dataset="synthetic", image_size=32)
    jcfg = jconfig.get_preset("imagenet-moco-v2").replace(dataset="synthetic", image_size=32)
    assert train._monitor_val_split(cfg, None) is None
    assert jtrain._monitor_val_split(jcfg, None) is None
    cfg = cfg.replace(dataset="synthetic_texture", num_classes=16)
    jcfg = jcfg.replace(dataset="synthetic_texture", num_classes=16)
    tset = datasets.SyntheticTextureDataset(num_samples=8, image_size=32, seed=3)
    jset = jdatasets.SyntheticTextureDataset(num_samples=8, image_size=32, seed=3)
    got, ref = train._monitor_val_split(cfg, tset), jtrain._monitor_val_split(jcfg, jset)
    assert len(got) == len(ref) == 2048 and got.seed == ref.seed == 10010
    np.testing.assert_array_equal(got.images[:4], ref.images[:4])
    np.testing.assert_array_equal(got.labels, ref.labels)


def test_knn_monitor_matches_jax(tiny_backbone):
    """The monitor's bank and held-out queries (the same draw as the JAX
    package's) and its top-1 on the same weights."""
    jmodel, params, stats, model = tiny_backbone
    cfg = get_preset("imagenet-moco-v2").replace(dataset="synthetic", image_size=32,
                                                 knn_bank_size=60)
    jcfg = jconfig.get_preset("imagenet-moco-v2").replace(dataset="synthetic", image_size=32,
                                                          knn_bank_size=60)
    tset = datasets.SyntheticDataset(num_samples=80, image_size=32, seed=2)
    jset = jdatasets.SyntheticDataset(num_samples=80, image_size=32, seed=2)
    jstate = types.SimpleNamespace(params_q=params, batch_stats_q=stats)
    ref, ref_val = jtrain.knn_monitor(jcfg, jtrain.make_feature_fn(jmodel, "v2"), jstate, jset)
    model.train()  # the monitor puts a training encoder in eval mode and back
    got, is_val = train.knn_monitor(cfg, train.make_feature_fn(model),
                                    types.SimpleNamespace(model_q=model), tset)
    assert model.training
    model.eval()
    assert (got, is_val) == (ref, ref_val) and is_val is False


def test_train_runs_the_knn_monitor(tmp_path):
    config = get_preset("imagenet-moco-v2").replace(
        arch="resnet_tiny", image_size=32, batch_size=8, num_negatives=32, embed_dim=16,
        compute_dtype="float32", dataset="synthetic", steps_per_epoch=2, knn_monitor=True,
        knn_bank_size=40, ckpt_dir=str(tmp_path))
    state, history = train.train(config, max_steps=3, device="cpu", on_step=lambda *a: None)
    knn = [h for h in history if any(k.startswith("knn_") for k in h)]
    assert [h["step"] for h in knn] == [0, 2, 3]
    assert "knn_train_top1_untrained" in knn[0] and all("knn_train_top1" in h for h in knn[1:])
    assert (tmp_path / "untrained_baseline.json").exists() and state.model_q.training
    # a resumed run cannot measure the untrained baseline: it reports the recorded one
    _, resumed = train.train(config.replace(resume="auto"), max_steps=4, device="cpu",
                             on_step=lambda *a: None)
    knn2 = [h for h in resumed if any(k.startswith("knn_") for k in h)]
    assert knn2[0] == knn[0] and [h["step"] for h in knn2] == [0, 4]
