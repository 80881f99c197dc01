"""The port's training loop over its input pipeline on the CPU: `train()` fed by
`epoch_loader` from a CIFAR-layout tree and a JPEG tree, the same losses
whatever the staging, the metrics on the host once per print, the cache,
and the decode-failure abort."""

import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from moco_tpu_torch import train
from moco_tpu_torch.config import get_preset
from moco_tpu_torch.data import datasets
from moco_tpu_torch.data.stats import InputPipelineStats

TINY = dict(arch="resnet_tiny", image_size=32, batch_size=8, num_negatives=32, embed_dim=16,
            compute_dtype="float32", print_freq=1)


def _config(**kw):
    return get_preset("imagenet-moco-v2").replace(**{**TINY, **kw})


@pytest.fixture(scope="module")
def cifar_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cifar") / "cifar-10-batches-py"
    d.mkdir()
    rng = np.random.RandomState(0)
    for i in range(1, 6):
        with open(d / f"data_batch_{i}", "wb") as f:
            pickle.dump({b"data": rng.randint(0, 256, (8, 3072), dtype=np.uint8),
                         b"labels": rng.randint(0, 10, 8).tolist()}, f)
    return str(d.parent)


@pytest.fixture(scope="module")
def jpeg_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_tree")
    rng = np.random.RandomState(1)
    for cls in ("a", "b"):
        (root / cls).mkdir()
        for i in range(12):
            h, w = (30, 45) if i % 2 else (45, 30)  # landscape and portrait
            img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            Image.fromarray(img).save(str(root / cls / f"{i}.jpg"), quality=90)
    return str(root)


def _losses(config, steps, **kw):
    _state, history = train.train(config, max_steps=steps, device="cpu",
                                  on_step=lambda *a: None, **kw)
    return [h["loss"] for h in history]


@pytest.mark.parametrize("dataset", ["cifar10", "imagefolder"])
def test_losses_do_not_depend_on_the_staging(dataset, cifar_dir, jpeg_tree):
    """Two steps through `epoch_loader` with 4 staging workers and depth 2
    give the same losses, bit for bit, as one worker and depth 1."""
    data_dir = cifar_dir if dataset == "cifar10" else jpeg_tree
    config = _config(dataset=dataset, data_dir=data_dir, stage_size=32)
    parallel = _losses(config, 2)
    serial = _losses(config.replace(staging_workers=1, prefetch_depth=1), 2)
    assert len(parallel) == 2 and all(np.isfinite(parallel))
    assert parallel == serial


def test_print_freq_makes_one_host_transfer_per_print(monkeypatch):
    """Once the state is built, the metrics reach the host only on print
    steps (every `print_freq`-th batch of an epoch), each time in one
    `.cpu()` of one stacked tensor. With the NaN sentinel off no tensor is
    read as a Python number; with it on (the default) exactly one a step,
    its one-step-late read of the held loss."""
    for sentinel, scalars in ((False, 0), (True, 5)):
        _one_host_transfer_per_print(monkeypatch, sentinel, scalars)


def _one_host_transfer_per_print(monkeypatch, sentinel: bool, scalars: int):
    calls = {"cpu": 0, "scalar": 0}
    armed = []
    real_cpu, real_float, real_item = torch.Tensor.cpu, torch.Tensor.__float__, \
        torch.Tensor.item
    real_state = train.create_train_state

    def cpu(self, *a, **kw):
        calls["cpu"] += bool(armed)
        return real_cpu(self, *a, **kw)

    def counted(real):
        def read(self, *a, **kw):
            calls["scalar"] += bool(armed)
            return real(self, *a, **kw)
        return read

    def create_train_state(*a, **kw):  # weight init may read numbers; the loop may not
        state = real_state(*a, **kw)
        armed.append(True)
        return state

    seen = []
    config = _config(dataset="synthetic", print_freq=2, loss_sentinel=sentinel)
    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    monkeypatch.setattr(torch.Tensor, "__float__", counted(real_float))
    monkeypatch.setattr(torch.Tensor, "item", counted(real_item))
    monkeypatch.setattr(train, "create_train_state", create_train_state)
    # 2048 synthetic samples: 256 batches an epoch, prints at batches 0, 2, 4
    state, history = train.train(config, max_steps=5, device="cpu",
                                 on_step=lambda step, m, s: seen.append((step, m, s)))
    monkeypatch.undo()
    assert armed and [s for s, _, _ in seen] == [1, 3, 5] and state.step == 5
    assert calls == {"cpu": 3, "scalar": scalars}
    assert history == [m for _, m, _ in seen]
    for _, m, seconds in seen:
        assert set(m) == set(train.METRIC_NAMES) and seconds > 0
        assert all(isinstance(v, (int, float)) for v in m.values())


def test_input_cache_serves_the_second_epoch(cifar_dir):
    stats = InputPipelineStats()
    config = _config(dataset="cifar10", data_dir=cifar_dir, input_cache_mb=16,
                     steps_per_epoch=2)
    _losses(config, 4, stats=stats)  # two epochs over the same 40 images
    snap = stats.snapshot()
    assert snap["cache_hits"] > 0 and snap["cache_misses"] <= 40
    assert snap["staged_batches"] >= 4 and snap["workers"] == 4


class _Failing(datasets.SyntheticDataset):
    """Synthetic data whose decode meters say every image failed."""

    def get_batch(self, indices):
        self.decode_failures = getattr(self, "decode_failures", 0) + len(indices)
        self.decode_total = getattr(self, "decode_total", 0) + len(indices)
        return super().get_batch(indices)


def test_decode_abort_rate_raises_data_quality_error():
    config = _config(dataset="synthetic")
    with pytest.raises(train.DataQualityError, match="decode-failure rate"):
        train.train(config, max_steps=2, device="cpu", dataset=_Failing(num_samples=32),
                    on_step=lambda *a: None)
    _state, history = train.train(config.replace(decode_abort_rate=0.0), max_steps=1,
                                  device="cpu", dataset=_Failing(num_samples=32),
                                  on_step=lambda *a: None)
    assert len(history) == 1


def test_train_refuses_a_dataset_smaller_than_a_batch():
    with pytest.raises(ValueError, match="fewer than one batch"):
        train.train(_config(), max_steps=1, device="cpu",
                    dataset=datasets.SyntheticDataset(num_samples=4, image_size=32))


def test_cli_trains_from_a_cifar_tree(cifar_dir, capsys):
    train.main(["--preset", "cifar10-moco-v1", "--data-dir", cifar_dir, "--arch",
                "resnet_tiny", "--batch-size", "8", "--num-negatives", "32", "--embed-dim",
                "16", "--max-steps", "2", "--print-freq", "1", "--staging-workers", "2",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "dataset='cifar10'" in out
    assert "step 1 loss" in out and "step 2 loss" in out and "queue_ptr 16" in out
