"""The port's pre-staged epoch cache (`data/service/prestage.py`) on a JPEG
tree the test writes: a prestaged batch equals the freshly decoded batch
and the JAX package's prestage of the same tree bit for bit, an incomplete
prestage raises `PrestageError`, and the driver trains from a prestage as
from the decoded dataset."""

import json
import os

import numpy as np
import pytest
from PIL import Image

from moco_tpu.data import datasets as jdata
from moco_tpu.data.service import prestage as jprestage
from moco_tpu_torch import train
from moco_tpu_torch.config import get_preset
from moco_tpu_torch.data import datasets
from moco_tpu_torch.data.service import prestage
from moco_tpu_torch.data.service.prestage import PrestagedDataset, PrestageError, \
    write_prestage
from moco_tpu_torch.data.stats import InputPipelineStats

STAGE = 32  # canvas [32, 64]
TINY = dict(arch="resnet_tiny", image_size=32, batch_size=8, num_negatives=32, embed_dim=16,
            compute_dtype="float32", print_freq=1)


@pytest.fixture(scope="module")
def jpeg_tree(tmp_path_factory):
    """Two classes of JPEGs, landscape and portrait, some downscaled into
    the canvas."""
    root = tmp_path_factory.mktemp("prestage_tree")
    rng = np.random.RandomState(4)
    for c, cls in enumerate(("a", "b")):
        (root / cls).mkdir()
        for i in range(10):
            h, w = [(30, 45), (45, 30), (70, 50), (20, 90), (33, 17)][i % 5]
            img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            Image.fromarray(img).save(str(root / cls / f"{i}.jpg"), quality=85 + c)
    return str(root)


@pytest.fixture(scope="module")
def prestaged(jpeg_tree, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pre") / "p")
    meta = write_prestage(datasets.ImageFolder(jpeg_tree, stage_size=STAGE, num_workers=2),
                          root, chunk=7)
    return root, meta


def test_prestaged_batch_equals_decoded_and_jax_prestage(jpeg_tree, prestaged, tmp_path):
    root, meta = prestaged
    decoded = datasets.ImageFolder(jpeg_tree, stage_size=STAGE, num_workers=2)
    assert meta["n"] == len(decoded) == 20
    assert meta["img_shape"] == [STAGE, 2 * STAGE, 3]
    assert meta["canvas_bytes"] == 20 * STAGE * 2 * STAGE * 3
    jroot = str(tmp_path / "jax")
    jprestage.write_prestage(jdata.ImageFolder(jpeg_tree, stage_size=STAGE, num_workers=2),
                             jroot, chunk=5)
    ours, ref = PrestagedDataset(root), jprestage.PrestagedDataset(jroot)
    assert len(ours) == len(ref) == 20 and ours.meta == ref.meta
    idx = np.asarray([3, 0, 19, 7, 7, 12])
    for got in (ours.get_batch(idx), ref.get_batch(idx)):
        for a, b in zip(got, decoded.get_batch(idx)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # the files themselves, and the canvas protocol's rows
    for name in ("canvases.u8", "extents.i32", "labels.i32"):
        with open(os.path.join(root, name), "rb") as f, open(os.path.join(jroot, name),
                                                              "rb") as g:
            assert f.read() == g.read(), name
    out_i = np.zeros((len(idx), STAGE, 2 * STAGE, 3), np.uint8)
    out_e = np.zeros((len(idx), 3), np.int32)
    labels = ours.get_batch_into(idx, out_i, out_e)
    ref_i, ref_l, ref_e = decoded.get_batch(idx)
    np.testing.assert_array_equal(out_i, ref_i)
    np.testing.assert_array_equal(out_e, ref_e)
    np.testing.assert_array_equal(labels, ref_l)
    # either package reads the other's prestage
    np.testing.assert_array_equal(PrestagedDataset(jroot).get_batch(idx)[0], ref_i)


def test_incomplete_prestage_raises(jpeg_tree, prestaged, tmp_path):
    root, _meta = prestaged
    with pytest.raises(PrestageError, match="already holds"):
        write_prestage(datasets.SyntheticDataset(num_samples=4, image_size=8), root)
    # no meta.json: a killed or running writer
    torn = tmp_path / "torn"
    torn.mkdir()
    with pytest.raises(PrestageError, match="no meta.json"):
        PrestagedDataset(str(torn))
    # a truncated payload
    cut = tmp_path / "cut"
    write_prestage(datasets.SyntheticDataset(num_samples=12, image_size=8), str(cut))
    with open(cut / "canvases.u8", "r+b") as f:
        f.truncate(os.path.getsize(cut / "canvases.u8") - 100)
    with pytest.raises(PrestageError):
        PrestagedDataset(str(cut))
    # meta and payload that disagree
    write_prestage(datasets.SyntheticDataset(num_samples=12, image_size=8),
                   str(tmp_path / "drift"))
    meta = json.loads((tmp_path / "drift" / "meta.json").read_text())
    meta["n"] = 13
    (tmp_path / "drift" / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(PrestageError, match="disagrees"):
        PrestagedDataset(str(tmp_path / "drift"))


def test_prestage_refuses_decode_failures(tmp_path):
    class Failing(datasets.SyntheticDataset):
        decode_failures = 0

        def get_batch(self, indices):
            self.decode_failures += 1
            return super().get_batch(indices)

    with pytest.raises(PrestageError, match="decode failure"):
        write_prestage(Failing(num_samples=4, image_size=8), str(tmp_path / "p"))
    assert not (tmp_path / "p" / "meta.json").exists()


def test_cli_writes_a_prestage(jpeg_tree, tmp_path, capsys):
    root = str(tmp_path / "cli")
    assert prestage.main([root, "--dataset", "imagefolder", "--data-dir", jpeg_tree,
                          "--stage-size", str(STAGE), "--loader-workers", "2"]) == 0
    assert "complete: 20 rows" in capsys.readouterr().out
    decoded = datasets.ImageFolder(jpeg_tree, stage_size=STAGE, num_workers=2)
    idx = np.arange(20)
    np.testing.assert_array_equal(PrestagedDataset(root).get_batch(idx)[0],
                                  decoded.get_batch(idx)[0])
    # refused, not overwritten
    assert prestage.main([root, "--dataset", "imagefolder", "--data-dir", jpeg_tree,
                          "--stage-size", str(STAGE)]) == prestage.EXIT_CONFIG_ERROR


def test_driver_on_input_prestage_equals_the_decoded_dataset(jpeg_tree, prestaged):
    root, _meta = prestaged
    config = get_preset("imagenet-moco-v2").replace(
        **TINY, dataset="imagefolder", data_dir=jpeg_tree, stage_size=STAGE, num_workers=2)

    def run(cfg, stats=None):
        state, history = train.train(cfg, max_steps=3, device="cpu", on_step=lambda *a: None,
                                     stats=stats)
        return [h["loss"] for h in history], state

    decoded, s1 = run(config)
    # the decode-once cache stays off on the prestaged branch
    stats = InputPipelineStats()
    pre, s2 = run(config.replace(input_prestage=root, input_cache_mb=64), stats)
    assert stats.cache_hits == stats.cache_misses == 0
    assert len(decoded) == 3 and all(np.isfinite(decoded))
    assert pre == decoded
    for (k, a), b in zip(s1.model_q.state_dict().items(), s2.model_q.state_dict().values()):
        assert a.equal(b), k
