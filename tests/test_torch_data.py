"""The port's datasets, native JPEG stager and decode-once cache against the
JAX package's on the same files and seeds: the same bytes, extents, labels
and decode-failure counts, bit for bit."""

import os
import pickle

import numpy as np
import pytest
from PIL import Image

from moco_tpu.data import canvas_cache as jcache
from moco_tpu.data import datasets as jdata
from moco_tpu_torch.data import canvas_cache, datasets, native_loader
from moco_tpu_torch.data.stats import InputPipelineStats


def _assert_same_batch(got, ref):
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name, kw", [
    ("synthetic", dict(num_samples=40, image_size=16, num_classes=5, seed=3)),
    ("synthetic_texture", dict(num_samples=40, image_size=16, num_classes=6, seed=2)),
])
def test_synthetic_datasets_match_jax(name, kw):
    cls = {"synthetic": "SyntheticDataset", "synthetic_texture": "SyntheticTextureDataset"}
    ours = getattr(datasets, cls[name])(**kw)
    ref = getattr(jdata, cls[name])(**kw)
    assert len(ours) == len(ref) and ours.num_classes == ref.num_classes
    idx = np.asarray([5, 0, 39, 7, 7, 12])
    _assert_same_batch(ours.get_batch(idx), ref.get_batch(idx))
    np.testing.assert_array_equal(ours.images, ref.images)


@pytest.fixture(scope="module")
def cifar_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cifar")
    d = root / "cifar-10-batches-py"
    d.mkdir()
    rng = np.random.RandomState(0)
    for name, n in [(f"data_batch_{i}", 12) for i in range(1, 6)] + [("test_batch", 8)]:
        data = rng.randint(0, 256, (n, 3072), dtype=np.uint8)
        labels = rng.randint(0, 10, n).tolist()
        with open(d / name, "wb") as f:
            pickle.dump({b"data": data, b"labels": labels}, f)
    return str(root)


@pytest.mark.parametrize("train", [True, False])
def test_cifar10_matches_jax(cifar_dir, train):
    ours, ref = datasets.CIFAR10(cifar_dir, train=train), jdata.CIFAR10(cifar_dir, train=train)
    assert len(ours) == len(ref) == (60 if train else 8)
    idx = np.arange(len(ours))[::-1]
    _assert_same_batch(ours.get_batch(idx), ref.get_batch(idx))
    assert ours.get_batch(idx)[0].shape == (len(idx), 32, 32, 3)


@pytest.mark.parametrize("train", [True, False])
def test_written_cifar_tree_reads_the_same_through_both_readers(tmp_path, train):
    """`write_cifar10_tree`'s files are the dataset's pickle layout: the
    port's and the JAX package's readers give the same arrays, and the same
    seed writes the same bytes."""
    root = tmp_path / "a"
    out = datasets.write_cifar10_tree(str(root), per_batch=20, test_size=12, seed=5)
    assert sorted(os.listdir(out)) == sorted(
        [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch", "batches.meta"])
    ours, ref = datasets.CIFAR10(str(root), train=train), jdata.CIFAR10(str(root), train=train)
    assert len(ours) == len(ref) == (100 if train else 12)
    np.testing.assert_array_equal(ours.images, ref.images)
    np.testing.assert_array_equal(ours.labels, ref.labels)
    idx = np.arange(len(ours))[::-1]
    _assert_same_batch(ours.get_batch(idx), ref.get_batch(idx))
    assert ours.images.shape[1:] == (32, 32, 3) and set(ours.labels) <= set(range(10))
    again = datasets.write_cifar10_tree(str(tmp_path / "b"), per_batch=20, test_size=12, seed=5)
    for name in os.listdir(out):
        with open(os.path.join(out, name), "rb") as f, open(os.path.join(again, name), "rb") as g:
            assert f.read() == g.read(), name


def test_cifar10_missing_batch_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="cifar-10-batches-py"):
        datasets.CIFAR10(str(tmp_path))


STAGE = 32  # canvas [32, 64]
# (h, w) of the tree's images: landscape and portrait, odd sizes, ones that
# fit the canvas as they are and ones that are downscaled into it
SIZES = [(24, 40), (45, 30), (33, 17), (20, 90), (70, 50), (31, 64), (9, 13), (64, 41)]


def _photo(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([255 * yy / h, 255 * xx / w, 128 + 60 * np.sin(xx / 3.0)], -1)
    return np.clip(base + rng.randint(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    """Two classes of JPEGs at SIZES, plus (in a third class) a PNG, a BMP
    and one corrupt JPEG."""
    root = tmp_path_factory.mktemp("tree")
    rng = np.random.RandomState(0)
    for c, cls in enumerate(("cat", "dog")):
        (root / cls).mkdir()
        for i, (h, w) in enumerate(SIZES):
            Image.fromarray(_photo(rng, h, w)).save(str(root / cls / f"{i}.jpg"), quality=90 - c)
    (root / "zmixed").mkdir()
    Image.fromarray(_photo(rng, 50, 27)).save(str(root / "zmixed" / "a.png"))
    Image.fromarray(_photo(rng, 18, 75)).save(str(root / "zmixed" / "b.bmp"))
    (root / "zmixed" / "c.jpg").write_bytes(b"not a jpeg at all")
    (root / "zmixed" / "notes.txt").write_text("not an image")
    return str(root)


@pytest.fixture(scope="module")
def jpeg_tree(image_tree, tmp_path_factory):
    """The JPEG classes of `image_tree` alone."""
    root = tmp_path_factory.mktemp("jpegs")
    for cls in ("cat", "dog"):
        os.symlink(os.path.join(image_tree, cls), root / cls)
    return str(root)


def test_imagefolder_pil_matches_jax_bit_for_bit(image_tree):
    ours = datasets.ImageFolder(image_tree, stage_size=STAGE, num_workers=3, backend="pil")
    ref = jdata.ImageFolder(image_tree, stage_size=STAGE, num_workers=3, backend="pil")
    assert [e.path for e in ours.entries] == [e.path for e in ref.entries]
    assert ours.num_classes == ref.num_classes == 3 and len(ours) == 2 * len(SIZES) + 3
    idx = np.arange(len(ours))[::-1]
    got, want = ours.get_batch(idx), ref.get_batch(idx)
    _assert_same_batch(got, want)
    assert got[0].shape == (len(idx), STAGE, 2 * STAGE, 3)
    assert set(got[2][:, 2]) == {0, 1}          # landscape and portrait both staged
    assert (got[2][:, 0] < STAGE).any() and (got[2][:, 1] == 2 * STAGE).any()
    assert ours.decode_failures == ref.decode_failures == 1  # the corrupt JPEG
    assert ours.decode_total == ref.decode_total == len(idx)
    bad = [j for j, i in enumerate(idx) if ours.entries[i].path.endswith("c.jpg")]
    np.testing.assert_array_equal(got[0][bad[0]], 0)
    np.testing.assert_array_equal(got[2][bad[0]], [STAGE, 2 * STAGE, 0])


def test_imagefolder_get_batch_into_rows(image_tree):
    """Sub-slices decoded into disjoint rows of one canvas equal one call."""
    ds = datasets.ImageFolder(image_tree, stage_size=STAGE, backend="pil")
    idx = np.arange(len(ds))
    imgs, labels, extents = ds.get_batch(idx)
    out = np.zeros_like(imgs)
    ext = np.zeros_like(extents)
    lab = np.concatenate([ds.get_batch_into(idx[lo:hi], out[lo:hi], ext[lo:hi])
                          for lo, hi in ((0, 5), (5, 6), (6, len(idx)))])
    np.testing.assert_array_equal(out, imgs)
    np.testing.assert_array_equal(ext, extents)
    np.testing.assert_array_equal(lab, labels)


def test_native_stager_matches_jax_native_stager(image_tree):
    """The port's build of `native/staging_loader.cc` and the JAX package's
    give the same canvases, extents and failures, the corrupt file included."""
    from moco_tpu.data.native_loader import NativeStagingLoader as JaxLoader

    ours = native_loader.NativeStagingLoader(STAGE, 2 * STAGE, num_threads=3)
    try:
        ref = JaxLoader(STAGE, 2 * STAGE, num_threads=2)
    except RuntimeError as e:  # the JAX package could not run make here
        pytest.fail(f"the JAX package's native stager did not build: {e}")
    paths = sorted(os.path.join(r, f) for r, _, fs in os.walk(image_tree) for f in fs
                   if f.endswith(".jpg"))
    got, want = ours.load_batch(paths), ref.load_batch(paths)
    assert got[2] == want[2] == 1
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert ours.total_failures == 1 and ours.total_images == len(paths)
    assert ours.path.parent == native_loader.BUILD_DIR
    assert native_loader.BUILD_DIR.name == "_build"
    assert native_loader.BUILD_DIR.parent.name == "moco_tpu_torch"


@pytest.mark.parametrize("tree", ["jpeg_tree", "image_tree"])
def test_imagefolder_native_backend_matches_jax(request, tree):
    """backend="native" in the port and the JAX package, batch by batch:
    all-JPEG batches through the stager, the rest (and a batch with the
    corrupt JPEG, again) through PIL; the same bytes and failure counts."""
    root = request.getfixturevalue(tree)
    ours = datasets.ImageFolder(root, stage_size=STAGE, num_workers=2, backend="native")
    ref = jdata.ImageFolder(root, stage_size=STAGE, num_workers=2, backend="native")
    assert ours._native is not None and ref._native is not None
    order = np.random.RandomState(1).permutation(len(ours))
    for lo in range(0, len(order), 5):
        _assert_same_batch(ours.get_batch(order[lo:lo + 5]), ref.get_batch(order[lo:lo + 5]))
    assert ours.decode_failures == ref.decode_failures == (1 if tree == "image_tree" else 0)
    assert ours.decode_total == ref.decode_total == len(order)


def test_imagefolder_auto_names_its_decoder(jpeg_tree, image_tree, capsys, monkeypatch,
                                            tmp_path):
    datasets.ImageFolder(jpeg_tree, stage_size=STAGE, backend="auto")
    assert "decoding with the native stager" in capsys.readouterr().out
    datasets.ImageFolder(image_tree, stage_size=STAGE, backend="pil")
    assert capsys.readouterr().out == ""
    png_only = tmp_path / "png" / "x"
    png_only.mkdir(parents=True)
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(str(png_only / "a.png"))
    datasets.ImageFolder(str(tmp_path / "png"), stage_size=STAGE, backend="auto")
    assert "decoding with PIL (no JPEG files)" in capsys.readouterr().out
    # a stager that cannot build: auto says so and takes PIL
    monkeypatch.setattr(native_loader, "SOURCE", tmp_path / "missing.cc")
    ds = datasets.ImageFolder(jpeg_tree, stage_size=STAGE, backend="auto")
    assert ds._native is None
    assert "decoding with PIL (native stager unavailable" in capsys.readouterr().out


def test_imagefolder_native_raises_when_the_stager_cannot_build(jpeg_tree, monkeypatch,
                                                                tmp_path):
    monkeypatch.setattr(native_loader, "SOURCE", tmp_path / "missing.cc")
    with pytest.raises(native_loader.NativeBuildError, match="missing"):
        datasets.ImageFolder(jpeg_tree, stage_size=STAGE, backend="native")
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    monkeypatch.setattr(native_loader, "SOURCE", native_loader.PKG_DIR.parent / "native"
                        / "staging_loader.cc")
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(native_loader.NativeBuildError, match="C\\+\\+ compiler"):
        native_loader.NativeStagingLoader(STAGE, 2 * STAGE)


def test_imagefolder_native_needs_jpegs(tmp_path):
    (tmp_path / "x").mkdir()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(str(tmp_path / "x" / "a.png"))
    with pytest.raises(RuntimeError, match="requires JPEG"):
        datasets.ImageFolder(str(tmp_path), backend="native")
    with pytest.raises(ValueError, match="unknown backend"):
        datasets.ImageFolder(str(tmp_path), backend="turbo")


def test_build_dataset(cifar_dir, jpeg_tree, tmp_path):
    assert isinstance(datasets.build_dataset("synthetic", image_size=16, num_samples=8),
                      datasets.SyntheticDataset)
    tex = datasets.build_dataset("synthetic_texture", image_size=16, num_samples=8)
    assert isinstance(tex, datasets.SyntheticTextureDataset) and tex.image_size == 16
    assert len(datasets.build_dataset("cifar10", cifar_dir)) == 60
    os.symlink(jpeg_tree, tmp_path / "train")  # a train/ subdirectory is taken
    ds = datasets.build_dataset("imagefolder", str(tmp_path), stage_size=16, num_workers=2,
                                backend="pil")
    assert isinstance(ds, datasets.ImageFolder) and ds.stage_h == 16 and len(ds) == 16
    with pytest.raises(ValueError, match="unknown dataset"):
        datasets.build_dataset("imagenet21k")


# ---------------------------------------------------------------------------
# decode-once canvas cache
# ---------------------------------------------------------------------------


def test_cache_hits_and_misses_match_jax(image_tree):
    """The same lookups through the port's and the JAX package's cache: the
    same batches, and the same hit/miss counts after each."""
    stats = InputPipelineStats()
    ours = canvas_cache.CachedDataset(
        datasets.ImageFolder(image_tree, stage_size=STAGE, backend="pil"), 1, stats=stats)
    ref = jcache.CachedDataset(
        jdata.ImageFolder(image_tree, stage_size=STAGE, backend="pil"), 1)
    for idx in ([0, 1, 2, 3], [2, 3, 4, 5], [0, 1, 2, 3], [6, 7, 8], list(range(16))):
        _assert_same_batch(ours.get_batch(np.asarray(idx)), ref.get_batch(np.asarray(idx)))
        assert (ours.hits, ours.misses) == (ref.hits, ref.misses)
        assert ours.cached_entries == ref.cached_entries
    # the into-rows protocol over the same cache
    out = np.zeros((5, STAGE, 2 * STAGE, 3), np.uint8)
    ext = np.zeros((5, 3), np.int32)
    labels = ours.get_batch_into(np.arange(5), out, ext)
    want = ref.get_batch(np.arange(5))
    _assert_same_batch((out, labels, ext), want)
    snap = stats.snapshot()
    assert snap["cache_hits"] == ours.hits and snap["cache_misses"] == ours.misses


def test_cache_lru_respects_byte_budget():
    ds = datasets.SyntheticDataset(num_samples=128, image_size=64, num_classes=4)
    per_entry = 64 * 64 * 3 + 3 * 4  # canvas + extents
    cached = canvas_cache.CachedDataset(ds, cache_mb=1)
    cached.get_batch(np.arange(128))
    assert cached.cached_bytes <= 2**20
    max_entries = 2**20 // per_entry
    assert 0 < cached.cached_entries <= max_entries < 128  # evicted some
    hits = cached.hits  # LRU: the most recently inserted indices survived
    cached.get_batch(np.arange(128 - cached.cached_entries, 128))
    assert cached.hits == hits + cached.cached_entries
    with pytest.raises(ValueError, match="positive"):
        canvas_cache.CachedDataset(ds, cache_mb=0)


def test_cache_skips_batches_with_decode_failures(image_tree):
    """A fill during which the inner failure counter moved is never cached."""
    inner = datasets.ImageFolder(image_tree, stage_size=STAGE, backend="pil")
    cached = canvas_cache.CachedDataset(inner, cache_mb=64)
    bad = next(i for i, e in enumerate(inner.entries) if e.path.endswith("c.jpg"))
    cached.get_batch(np.asarray([0, bad]))
    assert cached.cached_entries == 0
    cached.get_batch(np.asarray([0, 1]))
    assert cached.cached_entries == 2
    assert cached.decode_failures == 1  # delegated to the inner dataset
    assert cached.num_classes == 3 and len(cached) == len(inner)
