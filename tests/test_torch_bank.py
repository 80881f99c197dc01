"""The port's versioned kNN bank and ANN index (`moco_tpu_torch/serve/
bankbuild.py`, `serve/ann.py`, `python -m moco_tpu_torch.bank_build`)
against the JAX package's on the CPU.

Both packages write the bank by hand as a deterministic ZIP_STORED npz and
build the index in numpy from a fixed seed, so the gates are exact: for
the same corpus, embedding function and checkpoint file the two banks are
the same bytes, a bank is the same bytes for any shard count, either
package verifies and loads what the other wrote, and for the same bank and
seed the index arrays (and files) are equal and search, vote and recall
alike. The CLI builds offline on the CPU with the port's engine and through
the batch lane of a running port service.
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np
import pytest

import moco_tpu.serve.ann as jann
import moco_tpu.serve.bankbuild as jbank
import moco_tpu_torch.serve.ann as tann
import moco_tpu_torch.serve.bankbuild as tbank
from moco_tpu_torch.bank_build import main as bank_build_main
from moco_tpu_torch.resilience.integrity import manifest_path

D, S = 6, 8


def _embed_stub(batch, scale=1.0):
    flat = np.asarray(batch, np.float32).reshape(len(batch), -1)
    return (flat[:, :D] / 255.0 * scale + 0.01).astype(np.float32)


def _corpus(n=13, seed=3, size=S):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            (np.arange(n) % 3).astype(np.int64))


def _ckpt(root, step, payload=b"weights " * 64):
    d = root / "export" / str(step)
    d.mkdir(parents=True, exist_ok=True)
    path = d / "encoder.npz"
    path.write_bytes(payload)
    return str(path)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_shard_ranges_and_probe_batch_equal_the_jax_packages():
    for n, shards in ((13, 3), (4, 4), (7, 1), (5, 9), (0, 2)):
        assert tbank.shard_ranges(n, shards) == jbank.shard_ranges(n, shards)
    with pytest.raises(ValueError, match="shards must be >= 1, got 0"):
        tbank.shard_ranges(4, 0)
    assert np.array_equal(tbank.probe_batch(8, 3), jbank.probe_batch(8, 3))
    assert tbank.PROBE_SEED == jbank.PROBE_SEED and tann.ANN_SEED == jann.ANN_SEED


def test_bank_bytes_equal_across_packages_and_shard_counts(tmp_path):
    images, labels = _corpus(13)
    ck = _ckpt(tmp_path, 7)
    events = []
    m1 = tbank.build_bank(str(tmp_path / "t1"), 7, images, labels, _embed_stub,
                          checkpoint_path=ck, image_size=S, shards=1)
    m3 = tbank.build_bank(str(tmp_path / "t3"), 7, images, labels, _embed_stub,
                          checkpoint_path=ck, image_size=S, shards=3, workers=2,
                          emit=lambda e, **f: events.append((e, f)))
    mj = jbank.build_bank(str(tmp_path / "j"), 7, images, labels, _embed_stub,
                          checkpoint_path=ck, image_size=S, shards=2)
    banks = [tmp_path / d / "7" / "bank.npz" for d in ("t1", "t3", "j")]
    assert _read(banks[0]) == _read(banks[1]) == _read(banks[2])
    strip = lambda m: {k: v for k, v in m.items() if k != "shards"}  # noqa: E731
    assert strip(m1) == strip(m3) == strip(mj)
    assert [m["shards"] for m in (m1, m3, mj)] == [1, 3, 2]
    names = [e for e, _ in events]
    assert names[0] == "build_start" and names[-1] == "build_done"
    assert names.count("shard_done") == 3
    assert not (tmp_path / "t3" / ".build" / "7").exists()


def test_banks_cross_verify_between_the_packages(tmp_path):
    images, labels = _corpus(10)
    ck = _ckpt(tmp_path, 4)
    tbank.build_bank(str(tmp_path / "t"), 4, images, labels, _embed_stub,
                     checkpoint_path=ck, image_size=S)
    jbank.build_bank(str(tmp_path / "j"), 4, images, labels, _embed_stub,
                     checkpoint_path=ck, image_size=S)
    for root, (ours, theirs) in (("t", (tbank, jbank)), ("j", (jbank, tbank))):
        bank_dir = str(tmp_path / root)
        path = os.path.join(bank_dir, "4", "bank.npz")
        assert theirs.verify_bank(bank_dir, 4) is None
        meta_a, meta_b = ours.read_bank_meta(path), theirs.read_bank_meta(path)
        assert meta_a == meta_b and meta_a["step"] == 4 and meta_a["rows"] == 10
        feats, lab, meta = theirs.load_bank(path)
        assert feats.shape == (10, D) and np.array_equal(lab, labels)
        assert theirs.probe_agreement(_embed_stub, meta) == pytest.approx(1.0)
        assert ours.probe_agreement(lambda b: -_embed_stub(b), meta) == pytest.approx(-1.0)
    # a tampered bank fails both packages' check the same way
    bank = tmp_path / "t" / "4" / "bank.npz"
    data = bytearray(_read(bank))
    data[-1] ^= 1
    bank.write_bytes(bytes(data))
    reasons = {tbank.verify_bank(str(tmp_path / "t"), 4), jbank.verify_bank(str(tmp_path / "t"), 4)}
    assert reasons == {"digest mismatch on bank.npz"}


def test_build_resumes_retries_and_validates(tmp_path):
    images, labels = _corpus(12)
    ck = _ckpt(tmp_path, 9)
    poison = images[4]

    def dying(batch):
        if np.array_equal(np.asarray(batch)[0], poison):
            raise RuntimeError("worker died")
        return _embed_stub(batch)

    with pytest.raises(tbank.BankBuildError, match=r"shard 1 rows \[4:8\)"):
        tbank.build_bank(str(tmp_path / "b"), 9, images, labels, dying, checkpoint_path=ck,
                         image_size=S, shards=3, max_shard_retries=2)
    assert sorted(os.listdir(tmp_path / "b" / ".build" / "9")) == [
        "shard_00000000_00000004.npz", "shard_00000008_00000012.npz"]
    assert not os.path.exists(manifest_path(str(tmp_path / "b"), 9))
    calls, events = [], []

    def counting(batch):
        calls.append(len(batch))
        return _embed_stub(batch)

    tbank.build_bank(str(tmp_path / "b"), 9, images, labels, counting, checkpoint_path=ck,
                     image_size=S, shards=3, emit=lambda e, **f: events.append((e, f)))
    assert [f["reused"] for e, f in events if e == "shard_done"].count(True) == 2
    assert len(calls) == 2  # the missing shard, then the probe
    clean = jbank.build_bank(str(tmp_path / "clean"), 9, images, labels, _embed_stub,
                             checkpoint_path=ck, image_size=S, shards=3)
    assert _read(tmp_path / "b" / "9" / "bank.npz") == _read(tmp_path / "clean" / "9" / "bank.npz")
    with open(manifest_path(str(tmp_path / "b"), 9)) as f:
        assert json.load(f) == clean
    failed = []

    def flaky(batch):
        if np.asarray(batch).shape[0] == 4 and not failed:
            failed.append(1)
            raise OSError("connection reset")
        return _embed_stub(batch)

    manifest = tbank.build_bank(str(tmp_path / "f"), 5, images[:8], labels[:8], flaky,
                                checkpoint_path=ck, image_size=S, shards=2, workers=2)
    assert manifest["rows"] == 8 and failed
    with pytest.raises(tbank.BankBuildError, match="corpus shape mismatch"):
        tbank.build_bank(str(tmp_path / "v"), 3, images, labels[:2], _embed_stub,
                         checkpoint_path=ck, image_size=S)
    with pytest.raises(tbank.BankBuildError, match="empty corpus"):
        tbank.build_bank(str(tmp_path / "v"), 3, images[:0], labels[:0], _embed_stub,
                         checkpoint_path=ck, image_size=S)
    legacy = tmp_path / "legacy.npz"
    np.savez(legacy, features=np.ones((4, D), np.float32), labels=np.arange(4))
    feats, _, meta = tbank.load_bank(str(legacy))
    assert feats.shape == (4, D) and meta is None
    np.savez(tmp_path / "bad.npz", nope=np.ones(3))
    with pytest.raises(ValueError, match="features"):
        tbank.load_bank(str(tmp_path / "bad.npz"))


def _bank(tmp_path, name, n=256, step=7, shards=1, builder=tbank):
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (n, S, S, 3), dtype=np.uint8)
    labels = (np.arange(n) % 5).astype(np.int64)
    ck = _ckpt(tmp_path / name, step)

    def embed(batch):  # 12 dims with some cluster structure
        flat = np.asarray(batch, np.float32).reshape(len(batch), -1)
        return (flat[:, :12] / 255.0 - 0.5).astype(np.float32)

    builder.build_bank(str(tmp_path / name), step, images, labels, embed,
                       checkpoint_path=ck, image_size=S, shards=shards)
    return str(tmp_path / name)


def test_ann_index_equals_the_jax_packages(tmp_path):
    bank_t = _bank(tmp_path, "t", shards=3)
    bank_j = _bank(tmp_path, "j", builder=jbank)
    mt = tann.build_ann_index(bank_t, 7, cells=16)
    mj = jann.build_ann_index(bank_j, 7, cells=16)
    assert mt == mj
    assert _read(tann.ann_index_path(bank_t, 7)) == _read(jann.ann_index_path(bank_j, 7))
    (at, _), (aj, _) = tann.load_ann(os.path.join(bank_t, "7", "bank.npz")), \
        jann.load_ann(os.path.join(bank_j, "7", "bank.npz"))
    for key in ("centroids", "row_order", "cell_offsets"):
        assert np.array_equal(at[key], aj[key]) and at[key].dtype == aj[key].dtype
    # cross verification
    assert jann.verify_ann(bank_t, 7) is None and tann.verify_ann(bank_j, 7) is None
    feats, labels, _ = tbank.load_bank(os.path.join(bank_t, "7", "bank.npz"))
    for shards in (1, 3):
        for shard in range(shards):
            kw = dict(shard=shard, shards=shards, nprobe=4, rerank=20, num_classes=5)
            st, sj = tann.AnnShard(feats, labels, at, **kw), jann.AnnShard(feats, labels, aj, **kw)
            assert st.stats() == sj.stats()
            q = feats[11] + 0.05
            for got, want in zip(st.search(q), sj.search(q)):
                assert np.array_equal(got, want) and got.dtype == want.dtype
            assert st.classify(q) == sj.classify(q)
            assert st.recall_probe(queries=16) == sj.recall_probe(queries=16)
    assert tann.AnnShard(feats, labels, at, nprobe=4).recall_probe() >= 0.95
    assert tann.vote([(0.5, 2), (0.5, 1)], 0.07, 3) == jann.vote([(0.5, 2), (0.5, 1)], 0.07,
                                                                  3) == 1


def test_ann_refuses_torn_or_drifted_indexes(tmp_path):
    bank = _bank(tmp_path, "t", n=64)
    tann.build_ann_index(bank, 7, cells=4)
    path = os.path.join(bank, "7", "bank.npz")
    assert tann.load_ann(path) is not None
    index = tann.ann_index_path(bank, 7)
    data = bytearray(_read(index))
    data[-1] ^= 1
    with open(index, "wb") as f:
        f.write(bytes(data))
    assert tann.verify_ann(bank, 7) == jann.verify_ann(bank, 7) == "ann.npz sha256 mismatch"
    with pytest.raises(tann.AnnIndexError, match="rejected"):
        tann.load_ann(path)
    with pytest.raises(ValueError, match="ann cells must be >= 1"):
        tann.build_ann_index(bank, 7, cells=0)
    with pytest.raises(ValueError, match="0 <= shard < shards"):
        tann.AnnShard(np.zeros((1, 2)), np.zeros(1), {}, shard=2, shards=2)


def _port_export(path):
    from moco_tpu_torch.checkpoint import _save_flat, resnet_to_torchvision
    from moco_tpu_torch.models import build_backbone

    _save_flat(resnet_to_torchvision(build_backbone("resnet_tiny", cifar_stem=True)
                                     .state_dict(), prefix="module.encoder_q."), str(path))


def test_bank_build_cli_offline_on_the_cpu_and_exit_codes(tmp_path, capsys):
    images, labels = _corpus(20, size=32)
    corpus = tmp_path / "corpus.npz"
    np.savez(corpus, images=images, labels=labels)
    (tmp_path / "export" / "3").mkdir(parents=True)
    ck = tmp_path / "export" / "3" / "encoder.npz"
    _port_export(ck)
    base = ["--bank-dir", str(tmp_path / "bank"), "--corpus", str(corpus)]
    tiny = ["--arch", "resnet_tiny", "--cifar-stem", "--image-size", "32", "--buckets", "1,8"]
    assert bank_build_main(["--checkpoint", str(ck)] + base + tiny) == 45  # no card here
    assert "CUDA was requested" in capsys.readouterr().out
    assert bank_build_main(["--checkpoint", str(tmp_path / "nope.npz"), "--step", "1"]
                           + base) == 45
    loose = tmp_path / "loose.npz"
    loose.write_bytes(b"w")
    assert bank_build_main(["--checkpoint", str(loose)] + base) == 45
    np.savez(tmp_path / "bad.npz", images=images)
    assert bank_build_main(["--checkpoint", str(ck), "--bank-dir", str(tmp_path / "b"),
                            "--corpus", str(tmp_path / "bad.npz")]) == 45
    assert bank_build_main(["--checkpoint", str(ck), "--device", "cpu", "--shards", "2",
                            "--ann-cells", "4", "--telemetry-dir", str(tmp_path / "tel")]
                           + base + tiny) == 0
    bank_dir = str(tmp_path / "bank")
    assert jbank.verify_bank(bank_dir, 3) is None and jann.verify_ann(bank_dir, 3) is None
    meta = jbank.read_bank_meta(os.path.join(bank_dir, "3", "bank.npz"))
    assert meta["rows"] == 20 and meta["shards"] == 2
    kinds = [json.loads(ln)["event"] for ln in
             (tmp_path / "tel" / "events.jsonl").read_text().splitlines() if ln.strip()]
    assert kinds[0] == "build_start" and "build_done" in kinds and "ann_built" in kinds


def test_bank_build_cli_batch_lane_through_a_port_service(tmp_path):
    """`--fleet-url`: the rows go one by one as `tier: batch` requests to a
    running port service (a stub engine), and the bank is the same bytes
    as one built in-process with the same embedding."""
    from moco_tpu_torch.serve import EmbedService, ServeFrontend

    class Stub:
        image_size, buckets = S, (1, 4)

        def warmup(self):
            return D

        def embed(self, batch):
            return _embed_stub(batch)

    images, labels = _corpus(9)
    corpus = tmp_path / "corpus.npz"
    np.savez(corpus, images=images, labels=labels)
    ck = _ckpt(tmp_path, 12)
    service = EmbedService(Stub(), flush_ms=1.0, max_queue=16, request_deadline_ms=10_000.0)
    frontend = ServeFrontend(service, port=0)
    frontend.start()
    try:
        rc = []
        t = threading.Thread(target=lambda: rc.append(bank_build_main(
            ["--checkpoint", ck, "--bank-dir", str(tmp_path / "lane"), "--corpus", str(corpus),
             "--fleet-url", frontend.url, "--shards", "3", "--workers", "2"])))
        t.start()
        t.join(timeout=60.0)
        assert rc == [0]
        assert service.stats()["tiers"]["submitted"]["batch"] == 9 + 8
    finally:
        service.drain(timeout_s=10.0)
        frontend.shutdown()
    jbank.build_bank(str(tmp_path / "direct"), 12, images, labels, _embed_stub,
                     checkpoint_path=ck, image_size=S)
    assert _read(tmp_path / "lane" / "12" / "bank.npz") == \
        _read(tmp_path / "direct" / "12" / "bank.npz")
