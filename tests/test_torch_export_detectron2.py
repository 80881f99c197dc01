"""The port's Detectron2 export (`moco_tpu_torch/export_detectron2.py`): from
the same weights, the port's export and converter write the `.pkl` the JAX
package's export and converter write, key for key and array for array."""

import pickle
from types import SimpleNamespace

import jax
import numpy as np
import optax
import pytest

from moco_tpu import checkpoint as jckpt
from moco_tpu import export_detectron2 as jd2
from moco_tpu.models import resnet as jresnet
from moco_tpu.train_state import create_train_state
from moco_tpu_torch import checkpoint, export_detectron2
from moco_tpu_torch.models import resnet
from moco_tpu_torch.weights import params_from_jax

MODELS = {
    # the JAX converter test's model: BasicBlocks, CIFAR stem, a downsample
    "tiny": (lambda: jresnet.ResNetTiny(num_classes=32, cifar_stem=True),
             lambda: resnet.build_resnet("resnet_tiny", num_classes=32, cifar_stem=True), 16),
    # Bottlenecks with downsamples, the 7x7 stem and the v2 MLP head
    "bottleneck_mlp": (
        lambda: jresnet.ResNet(stage_sizes=(1, 1), block_cls=jresnet.Bottleneck, width=8,
                               num_classes=16, mlp_head=True),
        lambda: resnet.ResNet((1, 1), resnet.Bottleneck, width=8, num_classes=16,
                              mlp_head=True), 32),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def exports(request, tmp_path_factory):
    """(the JAX package's .pkl, the port's .pkl, the port's export path)."""
    jmodel_fn, tmodel_fn, img = MODELS[request.param]
    d = tmp_path_factory.mktemp(f"d2_{request.param}")
    state = create_train_state(jax.random.key(1), jmodel_fn(), optax.sgd(0.1),
                               (2, img, img, 3), 64, 16)
    jpath, jpkl = str(d / "jax.npz"), str(d / "jax.pkl")
    jckpt.export_encoder_q(state, jpath)
    jd2.convert(jpath, jpkl)
    model = tmodel_fn()
    np_tree = lambda t: jax.tree.map(lambda a: np.array(a, np.float32), t)  # noqa: E731
    model.load_state_dict(params_from_jax(np_tree(state.params_q), np_tree(state.batch_stats_q)))
    tpath, tpkl = str(d / "port.npz"), str(d / "port.pkl")
    checkpoint.export_encoder_q(SimpleNamespace(model_q=model), tpath)
    export_detectron2.main([tpath, tpkl])
    return jpkl, tpkl, tpath, jpath


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_pkl_equals_the_jax_packages(exports):
    jpkl, tpkl, _tpath, _jpath = exports
    ref, got = _load(jpkl), _load(tpkl)
    assert got.keys() == ref.keys()
    assert got["matching_heuristics"] is True and got["__author__"] == ref["__author__"]
    assert got["model"].keys() == ref["model"].keys()
    for key, arr in ref["model"].items():
        assert got["model"][key].dtype == arr.dtype, key
        np.testing.assert_array_equal(got["model"][key], arr, err_msg=key)
    assert "stem.conv1.norm.running_mean" in got["model"]
    assert any(".shortcut.norm." in k for k in got["model"])
    assert not any(k.startswith("fc") for k in got["model"])


def test_converter_reads_the_jax_export(exports, tmp_path):
    jpkl, _tpkl, _tpath, jpath = exports
    model = export_detectron2.convert(jpath, str(tmp_path / "from_jax.pkl"))
    ref = _load(jpkl)["model"]
    assert model.keys() == ref.keys()
    assert all(np.array_equal(model[k], ref[k]) for k in ref)


def test_converter_errors_match_the_jax_packages(exports, tmp_path):
    _jpkl, _tpkl, tpath, _jpath = exports
    flat = checkpoint.import_encoder_q(tpath)
    for fn in (export_detectron2.torchvision_flat_to_detectron2,
               jd2.torchvision_flat_to_detectron2):
        with pytest.raises(ValueError, match="no nope"):
            fn(flat, prefix="nope")
    tree = {"backbone/conv1/kernel": np.zeros((3, 3, 3, 8), np.float32)}
    np.savez(tmp_path / "tree.npz", **tree)
    with pytest.raises(ValueError, match="v3_tree"):
        export_detectron2.convert(str(tmp_path / "tree.npz"), str(tmp_path / "x.pkl"))
