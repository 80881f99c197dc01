"""The pieces of the port's FSDP (`parallel/fsdp.py`, `parallel/mesh.py`'s 2-D
layout, the two-hop reduce, the sidecar's `sharding` stamp) against the JAX
package's pieces, which run here.

Under jax 0.9 the JAX package's own FSDP step does not run: every test of
`tests/test_fsdp.py` that steps it (`test_fsdp_fused_bitwise_parity_with_dp`,
`test_fsdp_params_actually_sharded`, `test_fsdp_state_bytes_quarter_of_dp`,
the bucketed, fsdp_tp, quantized, multi-hop and demo parity tests,
`test_fsdp_4_to_2_restore_rebuilds_ef_fresh_zero` and the driver tests)
fails at `moco_tpu/parallel/gradsync.py:389` (a psum over ('data', 'fsdp')
of an input that varies only over 'fsdp'), the 4 -> 2 restore also at an
Orbax tree mismatch. What takes their place: here, the layouts and
messages of `mesh_for_config`, `default_fsdp_size` and the config's
checks, `ShardingPlan.leaf_axis` over every leaf of the JAX test's tiny
ViT, the two-hop reduce at 8 gloo ranks (2 x 4) against
`multihop_quantized_psum_mean` on `mesh8`, `GradSync.for_mesh(...).describe`'s
`multihop` block and the sidecar stamp read by `read_recorded_sharding`;
in `tests/test_torch_fsdp_step.py`, the port's FSDP step held bit for bit
against the port's dp step, and against the JAX package's dp step, which
runs.

The two-hop reduce: each rank's [64] row of one [8, 64] draw. The means
are held within 1e-6 of their largest |value| (measured: equal, 0). Each
rank's error is the intra-group sum less what the wire carried for it,
over 4: gloo adds the 4 rows of a group in another order than XLA's psum,
which moves a sum by up to half its ulp and the error by as much, so the
errors are held within 1e-6 of the largest |intra-group sum| they were
taken from (measured: 2.7e-8 int8, 2.4e-8 bf16; against the largest
|error| that is 2.7e-5 and 3.1e-5).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from moco_tpu.checkpoint import read_recorded_sharding as jax_read_recorded_sharding
from moco_tpu.checkpoint import write_position as jax_write_position
from moco_tpu.config import PretrainConfig as JaxConfig
from moco_tpu.models.vit import ViT as JaxViT
from moco_tpu.parallel import fsdp as jfsdp
from moco_tpu.parallel.collectives import multihop_quantized_psum_mean
from moco_tpu.parallel.gradsync import GradSync as JaxGradSync
from moco_tpu.parallel.mesh import create_mesh, create_mesh_2d, mesh_for_config
from moco_tpu.parallel.mesh import default_fsdp_size as jax_default_fsdp_size
from moco_tpu.utils.compat import shard_map
from moco_tpu.v3_step import V3Model as JaxV3Model
from moco_tpu_torch.checkpoint import read_recorded_sharding, write_position
from moco_tpu_torch.config import PretrainConfig, add_config_flags
from moco_tpu_torch.parallel.fsdp import ShardingPlan
from moco_tpu_torch.parallel.gradsync import GradSync
from moco_tpu_torch.parallel.mesh import Layout, default_fsdp_size, layout_for_config
from moco_tpu_torch.weights import params_from_jax
from torch_dist_worker import _fsdp_model, spawn

TINY = dict(patch=8, width=32, depth=2, heads=2, image_size=16, embed_dim=16, hidden_dim=32)
BASE = dict(variant="v3", arch="vit_small", embed_dim=16, optimizer="adamw", lr=1e-3,
            weight_decay=0.1, batch_size=16)
MULTIHOP_RTOL = 1e-6


def _layout(data: int, fsdp: int) -> Layout:
    return Layout(data, fsdp, None, None, 0)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("mode,axis", [("dp", 0), ("fsdp", 0), ("fsdp_tp", 0),
                                       ("fsdp_tp", 2), ("fsdp_tp", 4)])
def test_layout_matches_mesh_for_config(mesh8, n, mode, axis):
    """`layout_for_config` gives the JAX mesh's shape, and fails where
    `mesh_for_config` does, with its message."""
    kw = dict(BASE, sharding=mode, sharding_axis_size=axis)
    devices = list(mesh8.devices.flat)[:n]
    try:
        mesh = mesh_for_config(JaxConfig(**kw), create_mesh(n, devices=devices))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            layout_for_config(PretrainConfig(**kw), n)
        assert str(got.value) == str(e)
        return
    shape = tuple(mesh.devices.shape)
    assert layout_for_config(PretrainConfig(**kw), n) == (shape if mode != "dp" else (n, 1))


def test_defaults_and_messages(mesh8):
    for n in range(1, 9):
        for mode in ("fsdp", "fsdp_tp"):
            assert default_fsdp_size(mode, n) == jax_default_fsdp_size(mode, n), (mode, n)
    devices = list(mesh8.devices.flat)[:4]
    # an fsdp sub-group, and a size that does not divide: the JAX messages
    for kw in (dict(sharding="fsdp", sharding_axis_size=2),
               dict(sharding="fsdp_tp", sharding_axis_size=3)):
        with pytest.raises(ValueError) as want:
            mesh_for_config(JaxConfig(**BASE, **kw), create_mesh(4, devices=devices))
        with pytest.raises(ValueError) as got:
            layout_for_config(PretrainConfig(**BASE, **kw), 4)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(sharding="zero3"),
    dict(sharding="fsdp", variant="v2"),
    dict(sharding="fsdp_tp", sharding_axis_size=-1),
    dict(sharding="fsdp", zero_sharding=True),
    dict(sharding="fsdp_tp", zero_sharding=True),
])
def test_config_rejects_as_jax(kw):
    """The config's sharding checks raise the JAX package's messages."""
    kw = dict(BASE, **kw)
    with pytest.raises(ValueError) as want:
        JaxConfig(**kw)
    with pytest.raises(ValueError) as got:
        PretrainConfig(**kw)
    assert str(got.value) == str(want.value)


def test_flags_and_defaults():
    import argparse

    parser = argparse.ArgumentParser()
    add_config_flags(parser)
    args = parser.parse_args(["--sharding", "fsdp_tp", "--sharding-axis-size", "2"])
    assert (args.sharding, args.sharding_axis_size) == ("fsdp_tp", 2)
    config = PretrainConfig()
    assert (config.sharding, config.sharding_axis_size) == ("dp", 0)
    assert (config.sharding, config.sharding_axis_size) == (JaxConfig().sharding,
                                                           JaxConfig().sharding_axis_size)


@pytest.fixture(scope="module")
def jax_tiny_params():
    model = JaxV3Model(JaxViT(patch_size=8, width=32, depth=2, num_heads=2, num_classes=None),
                       embed_dim=16, hidden_dim=32)
    variables = model.init(jax.random.key(0), jnp.zeros((2, 16, 16, 3)), train=False,
                           predict=True)
    return jax.tree.map(np.asarray, variables["params"])


@pytest.mark.parametrize("k", [2, 4, 8])
def test_leaf_axis_matches_jax_plan(mesh8, jax_tiny_params, k):
    """Every leaf of the JAX test's tiny ViT: the port's axis is the JAX
    rule's on the port's shape, and the shard holds the same share of the
    leaf as the JAX device's shard of the JAX leaf."""
    jplan = jfsdp.ShardingPlan("fsdp", create_mesh_2d(k, devices=list(mesh8.devices.flat)[:k]))
    plan = ShardingPlan(_layout(1, k))
    # each JAX leaf filled with its shard's share, carried to the port's names
    shares = params_from_jax(jax.tree.map(
        lambda a: np.full(a.shape, 1.0 / k if jplan.leaf_axis(a.shape) is not None else 1.0,
                          np.float32), jax_tiny_params))
    model = _fsdp_model(TINY)
    named = dict(model.named_parameters())
    assert named.keys() == shares.keys()
    for name, p in named.items():
        axis = plan.leaf_axis(p.shape)
        assert axis == jplan.leaf_axis(tuple(p.shape)), name
        share = 1.0 / k if axis is not None else 1.0
        assert share == float(shares[name].reshape(-1)[0]), name


def test_describe_multihop_matches_jax(mesh8):
    """`describe()` of the quantized sync on a 2 x 4 layout: the JAX
    `GradSync.for_mesh(...).describe`'s bytes and `multihop` block over the
    same parameters (the trainable ones: the port syncs no frozen leaf);
    a 1 x 4 fsdp layout is single-hop with the dp accounting."""
    model = _fsdp_model(TINY)
    trainable = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    tree = {n.replace(".", "/"): jnp.zeros(tuple(p.shape)) for n, p in trainable}
    mesh2d = create_mesh_2d(4, devices=list(mesh8.devices.flat))
    for quant in ("int8", "bfloat16"):
        kw = dict(BASE, sharding="fsdp_tp", sharding_axis_size=4, grad_sync="quantized",
                  grad_sync_quant_dtype=quant)
        want = JaxGradSync.for_mesh(JaxConfig(**kw), mesh2d).describe(tree)
        gs = GradSync(PretrainConfig(**kw), None, _layout(2, 4))
        assert gs.multihop
        got = gs.describe(model.named_parameters())
        assert got["multihop"] == want["multihop"]
        assert got["sync_bytes_per_step"] == want["sync_bytes_per_step"]
    kw = dict(BASE, sharding="fsdp", grad_sync="quantized")
    single = GradSync(PretrainConfig(**kw), None, _layout(1, 4))
    info = single.describe(model.named_parameters())
    assert not single.multihop and "multihop" not in info
    assert info["sync_bytes_per_step"] == GradSync(PretrainConfig(**BASE, grad_sync="quantized"),
                                                   None).describe(
        model.named_parameters())["sync_bytes_per_step"]


def test_multihop_reduce_matches_jax(mesh8, tmp_path):
    """The two-hop reduce at 8 gloo ranks (2 x 4 layout) against
    `multihop_quantized_psum_mean` on the same rows of one [8, 64] draw:
    the means within MULTIHOP_RTOL of their largest |value|, each rank's
    error within MULTIHOP_RTOL of the largest |intra-group sum| (see the
    module docstring); one int8 and one bf16 wire."""
    x = np.asarray(jax.random.normal(jax.random.key(0), (8, 64)))
    mesh2d = create_mesh_2d(4, devices=list(mesh8.devices.flat))
    want = {}
    for wire in ("int8", "bfloat16"):
        def multi(v, wire=wire):
            means, errs = multihop_quantized_psum_mean([v.reshape(-1)], "data", "fsdp", 2, 4,
                                                       wire)
            return means[0], errs[0]

        f = jax.jit(shard_map(multi, mesh=mesh2d, in_specs=(P(("data", "fsdp")),),
                              out_specs=(P(), P(("data", "fsdp")))))
        mean, errs = f(x)
        want[wire] = (np.asarray(mean), np.asarray(errs).reshape(8, 64))
    inputs = os.path.join(tmp_path, "inputs.pt")
    torch.save({"x": torch.from_numpy(x.copy()),
                "config": dict(BASE, sharding="fsdp_tp", sharding_axis_size=4)}, inputs)
    spawn("run_multihop", 8, (inputs, str(tmp_path)))
    intra_sum = np.abs(x.reshape(2, 4, 64).sum(axis=1)).max()
    for wire, (mean, errs) in want.items():
        for r in range(8):
            got = torch.load(os.path.join(tmp_path, f"multihop_rank{r}.pt"))[wire]
            assert got["layout"] == (2, 4, r % 4)
            np.testing.assert_allclose(got["mean"].numpy(), mean, rtol=0,
                                       atol=MULTIHOP_RTOL * np.abs(mean).max())
            np.testing.assert_allclose(got["err"].numpy(), errs[r], rtol=0,
                                       atol=MULTIHOP_RTOL * intra_sum)


def test_sidecar_stamp_both_ways(tmp_path):
    """The port's `sharding` stamp is read by the JAX reader and the JAX
    stamp by the port's; a sidecar without one reads None in both."""
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    for mode, step in (("fsdp", 3), ("fsdp_tp", 6), ("dp", 9)):
        write_position(port_dir, step, (0, step), devices=4, sharding=mode)
        jax_write_position(jax_dir, step, (0, step), devices=4, sharding=mode)
        assert jax_read_recorded_sharding(port_dir, step) == mode
        assert read_recorded_sharding(jax_dir, step) == mode
        with open(os.path.join(port_dir, ".position", f"{step}.json")) as a, \
                open(os.path.join(jax_dir, ".position", f"{step}.json")) as b:
            assert a.read() == b.read()
    write_position(port_dir, 12, (1, 0), devices=4)
    assert jax_read_recorded_sharding(port_dir, 12) is None
    assert read_recorded_sharding(port_dir, 12) is None
    assert read_recorded_sharding(port_dir, 99) is None
