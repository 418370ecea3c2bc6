"""The port's sharding rules (``repro_torch.models.sharding``) held to the
reference's on the CPU.

* ``param_specs``, ``zero1_specs``, ``batch_specs`` and ``cache_specs``
  equal the reference's leaf for leaf, exactly, for all ten
  architectures at full width, every shape's inputs, and the meshes
  (16, 16), (2, 16, 16), (32, 8), (2, 32, 8) and (1, 1).  The reference
  runs on a ``jax.sharding.AbstractMesh`` with its ``launch.specs``
  stand-ins; the port on a ``DeviceMesh`` over a fake process group with
  its fake-tensor stand-ins.  Only shapes are made: nothing is traced.
* A spec's DTensor placements, the hooks on plain tensors (the identity:
  ``NO_SHARD`` runs the plain code) and on DTensors (a redistribute).
"""
import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import torch  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro.configs.base import ARCH_IDS, SHAPES  # noqa: E402
from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro.models import sharding as JSH  # noqa: E402
from repro.optim import adamw as JADAM  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.models import sharding as shd  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from torch.distributed.tensor import (DTensor, Replicate,  # noqa: E402
                                      Shard, distribute_tensor)

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((32, 8), ("data", "model")),
          ((2, 32, 8), ("pod", "data", "model")),
          ((1, 1), ("data", "model"))]


@pytest.fixture
def fake_group():
    """Make fake meshes with ``M.fake_mesh``; the group is released
    after the test, so no other test sees it."""
    yield M.fake_mesh
    M.release()


def ref_leaves(specs):
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))]


def port_leaves(specs):
    return [tuple(s) for s in tree.leaves(specs)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_reference(arch, fake_group):
    jcfg, cfg = jax_config(arch), get_config(arch)
    jparams, params = JS.param_structs(jcfg), S.param_structs(cfg,
                                                              device="cpu")
    jopt, opt = JS.opt_structs(jparams), S.opt_structs(params)
    ins = {}
    for shape, sh in SHAPES.items():
        caches = None
        if sh["kind"] == "decode":
            caches = (JS.cache_structs(jcfg, sh["global_batch"],
                                       sh["seq_len"]),
                      S.cache_structs(cfg, sh["global_batch"],
                                      sh["seq_len"], device="cpu"))
        ins[shape] = (JS.batch_specs_for(jcfg, shape),
                      S.batch_specs_for(cfg, shape, device="cpu"), caches)
    for sizes, names in MESHES:
        dp = tuple(a for a in names if a in ("pod", "data"))
        jshard = JSH.ShardCfg(mesh=AbstractMesh(sizes, names), dp=dp)
        mesh = fake_group(sizes, names, "cpu")
        shard = shd.ShardCfg(mesh=mesh, dp=M.dp_axes(mesh))
        assert (shard.tp_size, shard.dp_size) == (jshard.tp_size,
                                                  jshard.dp_size)
        jp, pp = JSH.param_specs(jparams, jshard), shd.param_specs(params,
                                                                   shard)
        assert ref_leaves(jp) == port_leaves(pp), (arch, sizes)
        jo = JSH.zero1_specs(jopt, JADAM.OptState(jp, jp, jp, JSH.P()),
                             jshard)
        po = shd.zero1_specs(opt, adamw.OptState(pp, pp, pp, shd.P()), shard)
        assert ref_leaves(jo) == port_leaves(po), (arch, sizes)
        assert ref_leaves(JSH.zero1_specs(jparams, jp, jshard)) == \
            port_leaves(shd.zero1_specs(params, pp, shard))      # fsdp
        for shape, (jb, pb, caches) in ins.items():
            assert ref_leaves(JSH.batch_specs(jb, jshard)) == \
                port_leaves(shd.batch_specs(pb, shard)), (arch, sizes, shape)
            if caches:
                assert ref_leaves(JSH.cache_specs(caches[0], jshard)) == \
                    port_leaves(shd.cache_specs(caches[1], shard)), \
                    (arch, sizes, shape)
        M.release()


def test_leaf_paths_are_the_references():
    cfg = get_config("jamba-v0.1-52b").reduced()
    params = S.param_structs(cfg, device="cpu")
    jparams = JS.param_structs(jax_config("jamba-v0.1-52b").reduced())
    want = [JSH._path_str(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert [p for p, _ in tree.leaves_with_paths(params)] == want
    assert [tuple(t.shape) for t in tree.leaves(params)] == \
        [tuple(a.shape) for a in jax.tree_util.tree_leaves(jparams)]


def test_partition_spec_form():
    assert shd.P(("data",), None, "model") == ("data", None, "model")
    assert shd.P(("pod", "data"), None) == (("pod", "data"), None)
    assert tuple(PartitionSpec(("data",), None)) == tuple(
        shd.P(("data",), None))
    assert tree.leaves({"a": shd.P("model", None), "b": [shd.P()]}) == \
        [shd.P("model", None), shd.P()]


def test_placements_major_to_minor(fake_group):
    mesh = fake_group((2, 4, 2), ("pod", "data", "model"), "cpu")
    pl = shd.placements(shd.P(("pod", "data"), None, "model"), mesh)
    assert pl == (Shard(0), Shard(0), Shard(2))
    assert shd.placements(shd.P(None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        shd.placements(shd.P(("data", "pod")), mesh)
    with pytest.raises(ValueError):
        shd.placements(shd.P("model", "model"), mesh)
    # the split is JAX's: pod-major, data-minor
    x = distribute_tensor(torch.arange(16.0).reshape(16, 1), mesh, pl[:2] +
                          (Replicate(),))
    assert x.to_local().flatten().tolist() == [0.0, 1.0]
    assert shd.local_slices((16, 1), mesh, pl[:2] + (Replicate(),)) == \
        (slice(0, 2), slice(0, 1))


def test_hooks_leave_plain_tensors_alone():
    x = torch.randn(4, 8, 16)
    for shard in (shd.NO_SHARD, shd.ShardCfg(mesh=None, seq_shard=False)):
        assert shard.act_residual(x) is x
        assert shard.act_gathered(x) is x
        assert shard.act_logits(x) is x
        assert shard.constrain(x, shd.P("data", None, None)) is x
        assert (shard.tp_size, shard.dp_size) == (1, 1)
    named = shd.NamedSharding(None, (Shard(0),))
    assert shd.with_sharding_constraint(x, named) is x
    assert shd.reduce_partial(x) is x
    assert shd.replicate_dims(x, (1,)) is x
    assert shd.heads_ready(x, 3) is x and shd.heads_merged(x, 3) is x
    assert shd.pinned(x) is x
    assert shd.mesh_of(x, x) is None


def test_hooks_redistribute_dtensors(fake_group):
    mesh = fake_group((2, 2), ("data", "model"), "cpu")
    shard = shd.ShardCfg(mesh=mesh, dp=M.dp_axes(mesh))
    x = distribute_tensor(torch.randn(4, 8, 16), mesh,
                          (Shard(0), Replicate()))
    r = shard.act_residual(x)
    assert isinstance(r, DTensor) and r.placements == (Shard(0), Shard(1))
    assert shard.act_gathered(r).placements == (Shard(0), Replicate())
    assert shard.act_logits(x).placements == (Shard(0), Shard(2))
    assert shd.replicate_dims(r, (1,)).placements == (Shard(0),
                                                      Replicate())
    # heads: 16 columns split over 2 hold 4 heads whole, not 1 or 3
    h = shard.act_logits(x)
    assert shd.heads_ready(h, 4) is h
    assert shd.heads_ready(h, 3).placements == (Shard(0), Replicate())
    assert shd.even((Shard(0), Shard(2)), (4, 8, 3), mesh) == (Shard(0),
                                                               Replicate())
    assert shd.mesh_of(torch.ones(1), r) is mesh
    # S not divisible by tp: the sequence stays whole
    y = distribute_tensor(torch.randn(4, 3, 16), mesh,
                          (Shard(0), Replicate()))
    assert shard.act_residual(y).placements == (Shard(0), Replicate())
