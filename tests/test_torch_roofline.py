"""The port's roofline (``repro_torch.roofline``) on the CPU: the
counterparts of the reference's ``tests/test_roofline.py``.

* Bytes of a shape and dtype.
* The ring model on recorded collectives: an all-gather of bf16
  (2, 1024) -> (32, 1024) and an all-reduce of f32 (4096), each over 16
  ranks, give 32·1024·2·15/16 and 2·4096·4·15/16 bytes, as the
  reference's HLO parser gives for the same two collectives; recorded
  from DTensor redistributes on a fake mesh, with the group's axis and
  link (a 16-rank group crosses hosts of 8; a "model" group of 8 does
  not).
* The analytic ``flopcount.forward_flops`` against the port's counter
  (``roofline.analyze``) within 25% (the reference test's tolerance)
  for reduced yi-6b, mamba2-130m and deepseek-v2-lite-16b at B 4, S 64:
  the counterpart of the reference's analytic-vs-XLA test.
* The byte rules (views free, a gather reads its rows, ``copy_`` does not
  read its destination) and the memory analysis of known programs.
"""
import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import torch  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.tensor import (DTensor, Partial,  # noqa: E402
                                      Replicate, Shard)

from repro import roofline as JRL  # noqa: E402
from repro.configs.base import ARCH_IDS, SHAPES  # noqa: E402
from repro.configs.base import get_config as jax_config  # noqa: E402
from repro_torch import roofline as RL  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.flopcount import forward_flops  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.models.lm import forward  # noqa: E402

HLO = """
  %ag = bf16[32,1024]{1,0} all-gather(bf16[2,1024]{1,0} %x), replica_groups={{0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15}}, dimensions={0}
  %ar = f32[4096]{0} all-reduce(f32[4096]{0} %y), replica_groups=[16,16]<=[256], to_apply=%add
"""
AG = 32 * 1024 * 2 * (15 / 16)
AR = 2 * 4096 * 4 * (15 / 16)


@pytest.fixture
def fake_group():
    yield M.fake_mesh
    M.release()


def test_shape_bytes():
    assert RL.shape_bytes((16, 512, 6144), torch.bfloat16) == \
        JRL._shape_bytes("bf16[16,512,6144]") == 16 * 512 * 6144 * 2
    assert RL.shape_bytes((8,), torch.float32) == JRL._shape_bytes("f32[8]")
    assert RL.shape_bytes((4, 4), torch.bool) == JRL._shape_bytes("pred[4,4]")
    assert RL.shape_bytes((), torch.int32) == 4


def test_ring_model_on_records():
    recs = [RL.Collective("all-gather", 2 * 1024 * 2, 32 * 1024 * 2, 16),
            RL.Collective("all-reduce", 4096 * 4, 4096 * 4, 16)]
    st = RL.collective_stats(recs)
    ref = JRL.parse_collectives(HLO)
    assert st.counts == ref.counts == {"all-gather": 1, "all-reduce": 1}
    assert st.bytes_moved == pytest.approx(ref.bytes_moved)
    assert st.bytes_moved["all-gather"] == pytest.approx(AG)
    assert st.bytes_moved["all-reduce"] == pytest.approx(AR)
    assert st.host_bytes == 0.0
    rs = RL.Collective("reduce-scatter", 4096 * 4, 256 * 4, 16)
    a2a = RL.Collective("all-to-all", 4096 * 4, 4096 * 4, 16, ("model",),
                        crosses_hosts=False)
    assert rs.ring_bytes == a2a.ring_bytes == 4096 * 4 * 15 / 16
    st = RL.collective_stats([rs, a2a])
    assert st.host_bytes == a2a.ring_bytes      # over NVLink


def test_ring_model_on_recorded_dtensor_collectives(fake_group):
    mesh = fake_group((16,), ("data",), "cpu")

    def both(x, y):
        return (x.redistribute(mesh, (Replicate(),)),
                y.redistribute(mesh, (Replicate(),)))
    x = DTensor.from_local(torch.zeros(2, 1024, dtype=torch.bfloat16), mesh,
                           (Shard(0),), run_check=False)
    y = DTensor.from_local(torch.zeros(4096), mesh, (Partial(),),
                           run_check=False)
    c = RL.Counter(mesh)
    roof = RL.analyze(both, x, y, mesh=mesh, counter=c)
    assert roof.coll_counts == {"all-gather": 1, "all-reduce": 1}
    assert roof.coll_detail["all-gather"] == pytest.approx(AG)
    assert roof.coll_detail["all-reduce"] == pytest.approx(AR)
    assert {(r.axes, r.group_size, r.crosses_hosts)
            for r in c.collectives} == {(("data",), 16, True)}
    assert roof.t_collective == pytest.approx((AG + AR) / RL.LINK_BW)
    M.release()
    mesh = fake_group((2, 8), ("data", "model"), "cpu")
    z = DTensor.from_local(torch.zeros(2, 1024, dtype=torch.bfloat16), mesh,
                           (Replicate(), Shard(0)), run_check=False)
    c = RL.Counter(mesh)
    roof = RL.analyze(lambda t: t.full_tensor(), z, mesh=mesh, counter=c)
    (rec,) = c.collectives
    assert (rec.axes, rec.group_size, rec.crosses_hosts) == (("model",), 8,
                                                             False)
    assert roof.coll_host_bytes_per_chip == roof.coll_bytes_per_chip == \
        pytest.approx(16 * 1024 * 2 * 7 / 8)
    assert roof.t_collective == pytest.approx(
        roof.coll_bytes_per_chip / RL.NVLINK_BW)


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-130m",
                                  "deepseek-v2-lite-16b"])
def test_analytic_flops_vs_counted(arch):
    """Unsharded forward: the analytic counter within 25% of the port's
    dispatch-level count."""
    cfg = get_config(arch).reduced()
    B, Sq = 4, 64
    mode = FakeTensorMode()
    params = S.param_structs(cfg, mode, device="cpu")
    with mode:
        batch = {"tokens": torch.zeros((B, Sq), dtype=torch.int32)}
        roof = RL.analyze(lambda p, b: forward(p, cfg, b), params, batch)
    ours = forward_flops(cfg, B * Sq, Sq)
    assert ours == pytest.approx(roof.flops_per_chip, rel=0.25), \
        (ours, roof.flops_per_chip)
    assert roof.coll_counts == {}


def test_byte_rules():
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    c = RL.Counter()
    RL.analyze(lambda x, y: x @ y, a, b, counter=c)
    assert c.bytes == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert c.flops == 2 * 64 * 32 * 16
    c = RL.Counter()
    RL.analyze(lambda x: x.view(32, 64).t()[:, :3], a, counter=c)
    assert c.bytes == 0
    dst = torch.empty(64, 32)
    c = RL.Counter()
    RL.analyze(lambda d, s: d.copy_(s), dst, a, counter=c)
    assert c.bytes == 2 * 4 * 64 * 32
    idx = torch.tensor([1, 5, 7], dtype=torch.int64)
    c = RL.Counter()
    RL.analyze(lambda t, i: t[i], a, idx, counter=c)
    assert c.bytes == 3 * 8 + 2 * 3 * 32 * 4


def test_memory_analysis():
    n = 1024 * 4

    def temps(x):
        y = x * 2
        z = y + 1
        return z
    mem = RL.analyze(temps, torch.zeros(1024)).memory
    assert mem["argument_size_in_bytes"] == n
    assert mem["output_size_in_bytes"] == n
    assert mem["temp_size_in_bytes"] == n
    assert mem["alias_size_in_bytes"] == 0
    roof = RL.analyze(lambda x: x.add_(1), torch.zeros(1024))
    assert roof.memory["alias_size_in_bytes"] == n
    assert roof.memory["output_size_in_bytes"] == n
    assert roof.memory["temp_size_in_bytes"] == 0
    assert roof.peak_mem_bytes == n


def test_roofline_terms_and_model_flops():
    r = RL.Roofline(989e12, 3.35e12, 600e9, {}, {}, 0.0,
                    coll_host_bytes_per_chip=450e9)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(1.0)
    assert r.t_collective == pytest.approx(1.0 + 150e9 / 50e9)
    assert r.bottleneck == "collective" and r.t_bound == r.t_collective
    ref = JRL.Roofline(1.0, 1.0, 1.0, {}, {}, 0.0).as_dict()
    assert set(ref) <= set(r.as_dict())
    for arch in ARCH_IDS:
        for sh in SHAPES.values():
            assert RL.model_flops(get_config(arch), sh) == \
                JRL.model_flops(jax_config(arch), sh)
