"""The port's sharded serving path on a real process group, on the CPU:
ranks spawned over gloo (a ``FileStore`` under the test's temporary
directory, no port), each on one thread, held to the one-process
``NO_SHARD`` run and to the reference.

* Each of ``ARCHS`` (``test_torch_train.KINDS`` and the MQA granite-34b;
  reduced, float32 parameters) on (1, 2), (2, 2) and (1, 4) meshes:
  ``serve.engine.prefill`` of B prompts of S tokens padded to ``PAD``,
  then ``STEPS`` teacher-forced decode steps, the parameters placed by
  ``param_specs``, the batch and tokens by ``batch_specs`` and the
  caches by ``cache_specs`` (``prefill`` returns them placed).  Every
  logit within ``TOL`` of the largest ``NO_SHARD`` logit of the
  one-process run; after each step the token's cache entries (the whole
  leaf for the SSM's state and conv tail), gathered, within ``TOL`` of
  the largest of ``NO_SHARD``'s, and the caches the same tensors in the
  same placements.  The caches split along the sequence (granite and
  deepseek at every model axis of 2 or more, yi-6b's 2 KV heads at 4)
  are the ones whose writes ``sharding.write_at`` repairs: DTensor's
  ``cache[:, pos] = v`` writes nothing on them.
* On the (1, 1) host mesh (one process) every logit and cache leaf is
  bit-equal to ``NO_SHARD``'s.
* ``sharding.write_at`` on real DTensors of a (2, 2) mesh, the sequence
  split over one mesh dim, both (evenly and not) or none, equals the
  plain assignment at every position bit for bit.
* The reference's ``prefill`` and ``decode_step``, jitted with its
  ``cache_specs`` shardings on two XLA host devices, give the port's
  2-rank logits within ``REF_TOL`` for ``REF_ARCHS``.

One spawn group a world size (2 and 4 ranks) runs every case of that
size; the two groups and the reference's process run side by side while
this process computes the one-process runs.
"""
import datetime
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

from repro_torch import tree  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import sharding as shd  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train import step as S  # noqa: E402
from test_torch_train import KINDS, make_batch  # noqa: E402

#: a collective that waits longer than this fails the run (a hang must
#: not eat the suite's time limit)
GROUP_TIMEOUT_S = 120
#: the whole spawn groups' budget
RUN_TIMEOUT_S = 300
ARCHS = KINDS + ["granite-34b"]
MESHES = {2: ((1, 2),), 4: ((2, 2), (1, 4))}
SHAPES = ["1x2", "2x2", "1x4"]
#: prompts, their length, the caches' length, decode steps
B, PROMPT, PAD, STEPS = 4, 16, 32, 3
PARAM_SEED, BATCH_SEED = 3, 10
#: float32: a split product sums its partials in another order (about
#: 2e-6 of the largest logit seen)
TOL = 1e-5
#: the reference's sharded serving against the port's 2 ranks
REF_ARCHS = ("deepseek-v2-lite-16b", "granite-34b")
REF_TOL = 1e-4
#: the caches written at the token's position, by name: their sequence
#: dim counted from the end
SEQ_DIM = {"k": -3, "v": -3, "c": -2, "kr": -2}
#: written whole by each decode step (the SSM's)
WHOLE = ("state", "conv")


def f32(cfg):
    return tree.map(torch.Tensor.float,
                    lm.init_params(lm.generator(PARAM_SEED, "cpu"), cfg))


def requests(cfg) -> dict:
    """The prompts' and teacher-forced tokens (B, PROMPT + STEPS) and the
    frontend's inputs."""
    b = make_batch(cfg, B, PROMPT + STEPS, seed=BATCH_SEED)
    b.pop("labels")
    return {k: torch.from_numpy(v) for k, v in b.items()}


def whole(x) -> torch.Tensor:
    """A copy of ``x``, gathered (a cache changes in place, and a
    DTensor's ``full_tensor`` may be its local tensor itself)."""
    return (x.full_tensor() if isinstance(x, DTensor) else x).clone()


def written(caches, pos: int) -> dict:
    """Each cache leaf a decode step writes, gathered: the entry at
    ``pos`` of a sequence cache, the whole of the SSM's."""
    out = {}
    for path, x in tree.leaves_with_paths(caches):
        name = path.rsplit("/", 1)[-1]
        if name in SEQ_DIM:
            out[path] = whole(x).select(x.ndim + SEQ_DIM[name], pos)
        elif name in WHOLE:
            out[path] = whole(x)
    return out


def serve(cfg, shard, params) -> dict:
    """``prefill`` then ``STEPS`` teacher-forced decode steps on
    ``shard``: the logits (B, PROMPT + STEPS, V) and each step's written
    cache entries, gathered; the final cache leaves, gathered; whether
    the caches were placed by ``cache_specs`` after the prefill and after
    the last step, and kept in place; the paths split along their
    sequence over more than one card."""
    batch = requests(cfg)
    toks = batch["tokens"]
    pre = dict(batch, tokens=toks[:, :PROMPT])
    logits, caches = engine.prefill(params, cfg, S.place_batch(pre, shard),
                                    shard, pad_to=PAD, device="cpu")
    first = tree.leaves(caches)
    placed = [placed_by_specs(caches, shard)]
    step = engine.make_decode_step(cfg, shard, device="cpu")
    out, entries = [whole(logits)], []
    for t in range(STEPS):
        tok = S.place_batch({"tokens": toks[:, PROMPT + t:PROMPT + t + 1]},
                            shard)["tokens"]
        lg, caches = step(params, tok, caches, PROMPT + t)
        out.append(whole(lg))
        entries.append(written(caches, PROMPT + t))
    placed.append(placed_by_specs(caches, shard))
    return {"logits": torch.cat(out, 1), "entries": entries,
            "leaves": [whole(x) for x in tree.leaves(caches)],
            "placed": all(placed),
            "in_place": all(a is b for a, b in zip(first,
                                                   tree.leaves(caches))),
            "seq_split": seq_split(caches)}


def placed_by_specs(caches, shard) -> bool:
    if shard.mesh is None:
        return not any(isinstance(x, DTensor) for x in tree.leaves(caches))
    mesh = shard.mesh
    return all(isinstance(x, DTensor) and tuple(x.placements) == shd.even(
        shd.placements(sp, mesh), x.shape, mesh)
        for x, sp in zip(tree.leaves(caches),
                         tree.leaves(shd.cache_specs(caches, shard))))


def seq_split(caches) -> list:
    out = []
    for path, x in tree.leaves_with_paths(caches):
        name = path.rsplit("/", 1)[-1]
        if name in SEQ_DIM and isinstance(x, DTensor) and any(
                isinstance(p, shd.Shard) and p.dim == x.ndim + SEQ_DIM[name]
                and x.device_mesh.shape[i] > 1
                for i, p in enumerate(x.placements)):
            out.append(path)
    return out


def placed_params(cfg, shard):
    params = f32(cfg)
    return train.place(params, train.param_shardings(params, shard))


# ---------------------------------------------------------------- ranks
def _write_at_cases(mesh) -> dict:
    """``write_at`` on DTensors of ``mesh`` (2, 2): a (2, n, 4, 2) cache
    in each placement, a token written at every position (the value
    arriving replicated, split on the data axis, or plain), against the
    plain assignment: bit-equal, gathered."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    R, S1 = Replicate(), Shard(1)
    cases = {"seq_on_model": (8, (R, S1)), "seq_on_both": (8, (S1, S1)),
             "seq_uneven": (5, (S1, S1)), "seq_on_data": (6, (S1, R)),
             "batch_and_seq": (8, (Shard(0), S1)),
             "heads": (8, (R, Shard(2))), "replicated": (8, (R, R))}
    gen = torch.Generator().manual_seed(1)
    out = {}
    for name, (n, pl) in cases.items():
        want = torch.zeros(2, n, 4, 2)
        got = distribute_tensor(want.clone(), mesh, pl)
        for pos in range(n):
            v = torch.randint(1, 9, (2, 4, 2), generator=gen).float()
            want[:, pos] = v
            arrive = (v, distribute_tensor(v, mesh, (R, R)),
                      distribute_tensor(v, mesh, (Shard(0), R)))[pos % 3]
            shd.write_at(got, 1, pos, arrive)
        out[name] = {"equal": torch.equal(got.full_tensor(), want),
                     "placements": str(tuple(got.placements))}
    return out


def _rank_main(rank: int, world: int, store: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    out = Path(out)
    meta = {}
    try:
        for shape in MESHES[world]:
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            shard = shd.ShardCfg(mesh=mesh, dp=M.dp_axes(mesh))
            tag = "x".join(map(str, shape))
            for arch in ARCHS:
                cfg = get_config(arch).reduced()
                run = serve(cfg, shard, placed_params(cfg, shard))
                if rank == 0:
                    torch.save(run, out / f"serve_{tag}_{arch}.pt")
            if shape == (2, 2):
                meta["write_at"] = _write_at_cases(mesh)
        if rank == 0:
            (out / f"world{world}.json").write_text(json.dumps(meta))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- parent
REFERENCE_SCRIPT = """
import sys
import numpy as np
import jax, jax.numpy as jnp
import repro.models.layers as JL
from jax.sharding import AxisType
JL.PDT = jnp.float32
# jax 0.9's make_mesh gives Explicit axes, on which the reference's
# with_sharding_constraint refuses a spec: Auto axes, as it was written for
_make_mesh = jax.make_mesh


def _auto_mesh(shape, names, **kw):
    kw.setdefault("axis_types", (AxisType.Auto,) * len(names))
    return _make_mesh(shape, names, **kw)


jax.make_mesh = _auto_mesh
from repro.configs.base import get_config
from repro.launch.mesh import make_host_mesh, dp_axes
from repro.models import sharding as shd
from repro.models.lm import decode_step
from repro.serve.engine import prefill
from repro_torch.configs.base import get_config as port_config
from test_torch_train import f32_params, make_batch
out, B, PROMPT, PAD, STEPS, PSEED, BSEED = sys.argv[1], *map(
    int, sys.argv[2:8])
mesh = make_host_mesh()
shard = shd.ShardCfg(mesh=mesh, dp=dp_axes(mesh))


def named(specs):
    return jax.tree_util.tree_map(shard.named, specs)


for arch in sys.argv[8:]:
    cfg = get_config(arch).reduced()
    jp, _ = f32_params(port_config(arch).reduced(), PSEED)
    toks = jnp.asarray(make_batch(cfg, B, PROMPT + STEPS, BSEED)["tokens"])
    pre = {"tokens": toks[:, :PROMPT]}
    pshard, bshard = named(shd.param_specs(jp, shard)), named(
        shd.batch_specs(pre, shard))
    logits, caches = jax.jit(
        lambda p, b: prefill(p, cfg, b, shard, pad_to=PAD),
        in_shardings=(pshard, bshard))(jp, pre)
    cshard = named(shd.cache_specs(caches, shard))
    dec = jax.jit(lambda p, t, c, pos: decode_step(p, cfg, t, c, pos, shard),
                  in_shardings=(pshard, bshard["tokens"], cshard,
                                shard.named(shd.P())),
                  out_shardings=(None, cshard))
    outs = [logits]
    for t in range(STEPS):
        lg, caches = dec(jp, toks[:, PROMPT + t:PROMPT + t + 1], caches,
                         jnp.int32(PROMPT + t))
        outs.append(lg)
    np.save(f"{out}/reference_{arch}.npy",
            np.asarray(jnp.concatenate(outs, 1), np.float32))
print(dict(zip(mesh.axis_names, mesh.devices.shape)))
"""


def _one_process() -> dict:
    """``NO_SHARD`` for each arch, and the same on the (1, 1) host
    mesh."""
    res = {"no_shard": {}, "one_rank": {}}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        res["no_shard"][arch] = serve(cfg, shd.NO_SHARD, f32(cfg))
    mesh = M.make_host_mesh("cpu")
    try:
        shard = shd.ShardCfg(mesh=mesh, dp=M.dp_axes(mesh))
        for arch in ARCHS:
            cfg = get_config(arch).reduced()
            res["one_rank"][arch] = serve(cfg, shard,
                                          placed_params(cfg, shard))
    finally:
        M.release()
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_serve")
    tests = str(Path(__file__).resolve().parent)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.pathsep.join(
                   [tests] + [p for p in sys.path if p]))
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE_SCRIPT, str(out)] +
        [str(v) for v in (B, PROMPT, PAD, STEPS, PARAM_SEED, BATCH_SEED)] +
        list(REF_ARCHS), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    groups = {w: mp.start_processes(
        _rank_main, args=(w, str(out / f"store{w}"), str(out)), nprocs=w,
        join=False, start_method="spawn") for w in MESHES}
    t0 = time.time()
    threads = torch.get_num_threads()
    try:
        # this process shares the cores with the ranks
        torch.set_num_threads(min(threads, 2))
        one = _one_process()
        for w, ctx in groups.items():
            while not ctx.join(timeout=1):
                if time.time() - t0 > RUN_TIMEOUT_S:
                    raise TimeoutError(f"the {w}-rank group ran past "
                                       f"{RUN_TIMEOUT_S} s")
        stdout, stderr = ref.communicate(timeout=RUN_TIMEOUT_S)
        assert ref.returncode == 0, stderr[-3000:]
    finally:
        torch.set_num_threads(threads)
        for ctx in groups.values():
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    meta = {}
    for w in MESHES:
        meta.update(json.loads((out / f"world{w}.json").read_text()))
    return {"out": out, "one": one, "meta": meta,
            "reference_mesh": stdout.strip().splitlines()[-1]}


def ranks_run(runs, shape, arch) -> dict:
    return torch.load(runs["out"] / f"serve_{shape}_{arch}.pt")


def assert_within(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= TOL * scale, (what, err, scale)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serving_equals_no_shard(runs, arch, shape):
    got, want = ranks_run(runs, shape, arch), runs["one"]["no_shard"][arch]
    assert got["placed"] and got["in_place"]
    assert_within(got["logits"], want["logits"], "logits")
    for t, (g, w) in enumerate(zip(got["entries"], want["entries"])):
        assert sorted(g) == sorted(w)
        for path in w:
            assert float(w[path].abs().max()) > 0, (t, path)
            assert_within(g[path], w[path], (t, path))
    for i, (g, w) in enumerate(zip(got["leaves"], want["leaves"])):
        assert_within(g, w, ("leaf", i))
    # the caches whose writes only write_at lands (DTensor's setitem
    # leaves them at zero): MLA's, and k / v where the KV heads do not
    # divide the model axis
    cfg, tp = get_config(arch).reduced(), int(shape[-1])
    attn = "attn" in cfg.layer_kinds()
    split = cfg.mla or (attn and cfg.n_kv_heads % tp != 0)
    assert bool(got["seq_split"]) == split, got["seq_split"]


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_serves_bit_equal_to_no_shard(runs, arch):
    got, want = runs["one"]["one_rank"][arch], runs["one"]["no_shard"][arch]
    assert got["placed"] and got["in_place"] and want["in_place"]
    assert torch.equal(got["logits"], want["logits"])
    for g, w in zip(got["entries"], want["entries"]):
        assert all(torch.equal(g[p], w[p]) for p in w)
    assert len(got["leaves"]) == len(want["leaves"])
    assert all(torch.equal(a, b)
               for a, b in zip(got["leaves"], want["leaves"]))


WRITE_AT = ["seq_on_model", "seq_on_both", "seq_uneven", "seq_on_data",
            "batch_and_seq", "heads", "replicated"]


@pytest.mark.parametrize("case", WRITE_AT)
def test_write_at_on_real_collectives(runs, case):
    r = runs["meta"]["write_at"][case]
    assert r["equal"], r


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_reference_sharded_serving_equals_two_ranks(runs, arch):
    assert runs["reference_mesh"] == "{'data': 1, 'model': 2}"
    want = torch.from_numpy(np.load(runs["out"] / f"reference_{arch}.npy"))
    got = ranks_run(runs, "1x2", arch)["logits"]
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= REF_TOL * max(float(want.abs().max()), 1.0), err


def test_write_at_on_a_plain_tensor_is_the_assignment():
    gen = torch.Generator().manual_seed(0)
    cache = torch.randn(3, 2, 5, 4, generator=gen)
    want = cache.clone()
    v = torch.randn(3, 2, 4, generator=gen).to(torch.bfloat16)
    want[:, :, 3] = v
    shd.write_at(cache, 2, 3, v)
    assert torch.equal(cache, want)
