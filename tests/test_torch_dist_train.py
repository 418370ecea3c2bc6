"""The port's sharded training step on a real process group, on the CPU:
ranks spawned over gloo (a ``FileStore`` under the test's temporary
directory, no port), each on one thread, held to the one-process
``NO_SHARD`` step and to the reference.

* 3 steps of each ``KINDS`` architecture (reduced, float32 parameters)
  on (1, 2) and (2, 2) meshes, the parameters placed by
  ``param_specs``, the optimizer state by ``zero1_specs`` and the batch
  by ``batch_specs``: loss, xent and grad norm within ``LOSS_RTOL_3`` of
  the ``NO_SHARD`` steps', the first step's gradients within
  ``GRAD_TOL`` of each leaf's norm;
* on a (1, 1) mesh (the one-process host mesh) the losses and every
  leaf are bit-equal to ``NO_SHARD``'s;
* the reference's trainer step (its ``make_host_mesh`` over two XLA
  host devices, ``ShardCfg``, float32) gives the 3 losses of the port's
  2-rank step within ``LOSS_RTOL_3``;
* ``launch.train.main`` (float32 parameters) on 2 ranks prints the real
  mesh and gives the one-process trainer's losses within ``LOSS_RTOL_3``,
  with the same ``--fail-at`` replay, and its last checkpoint's leaves
  within ``GRAD_TOL`` of each leaf's norm;
* a checkpoint saved under (2, 2) restores onto (1, 4) with the asked
  placements, every leaf bit-equal; 2 more steps there equal 2 more on
  (2, 2) within ``LOSS_RTOL_3``; the reference's ``restore`` and the
  port's one-process ``restore`` read that file bit-equal;
* the host group's rules (``launch.mesh``).

One spawn group a world size (2 and 4 ranks) runs every case of that
size; the two groups and the reference's process run side by side while
this process computes the one-process steps.
"""
import contextlib
import datetime
import io
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
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import step as S  # noqa: E402
from test_torch_train import (GRAD_TOL, KINDS, LOSS_RTOL_3,  # noqa: E402
                              make_batch)

#: a collective that waits longer than this fails the run (a hang must
#: not eat the suite's time limit)
GROUP_TIMEOUT_S = 120
#: the whole spawn groups' budget
RUN_TIMEOUT_S = 300
MESHES = {2: ((1, 2),), 4: ((2, 2),)}
OPT = dict(lr=1e-3, warmup=2)
#: the reference comparison: ``test_torch_train``'s short sequence,
#: where the reference's SSD gradient stays finite
REF_ARCH, REF_SEED, REF_B, REF_S = "mamba2-130m", 5, 2, 16
#: the re-shard case: saved under (2, 2) after 3 steps, restored on (1, 4)
RESHARD_ARCH = "yi-6b"
TRAIN_ARGS = ["--arch", "mamba2-130m", "--reduced", "--batch", "4",
              "--seq", "32", "--device", "cpu", "--ckpt-every", "2",
              "--log-every", "1", "--steps", "6", "--fail-at", "3"]


def f32(cfg, seed):
    """The float32 parameters of ``test_torch_train.f32_params`` (the
    port's side)."""
    return tree.map(torch.Tensor.float,
                    lm.init_params(lm.generator(seed, "cpu"), cfg))


def batches(cfg, n, B=4, S_=16):
    return [{k: torch.from_numpy(v.copy())
             for k, v in make_batch(cfg, B, S_, seed=10 + i).items()}
            for i in range(n)]


def floats(m) -> dict:
    return {k: float(m[k]) for k in ("loss", "xent", "grad_norm")}


def run_steps(cfg, shard, params, opt, bs, grads=None):
    """The train steps of ``bs`` from (params, opt): (params, opt, each
    step's metrics).  With a list ``grads``, the first step is taken as
    ``make_train_step`` takes it, by hand, and its gradients (whole)
    are appended to the list."""
    ocfg = adamw.AdamWConfig(**OPT)
    step = S.make_train_step(cfg, ocfg, shard)
    out = []
    for i, b in enumerate(bs):
        if i == 0 and grads is not None:
            (loss, m), g = S.value_and_grad(params, cfg,
                                            S.place_batch(b, shard), shard)
            with torch.no_grad():
                params, opt, gnorm = adamw.update(g, opt, params, ocfg)
            m = {k: S.replicated_value(v)
                 for k, v in dict(m, loss=loss, grad_norm=gnorm).items()}
            grads.extend(full(g))
        else:
            params, opt, m = step(params, opt, b)
        out.append(floats(m))
    return params, opt, out


def placed_state(cfg, shard, seed=3):
    """Seeded float32 (params, opt) placed on ``shard.mesh`` as the
    trainer places them."""
    params = f32(cfg, seed)
    return train.place((params, adamw.init(params)),
                       train.shardings(params, shard))


def full(t):
    return [x.full_tensor() if isinstance(x, DTensor) else x
            for x in tree.leaves(t)]


# ---------------------------------------------------------------- ranks
def _sharded_steps(mesh, out: Path, tag: str, keep: dict) -> dict:
    """Each ``KINDS`` arch: the first step's gradients (saved whole by
    rank 0) and 3 steps' metrics on ``mesh``; the state after them of
    ``RESHARD_ARCH`` kept in ``keep``."""
    shard = shd.ShardCfg(mesh=mesh, dp=M.dp_axes(mesh))
    res = {}
    for arch in KINDS:
        cfg = get_config(arch).reduced()
        params, opt = placed_state(cfg, shard)
        grads = []
        params, opt, res[arch] = run_steps(cfg, shard, params, opt,
                                           batches(cfg, 3), grads)
        if dist.get_rank() == 0:
            torch.save(grads, out / f"grads_{tag}_{arch}.pt")
        if arch == RESHARD_ARCH:
            keep.update(mesh=mesh, shard=shard, state=(params, opt))
    return res


def _reference_case(mesh) -> list:
    cfg = get_config(REF_ARCH).reduced()
    shard = shd.ShardCfg(mesh=mesh, dp=M.dp_axes(mesh))
    params, opt = placed_state(cfg, shard, REF_SEED)
    bs = [{k: torch.from_numpy(v.copy()) for k, v in
           make_batch(cfg, REF_B, REF_S, seed=10 + i).items()}
          for i in range(3)]
    return [m["loss"] for m in run_steps(cfg, shard, params, opt, bs)[2]]


@contextlib.contextmanager
def f32_trainer():
    """``launch.train`` drawing float32 parameters (its own are
    bfloat16), as the other cases here take them: ``LOSS_RTOL_3`` then
    holds its runs on different meshes to each other."""
    init = train.init_params
    train.init_params = lambda gen, cfg: tree.map(torch.Tensor.float,
                                                  init(gen, cfg))
    try:
        yield
    finally:
        train.init_params = init


def _trainer(out: Path, name: str) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), f32_trainer():
        run = train.main(TRAIN_ARGS + ["--ckpt", str(out / name)])
    return dict(run, stdout=buf.getvalue())


def _reshard(out: Path, kept: dict) -> dict:
    """After 3 steps on (2, 2) (``kept``): a checkpoint, 2 more steps;
    the checkpoint restored onto (1, 4), its leaves and placements, and
    the same 2 steps there."""
    cfg = get_config(RESHARD_ARCH).reduced()
    bs = batches(cfg, 5)[3:]
    params, opt = kept["state"]
    path = out / "reshard_ckpt"
    ckpt.save(str(path), 3, (params, opt), extra={"arch": cfg.name})
    saved = full((params, opt))
    after22 = run_steps(cfg, kept["shard"], params, opt, bs)[2]
    m14 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    s14 = shd.ShardCfg(mesh=m14, dp=("data",))
    like = f32(cfg, 7)
    named = train.shardings(like, s14)
    like = (like, adamw.init(like))
    st, (p14, o14) = ckpt.restore(str(path), like, shardings=named)
    leaves = tree.leaves((p14, o14))
    want = ckpt.sharding_leaves(like, named)
    placements_ok = all(isinstance(x, DTensor) and x.device_mesh == m14
                        and tuple(x.placements) == tuple(n.placements)
                        for x, n in zip(leaves, want))
    restored = full((p14, o14))
    bit_equal = all(torch.equal(a, b) for a, b in zip(restored, saved))
    if dist.get_rank() == 0:
        torch.save(saved, out / "reshard_saved.pt")
    after14 = run_steps(cfg, s14, p14, o14, bs)[2]
    split = sorted({str(tuple(x.placements)) for x in leaves})
    return {"step": st, "placements_ok": placements_ok,
            "bit_equal": bit_equal, "after22": after22,
            "after14": after14, "placements": split}


def _hook_cases(mesh) -> dict:
    """Each activation hook of ``models.sharding`` forward and backward
    on real DTensors over ``mesh`` (1, 4), against the plain computation
    (where the hook is the identity): whether the value and the input's
    gradient, whole, are bit-equal (integer-valued float32, so every sum
    is exact in any order), and the gradient's placements."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    gen = torch.Generator().manual_seed(0)

    def ints(*shape):
        return torch.randint(-3, 4, shape, generator=gen).float()
    R = Replicate()
    x, w = ints(2, 8, 24), ints(24, 8)

    def case(fn, x, pl, *consts):
        """fn(x, *consts) plain and with x placed by ``pl`` (the consts
        replicated DTensors there, or (tensor, placements))."""
        xp = x.clone().requires_grad_()
        cp = [c[0] if isinstance(c, tuple) else c for c in consts]
        yp = fn(xp, *cp)
        yp.float().pow(2).sum().backward()
        xd = distribute_tensor(x, mesh, pl).requires_grad_()
        cd = [distribute_tensor(*c) if isinstance(c, tuple) else
              distribute_tensor(c, mesh, (R, R)) for c in consts]
        with implicit_replication():
            yd = fn(xd, *cd)
            yd.float().pow(2).sum().full_tensor().backward()
        return {"value": torch.equal(yd.full_tensor(), yp.detach()),
                "grad": torch.equal(xd.grad.full_tensor(), xp.grad),
                "grad_placements": str(tuple(xd.grad.placements))}

    def heads_ready(t):                 # 6 heads of 4 over 4 cards
        return shd.heads_ready(t, 6).reshape(2, 8, 6, 4)

    def heads_merged(t, wt):            # merged heads, then row-parallel
        return shd.heads_merged(t.reshape(2, 8, 6, 4).reshape(2, 8, 24),
                                6) @ wt

    def pinned(t, wt):                  # its gradient split on the sequence
        y = shd.pinned(t) @ wt
        return y.redistribute(mesh, (R, Shard(1))) \
            if isinstance(y, DTensor) else y

    def reduce_partial(t):              # a sum over the split dim, gathered
        s_ = shd.reduce_partial(t.sum(2))
        return torch.gather(s_, 1, torch.tensor([[3, 0, 7], [1, 1, 5]]))

    def replicate_dims(t):
        return shd.replicate_dims(t, (-1,)).reshape(2, 8, 6, 4)

    def local_map(t, wt):               # rows on each card, weight whole
        if not isinstance(t, DTensor):
            return t @ wt
        return shd.local_map(torch.matmul, mesh, (t, wt),
                             ((R, Shard(1)), (R, R)), (R, Shard(1)))

    def counted_once(t, wt):            # a term computed alike on cards
        if not isinstance(t, DTensor):
            return (t @ wt).sum() + wt.pow(2).sum()
        work = (R, Shard(1))
        wl = shd.to_local(wt, mesh, (R, R), shd.summed_grad((R, R), work))
        tl = shd.to_local(t, mesh, work)
        part = shd.from_local((tl @ wl).sum(), mesh, (R, Partial()))
        alike = shd.from_local(shd.counted_once(wl.pow(2).sum(), mesh,
                                                work), mesh, (R, R))
        return part + alike

    return {
        "heads_ready": case(heads_ready, x, (R, Shard(2))),
        "heads_merged": case(heads_merged, x, (R, R),
                             (w, mesh, (R, Shard(0)))),
        "pinned": case(pinned, x, (R, R), (w, mesh, (R, Shard(1)))),
        "reduce_partial": case(reduce_partial, x, (R, Shard(2))),
        "replicate_dims": case(replicate_dims, x, (R, Shard(2))),
        "local_map": case(local_map, x, (R, R), w),
        # the gradient of the weight, summed over the cards, counts the
        # term that every card computes once
        "counted_once": case(lambda wt, t: counted_once(t, wt), w, (R, R),
                             x),
    }


def _rank_main(rank: int, world: int, store: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    out = Path(out)
    res, kept = {}, {}
    try:
        for shape in MESHES[world]:
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            tag = "x".join(map(str, shape))
            res[tag] = _sharded_steps(mesh, out, tag, kept)
            if world == 2:
                res["reference"] = _reference_case(mesh)
        if world == 2:
            res["trainer"] = _trainer(out, "trainer")
        else:
            res["reshard"] = _reshard(out, kept)
            res["hooks"] = _hook_cases(init_device_mesh(
                "cpu", (1, 4), mesh_dim_names=("data", "model")))
        if rank == 0:
            (out / f"world{world}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- parent
REFERENCE_SCRIPT = """
import json, sys
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
from repro.optim import adamw as JA
from repro.train import step as JS
from repro_torch.configs.base import get_config as port_config
from test_torch_train import f32_params, make_batch, to_jax
arch, seed, B, S = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \\
    int(sys.argv[4])
cfg = get_config(arch).reduced()
jp, _ = f32_params(port_config(arch).reduced(), seed)
mesh = make_host_mesh()
shard = shd.ShardCfg(mesh=mesh, dp=dp_axes(mesh))
step = jax.jit(JS.make_train_step(cfg, JA.AdamWConfig(lr=1e-3, warmup=2),
                                  shard))
opt, losses = JA.init(jp), []
for i in range(3):
    jp, opt, m = step(jp, opt, to_jax(make_batch(cfg, B, S, seed=10 + i)))
    losses.append(float(m["loss"]))
print(json.dumps({"losses": losses,
                  "mesh": dict(zip(mesh.axis_names, mesh.devices.shape))}))
"""


def _one_process(out: Path) -> dict:
    """The one-process runs: ``NO_SHARD`` for each arch (the first
    step's gradients, 3 steps' state and metrics), the same on the
    (1, 1) host mesh, and the trainer."""
    res = {"no_shard": {}, "one_rank": {}, "grads": {}}
    for arch in KINDS:
        cfg = get_config(arch).reduced()
        params = f32(cfg, 3)
        res["grads"][arch] = []
        res["no_shard"][arch] = run_steps(cfg, S.NO_SHARD, params,
                                          adamw.init(params), batches(cfg, 3),
                                          res["grads"][arch])
    mesh = M.make_host_mesh("cpu")
    try:
        shard = shd.ShardCfg(mesh=mesh, dp=M.dp_axes(mesh))
        for arch in KINDS:
            cfg = get_config(arch).reduced()
            params, opt = placed_state(cfg, shard)
            res["one_rank"][arch] = run_steps(cfg, shard, params, opt,
                                              batches(cfg, 3))
    finally:
        M.release()
    res["trainer"] = _trainer(out, "trainer_one")
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_train")
    tests = str(Path(__file__).resolve().parent)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.pathsep.join(
                   [tests] + [p for p in sys.path if p]))
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE_SCRIPT, REF_ARCH, str(REF_SEED),
         str(REF_B), str(REF_S)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    groups = {w: mp.start_processes(
        _rank_main, args=(w, str(out / f"store{w}"), str(out)), nprocs=w,
        join=False, start_method="spawn") for w in MESHES}
    t0 = time.time()
    threads = torch.get_num_threads()
    try:
        # this process shares the cores with the ranks
        torch.set_num_threads(min(threads, 2))
        one = _one_process(out)
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
    ranks = {}
    for w in MESHES:
        ranks.update(json.loads((out / f"world{w}.json").read_text()))
    return {"out": out, "one": one, "ranks": ranks,
            "reference": json.loads(stdout.strip().splitlines()[-1])}


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
@pytest.mark.parametrize("arch", KINDS)
def test_sharded_steps_equal_no_shard(runs, arch, shape):
    got = runs["ranks"][shape][arch]
    want = runs["one"]["no_shard"][arch][2]
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "xent", "grad_norm"):
            assert rel(g[k], w[k]) <= LOSS_RTOL_3, (i, k, g[k], w[k])
    grads = torch.load(runs["out"] / f"grads_{shape}_{arch}.pt")
    ref = runs["one"]["grads"][arch]
    assert len(grads) == len(ref)
    for g, w in zip(grads, ref):
        assert g.shape == w.shape and g.dtype == w.dtype
        tol = GRAD_TOL * max(float(w.norm()), 1e-12)
        assert float((g - w).abs().max()) <= tol


@pytest.mark.parametrize("arch", KINDS)
def test_one_rank_mesh_is_bit_equal_to_no_shard(runs, arch):
    p1, o1, m1 = runs["one"]["one_rank"][arch]
    p0, o0, m0 = runs["one"]["no_shard"][arch]
    assert m1 == m0
    a, b = full((p1, o1)), tree.leaves((p0, o0))
    assert len(a) == len(b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(isinstance(x, DTensor) for x in tree.leaves(p1))


def test_reference_host_mesh_step_equals_two_ranks(runs):
    ref = runs["reference"]
    assert ref["mesh"] == {"data": 1, "model": 2}
    got = runs["ranks"]["reference"]
    assert len(got) == len(ref["losses"]) == 3
    for g, w in zip(got, ref["losses"]):
        assert rel(g, w) <= LOSS_RTOL_3, (got, ref["losses"])


def test_trainer_on_two_ranks_equals_one_process(runs):
    two, one = runs["ranks"]["trainer"], runs["one"]["trainer"]
    assert "mesh={'data': 1, 'model': 2}" in two["stdout"]
    assert "[fault] simulated host failure at step 3" in two["stdout"]
    assert two["mesh"] == {"data": 1, "model": 2}
    assert one["mesh"] == {"data": 1, "model": 1}
    for run in (one, two):
        assert run["restarts"] == 1 and run["steps"] == 7
        assert run["step_ids"] == [0, 1, 2, 2, 3, 4, 5]
    for g, w in zip(two["losses"], one["losses"]):
        assert rel(g, w) <= LOSS_RTOL_3, (two["losses"], one["losses"])
    assert "(one rank: plain tensors)" in one["stdout"]
    assert "plain tensors" not in two["stdout"]
    # the state after the last step: every leaf within GRAD_TOL of its
    # norm (an update wrong on one rank's shard shows here first)
    paths = [runs["out"] / d for d in ("trainer", "trainer_one")]
    assert [ckpt.latest_step(str(p)) for p in paths] == [6, 6]
    with np.load(paths[0] / "ckpt_00000006.npz") as got, \
            np.load(paths[1] / "ckpt_00000006.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            g, w = got[k].astype(np.float64), want[k].astype(np.float64)
            err = float(np.abs(g - w).max())
            tol = GRAD_TOL * max(float(np.linalg.norm(w)), 1e-12)
            assert err <= tol, (k, err, tol)


def test_restore_reshards_2x2_onto_1x4(runs):
    r = runs["ranks"]["reshard"]
    assert r["step"] == 3
    assert r["placements_ok"] and r["bit_equal"]
    # the (1, 4) mesh splits the weights four ways on the model axis
    assert any("Shard" in p for p in r["placements"])
    for g, w in zip(r["after14"], r["after22"]):
        for k in ("loss", "xent", "grad_norm"):
            assert rel(g[k], w[k]) <= LOSS_RTOL_3, (k, r)


def test_sharded_checkpoint_reads_in_both_packages(runs):
    import jax
    from repro.optim import adamw as JA
    from repro.train import checkpoint as JCK
    from test_torch_train import f32_params
    path = str(runs["out"] / "reshard_ckpt")
    saved = torch.load(runs["out"] / "reshard_saved.pt")
    cfg = get_config(RESHARD_ARCH).reduced()
    jp, tp = f32_params(cfg, 11)
    st, tree_ = ckpt.restore(path, (tp, adamw.init(tp)), device="cpu")
    jst, jtree = JCK.restore(path, (jp, JA.init(jp)))
    assert st == jst == 3
    mine, ref = tree.leaves(tree_), jax.tree_util.tree_leaves(jtree)
    assert len(mine) == len(ref) == len(saved)
    for a, b, c in zip(mine, ref, saved):
        assert torch.equal(a, c)
        assert np.array_equal(a.numpy(), np.asarray(b))


HOOKS = ["heads_ready", "heads_merged", "pinned", "reduce_partial",
         "replicate_dims", "local_map", "counted_once"]


@pytest.mark.parametrize("hook", HOOKS)
def test_hook_on_real_collectives(runs, hook):
    r = runs["ranks"]["hooks"][hook]
    assert r["value"] and r["grad"], r


def test_host_group_rules(tmp_path):
    """``make_host_mesh`` makes a world of one when no group exists and
    ``release`` destroys it; a group made by someone else is used and
    left alone; the dry run's fake mesh is refused while a real group
    exists; a card asked for on a host without one raises."""
    assert not dist.is_initialized()
    mesh = M.make_host_mesh("cpu")
    assert tuple(mesh.shape) == (1, 1) and dist.get_backend() == "gloo"
    assert M.make_host_mesh("cpu").shape == mesh.shape     # the same group
    with pytest.raises(RuntimeError):
        M.fake_mesh((2, 2), ("data", "model"), "cpu")
    assert not M.distinct_cards(mesh)
    M.release()
    assert not dist.is_initialized()
    # a world of one over a store it is given
    store = dist.FileStore(str(tmp_path / "own"), 1)
    assert M.init_host_group("cpu", store=store) == torch.device("cpu")
    assert dist.get_world_size() == 1
    M.release()
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "pg"), 1), rank=0, world_size=1)
    try:
        assert M.init_host_group("cpu") == torch.device("cpu")
        M.release()
        assert dist.is_initialized()            # not ours: left alone
    finally:
        dist.destroy_process_group()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            M.init_host_group("cuda")
        assert not dist.is_initialized()
