"""The port's training infrastructure held to the reference on the CPU:
checkpoints (``repro_torch.train.checkpoint``) cross between the two
packages bit for bit in both directions, and restart bit-exactly; the
compression codec (``optim.compress``), the data stream
(``data.pipeline``) and the fault primitives (``train.fault``) equal the
reference's; the trainer (``launch.train``, ``examples.train_lm``)
trains, fails, restarts and resumes on the losses of a plain
``make_train_step`` loop over the same batches.
"""
import json
import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.distributed.tensor import (DTensor, Replicate,  # noqa: E402
                                      Shard)

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.optim import compress as JC  # noqa: E402
from repro.train import checkpoint as JCK  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.convert import (lm_params_from_arrays,  # noqa: E402
                                 opt_state_from_arrays)
from repro_torch.data.pipeline import (DataConfig, Pipeline,  # noqa: E402
                                       _batch_at, host_slice)
from repro_torch.examples import train_lm  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import sharding as shd  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim import compress as C  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.fault import (Heartbeat, RestartPolicy,  # noqa: E402
                                     StragglerMonitor, plan_elastic_mesh)
from repro_torch.train.step import make_train_step  # noqa: E402

ARCH = "mamba2-130m"           # bfloat16 and float32 leaves


def bits(x):
    """A leaf's raw bits as numpy (bfloat16 as int16), either package."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def arrays(t):
    """A reference tree as numpy, bfloat16 leaves as raw uint16 bits."""
    return jax.tree_util.tree_map(
        lambda a: bits(a).view(np.uint16) if np.asarray(a).dtype.name ==
        "bfloat16" else np.asarray(a), t)


def jax_batch(cfg, step, B=4, S=32):
    d = JP.DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B)
    return {k: jnp.asarray(v) for k, v in JP._batch_at(d, step).items()}


def torch_batch(cfg, step, B=4, S=32):
    d = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B)
    return {k: torch.from_numpy(v) for k, v in _batch_at(d, step).items()}


def bf16_params(cfg, seed):
    """Seeded bfloat16 parameters of the reference's tree on both sides
    (the port's draws, the same bits)."""
    tp = lm.init_params(lm.generator(seed, "cpu"), cfg)
    jp = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32), tp)
    return jp, tp


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's (params, opt) of reduced mamba2-130m after 3 of
    its own train steps, saved by the reference's ``checkpoint.save``."""
    jcfg = jax_config(ARCH).reduced()
    jp, _ = bf16_params(get_config(ARCH).reduced(), seed=1)
    opt = JA.init(jp)
    step = jax.jit(JS.make_train_step(jcfg, JA.AdamWConfig(lr=1e-3)))
    for i in range(3):
        jp, opt, _ = step(jp, opt, jax_batch(jcfg, i))
    path = str(tmp_path_factory.mktemp("ref_ckpt"))
    JCK.save(path, 3, (jp, opt), extra={"arch": jcfg.name})
    return path, jp, opt


# ---------------------------------------------------------------- checkpoints
def test_reference_checkpoint_restores_in_port(reference_run):
    path, jp, jo = reference_run
    cfg = get_config(ARCH).reduced()
    params = lm_params_from_arrays(cfg, arrays(jp), device="cpu")
    a = arrays(jo)
    opt = opt_state_from_arrays(cfg, a.master, a.m, a.v, a.count,
                                device="cpu")
    fresh = lm.init_params(lm.generator(9, "cpu"), cfg)
    step, (p2, o2) = ckpt.restore(path, (fresh, adamw.init(fresh)),
                                  device="cpu")
    assert step == 3 and isinstance(o2, adamw.OptState)
    assert o2.count.dtype == torch.int32 and int(o2.count) == 3
    want = tree.leaves((params, opt))
    got = tree.leaves((p2, o2))
    ref = jax.tree_util.tree_leaves((jp, jo))
    assert len(got) == len(want) == len(ref)
    for g, w, r in zip(got, want, ref):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(bits(g), bits(w))
        assert np.array_equal(bits(g), bits(r))
    with pytest.raises(ValueError):
        opt_state_from_arrays(get_config("jamba-v0.1-52b").reduced(),
                              a.master, a.m, a.v, a.count, device="cpu")


def test_port_checkpoint_restores_in_reference(reference_run, tmp_path):
    """The port trains two steps on from the reference's state and saves;
    the reference's ``restore`` reads every leaf back bit for bit."""
    _, jp, jo = reference_run
    cfg = get_config(ARCH).reduced()
    a = arrays(jo)
    params = lm_params_from_arrays(cfg, arrays(jp), device="cpu")
    opt = opt_state_from_arrays(cfg, a.master, a.m, a.v, a.count,
                                device="cpu")
    step = make_train_step(cfg, adamw.AdamWConfig(lr=1e-3))
    for i in range(3, 5):
        params, opt, _ = step(params, opt, torch_batch(cfg, i))
    ckpt.save(str(tmp_path), 5, (params, opt), extra={"arch": cfg.name})
    with open(tmp_path / "manifest.json") as f:
        mf = json.load(f)
    assert set(mf) == {"step", "n_leaves", "treedef", "file", "dtypes",
                       "extra"}
    assert mf["file"] == "ckpt_00000005.npz"
    assert set(mf["dtypes"]) == {"bfloat16", "float32", "int32"}
    st, (jp2, jo2) = JCK.restore(str(tmp_path), (jp, jo))
    assert st == 5 and int(jo2.count) == 5
    for g, r in zip(tree.leaves((params, opt)),
                    jax.tree_util.tree_leaves((jp2, jo2))):
        assert np.asarray(r).dtype.name == str(g.dtype).split(".")[-1]
        assert np.array_equal(bits(g), bits(r))


def test_checkpoint_restart_bit_exact(tmp_path):
    cfg = get_config("stablelm-3b").reduced()
    params = lm.init_params(lm.generator(1, "cpu"), cfg)
    opt = adamw.init(params)
    step = make_train_step(cfg, adamw.AdamWConfig(lr=1e-3))
    for i in range(3):
        params, opt, _ = step(params, opt, torch_batch(cfg, i))
    ckpt.save(str(tmp_path), 3, (params, opt), extra={"arch": cfg.name})
    # continue 2 more steps
    p_a, o_a = params, opt
    metrics_a = []
    for i in range(3, 5):
        p_a, o_a, m = step(p_a, o_a, torch_batch(cfg, i))
        metrics_a.append(float(m["loss"]))
    # restore into a fresh tree and replay
    fresh = lm.init_params(lm.generator(2, "cpu"), cfg)
    st, (p_b, o_b) = ckpt.restore(str(tmp_path), (fresh, adamw.init(fresh)),
                                  device="cpu")
    assert st == 3
    metrics_b = []
    for i in range(3, 5):
        p_b, o_b, m = step(p_b, o_b, torch_batch(cfg, i))
        metrics_b.append(float(m["loss"]))
    assert metrics_a == metrics_b            # bit-exact resume
    for a, b in zip(tree.leaves((p_a, o_a)), tree.leaves((p_b, o_b))):
        assert torch.equal(a, b)


def test_checkpoint_latest_and_atomicity(tmp_path):
    assert ckpt.latest_step(str(tmp_path)) is None
    t = {"a": torch.arange(5), "b": {"c": torch.ones((2, 2))}}
    ckpt.save(str(tmp_path), 7, t)
    assert ckpt.latest_step(str(tmp_path)) == 7
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    st, t2 = ckpt.restore(str(tmp_path), t, device="cpu")
    assert st == 7
    assert np.array_equal(t2["a"].numpy(), np.arange(5))
    # ``shardings`` places the leaves on a mesh (here the one-process
    # host mesh over gloo): DTensors of the asked placements, the same
    # values; a tree of another structure is refused
    mesh = M.make_host_mesh("cpu")
    try:
        named = {"a": shd.NamedSharding(mesh, (Replicate(), Shard(0))),
                 "b": {"c": (Shard(1), Replicate())}}
        st, t3 = ckpt.restore(str(tmp_path), t, shardings=named, mesh=mesh)
        assert st == 7
        assert t3["a"].placements == (Replicate(), Shard(0))
        assert t3["b"]["c"].placements == (Shard(1), Replicate())
        for a, b in zip(tree.leaves(t3), tree.leaves(t)):
            assert isinstance(a, DTensor) and torch.equal(a.full_tensor(), b)
        with pytest.raises(ValueError):
            ckpt.restore(str(tmp_path), t, shardings={"a": named["a"]})
    finally:
        M.release()
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), {"a": torch.arange(4), "b": t["b"]},
                     device="cpu")
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), {"a": t["a"]}, device="cpu")


# ---------------------------------------------------------------- compress
@pytest.mark.parametrize("seed", range(6))
def test_quantize_int8_equals_reference(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(256) * 10 ** rng.uniform(-3, 3)).astype(
        np.float32)
    x[:4] = [0.5, -1.5, 2.5, 0.0]        # round half to even, both sides
    if seed == 0:
        x[:] = 0.0                           # the 1e-8 floor
    jq, js = JC.quantize_int8(jnp.asarray(x))
    q, s = C.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert bits(s) == bits(np.asarray(js))
    assert np.array_equal(bits(C.dequantize_int8(q, s)),
                          bits(JC.dequantize_int8(jq, js)))
    err = np.abs(C.dequantize_int8(q, s).numpy() - x)
    assert err.max() <= float(s) / 2 + 1e-6


def test_error_feedback_equals_reference_over_50_steps():
    rng = np.random.default_rng(0)
    g = {"w": rng.standard_normal(64).astype(np.float32),
         "b": {"c": (rng.standard_normal((3, 5)) * 1e-3).astype(np.float32)}}
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    tg = tree.map(torch.from_numpy, g)
    jres, res = JC.ef_init(jg), C.ef_init(tg)
    # eager, as the reference's own test runs it: under jit, XLA turns the
    # scale's ``/ 127.0`` into a multiply by its reciprocal, an ulp off on
    # about 5% of inputs; the port divides
    ef = JC.ef_compress
    sent = np.zeros(64, np.float32)
    for _ in range(50):
        jq, js, jres = ef(jg, jres)
        q, s, res = C.ef_compress(tg, res)
        for mine, ref in ((q, jq), (s, js), (res, jres)):
            for a, b in zip(tree.leaves(mine), jax.tree_util.tree_leaves(ref)):
                assert np.array_equal(bits(a), bits(np.asarray(b)))
        sent += C.dequantize_int8(q["w"], s["w"]).numpy()
    np.testing.assert_allclose(sent / 50, g["w"], rtol=0.02, atol=0.02)
    assert float(res["w"].abs().max()) < float(s["w"]) * 2


@pytest.mark.parametrize("members", [2, 5])
def test_compressed_psum_equals_reference(members):
    rng = np.random.default_rng(members)
    x = (rng.standard_normal((members, 33)) *
         rng.uniform(0.1, 10, (members, 1))).astype(np.float32)
    want = jax.vmap(lambda xi: JC.compressed_psum(xi, "pod"),
                    axis_name="pod")(jnp.asarray(x))
    got = C.compressed_psum(torch.from_numpy(x))
    assert got.shape == (33,) and got.dtype == torch.float32
    for i in range(members):
        assert np.array_equal(bits(got), bits(np.asarray(want[i])))


# ---------------------------------------------------------------- data
def test_pipeline_equals_reference():
    kw = dict(vocab=100, seq_len=16, global_batch=8, n_hosts=2, host_id=1)
    d, jd = DataConfig(**kw), JP.DataConfig(**kw)
    for step in (0, 5, 123):
        b, jb = _batch_at(d, step), JP._batch_at(jd, step)
        for k in ("tokens", "labels"):
            assert b[k].dtype == jb[k].dtype == np.int32
            assert np.array_equal(b[k], jb[k])
            assert np.array_equal(host_slice(d, b)[k],
                                  JP.host_slice(jd, jb)[k])
    sl = host_slice(d, _batch_at(d, 5))
    assert sl["tokens"].shape == (4, 16)
    assert np.array_equal(sl["tokens"], _batch_at(d, 5)["tokens"][4:])
    # hedged read returns identical data (determinism contract)
    hedge = dict(kw, hedge=True)
    pipe, jpipe = Pipeline(DataConfig(**hedge), 5), \
        JP.Pipeline(JP.DataConfig(**hedge), 5)
    try:
        for _ in range(3):
            (step, batch), (jstep, jbatch) = next(pipe), next(jpipe)
            assert step == jstep
            for k in batch:
                assert np.array_equal(batch[k], jbatch[k])
    finally:
        pipe.close()
        jpipe.close()
    assert step == 7
    assert np.array_equal(_batch_at(d, 5)["labels"][:, -1], np.full(8, -1))


# ---------------------------------------------------------------- fault
def test_fault_primitives():
    hb = Heartbeat(deadline_s=10)
    hb.beat(0, now=100.0)
    hb.beat(1, now=100.0)
    hb.beat(1, now=115.0)
    assert hb.dead_hosts(now=116.0) == [0]
    assert plan_elastic_mesh(512, 16) == (32, 16)
    assert plan_elastic_mesh(496, 16) == (31, 16)   # non-power-of-two OK
    with pytest.raises(ValueError):
        plan_elastic_mesh(8, 16)
    mon = StragglerMonitor(factor=2.0)
    assert not mon.observe(1.0)
    assert not mon.observe(1.1)
    assert mon.observe(5.0)                          # flagged
    pol = RestartPolicy(max_restarts=2)
    assert pol.should_restart()
    assert [pol.record(), pol.record()] == [1.0, 2.0]
    assert not pol.should_restart()


# ---------------------------------------------------------------- trainer
def test_trainer_restart_and_resume_equal_the_step_loop(tmp_path, capsys):
    """Six steps with a checkpoint every two and a failure at step 3
    (restored from step 2, steps 2-5 replayed), then a resume to step 8:
    every loss equals a plain ``make_train_step`` loop's over the same
    batches; then the example on the CPU."""
    base = ["--arch", ARCH, "--reduced", "--batch", "4", "--seq", "32",
            "--device", "cpu", "--ckpt", str(tmp_path), "--ckpt-every", "2",
            "--log-every", "1"]
    run = train.main(base + ["--steps", "6", "--fail-at", "3"])
    assert run["restarts"] == 1 and run["steps"] == 7
    assert run["step_ids"] == [0, 1, 2, 2, 3, 4, 5]
    out = capsys.readouterr().out
    assert "mesh={'data': 1, 'model': 1}" in out
    assert "[fault] simulated host failure at step 3" in out
    assert ckpt.latest_step(str(tmp_path)) == 6
    resumed = train.main(base + ["--steps", "8", "--resume"])
    assert "resumed from step 6" in capsys.readouterr().out
    assert resumed["step_ids"] == [6, 7] and resumed["restarts"] == 0

    cfg = get_config(ARCH).reduced()
    params = lm.init_params(lm.generator(0, "cpu"), cfg)
    opt = adamw.init(params)
    step = make_train_step(cfg, adamw.AdamWConfig(lr=1e-3, warmup=20))
    want = []
    for i in range(8):
        params, opt, m = step(params, opt, torch_batch(cfg, i))
        want.append(float(m["loss"]))
    assert run["losses"] == [want[i] for i in run["step_ids"]]
    assert resumed["losses"] == want[6:]

    ex = train_lm.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                        "--seq", "16", "--ckpt", str(tmp_path / "ex")])
    assert ex["steps"] == 3 and np.isfinite(ex["last_loss"])
    assert ex["ckpt"] == str(tmp_path / "ex")
