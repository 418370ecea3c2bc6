"""The port's ELL SpMV and diffusion step against the reference, on the CPU.

A port of ``tests/test_kernels.py``: ``ops.spmv`` and ``ops.diffuse`` on
CPU tensors (the kernels' plain versions) against the reference's
``ops.spmv`` / ``ops.diffuse`` in interpret mode and its jnp oracles, at
the reference's shapes and tolerances: 1e-5 for float32 SpMV (sums taken
in another order), 5e-2 for bfloat16, 1e-4 for three diffusion steps.
The reference's block-invariance test has no counterpart here: the port
takes no ``block_rows`` (``tests/test_torch_cuda.py`` runs the kernels at
an ``n`` that is no multiple of any block instead).
"""
import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ref import diffusion_step_ref, ell_spmv_ref  # noqa: E402
from repro_torch.convert import key_from_array  # noqa: E402
from repro_torch.core.matching import heavy_edge_matching_multi  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402
from repro_torch.kernels import band_batch, diffusion, ell_spmv, ops  # noqa: E402,E501


def make_ell(n, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n, (n, d)).astype(np.int32)
    nbr[rng.random((n, d)) < 0.3] = -1          # ragged padding
    val = rng.standard_normal((n, d)).astype(dtype)
    x = rng.standard_normal(n).astype(dtype)
    return nbr, val, x


@pytest.mark.parametrize("n", [8, 100, 256, 1000, 4096])
@pytest.mark.parametrize("d", [1, 4, 17, 32])
def test_spmv_shapes(n, d):
    nbr, val, x = make_ell(n, d, seed=n * 131 + d)
    got = ops.spmv(nbr, val, x, device="cpu").numpy()
    j = (jnp.asarray(nbr), jnp.asarray(val), jnp.asarray(x))
    for want in (jops.spmv(*j, interpret=True), ell_spmv_ref(*j)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    assert ell_spmv.launches == 0               # CPU tensors never launch


def _spmv_vs_reference(n, d, dtype, rtol, seed):
    """``ops.spmv`` on the CPU (the plain version) against the reference's
    kernel in interpret mode and its jnp version, in ``dtype``."""
    nbr, val, x = make_ell(n, d, seed=seed)
    tdt = getattr(torch, dtype)
    val_t = torch.from_numpy(val).to(tdt)
    x_t = torch.from_numpy(x).to(tdt)
    got = ops.spmv(nbr, val_t, x_t, device="cpu")
    assert got.dtype == tdt
    # the reference gets the same rounded inputs
    jdt = getattr(jnp, dtype)
    j = (jnp.asarray(nbr), jnp.asarray(val_t.float().numpy()).astype(jdt),
         jnp.asarray(x_t.float().numpy()).astype(jdt))
    for want in (jops.spmv(*j, interpret=True), ell_spmv_ref(*j)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=rtol, atol=rtol)


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5),
                                        ("bfloat16", 5e-2)])
def test_spmv_dtypes(dtype, rtol):
    _spmv_vs_reference(512, 8, dtype, rtol, seed=7)


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5),
                                        ("bfloat16", 5e-2)])
@pytest.mark.parametrize("d", [4, 8, 16, 5])
def test_spmv_widths(d, dtype, rtol):
    """The plain version against the reference at a ragged n and at the
    widths on which the card's kernel picks its path (in float32, d of 4,
    8 and 16 take its vector path and 5 its group path); the card tests
    hold the kernel itself to the plain version."""
    _spmv_vs_reference(1001, d, dtype, rtol, seed=d)


def test_spmv_bfloat16_rounds_each_product():
    """In bfloat16 each product is rounded before the float32 sum: rows
    whose exact sum (2^-14) differs from the sum of rounded products (0)."""
    nbr = torch.tensor([[0, 1, -1]] * 2, dtype=torch.int32)
    val = torch.tensor([[1.0 + 2 ** -7, -1.0, 5.0]] * 2,
                       dtype=torch.bfloat16)
    x = torch.tensor([1.0 + 2 ** -7, 1.0 + 2 ** -6], dtype=torch.bfloat16)
    got = ell_spmv.ell_spmv(nbr, val, x)
    # (1 + 2^-7)^2 = 1 + 2^-6 + 2^-14 rounds to 1 + 2^-6 in bfloat16,
    # which the second slot cancels; the padding slot adds nothing
    assert got.tolist() == [0.0, 0.0]
    exact = ell_spmv.ell_spmv(nbr, val.float(), x.float())
    assert exact.tolist() == [2 ** -14] * 2


def test_spmv_against_dense():
    g = gen.grid2d(12, 12)
    nbr, wgt = g.to_ell()
    x = np.random.default_rng(0).standard_normal(g.n).astype(np.float32)
    dense = np.zeros((g.n, g.n), np.float32)
    src = np.repeat(np.arange(g.n), g.degrees())
    dense[src, g.adjncy] = g.adjwgt
    got = ops.spmv(nbr, wgt.astype(np.float32), x, device="cpu").numpy()
    np.testing.assert_allclose(got, dense @ x, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,d", [(64, 4), (300, 9), (1024, 16)])
def test_diffusion_matches_ref(n, d):
    nbr, val, x = make_ell(n, d, seed=n + d)
    val = np.abs(val)                            # diffusion wants w >= 0
    inj = np.zeros(n, np.float32)
    inj[:3], inj[-3:] = 0.5, -0.5
    got = ops.diffuse(nbr, val, x, inj, steps=3, device="cpu").numpy()
    want = jops.diffuse(nbr, val, x, inj, steps=3, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    ref = jnp.asarray(x)
    for _ in range(3):
        ref = diffusion_step_ref(jnp.asarray(nbr), jnp.asarray(val), ref,
                                 jnp.asarray(inj))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-4)
    assert diffusion.launches == 0


def test_diffusion_separates_grid():
    """Sanity: diffusion from opposite anchors signs the two halves."""
    g = gen.grid2d(16, 16)
    nbr, wgt = g.to_ell()
    n = g.n
    inj = np.zeros(n, np.float32)
    left = np.arange(n).reshape(16, 16)[:, 0]
    right = np.arange(n).reshape(16, 16)[:, -1]
    inj[left], inj[right] = 1.0, -1.0
    x = np.zeros(n, np.float32)
    out = ops.diffuse(nbr, wgt.astype(np.float32), x, inj, steps=60, dt=0.1,
                      mu=0.02, device="cpu").numpy()
    grid = out.reshape(16, 16)
    assert (grid[:, :6] > 0).all() and (grid[:, 10:] < 0).all()


def test_diffusion_sign_of_zero_and_weights():
    """sign(0) = 0, and dt·μ is the Python product: one row, no edges."""
    nbr = torch.full((3, 2), -1, dtype=torch.int32)
    val = torch.ones(3, 2)
    x = torch.tensor([0.0, 2.0, -2.0])
    y = diffusion.diffusion_step(nbr, val, x, torch.zeros(3), dt=0.5, mu=0.3)
    dt_mu = torch.tensor(0.5 * 0.3, dtype=torch.float32)
    assert torch.equal(y, torch.stack([torch.tensor(0.0), 2.0 - dt_mu,
                                       -2.0 + dt_mu]))


def test_ell_wrappers_check_inputs():
    nbr, val, x = (torch.from_numpy(a) for a in make_ell(16, 4, seed=1))
    with pytest.raises(TypeError):
        ell_spmv.ell_spmv(nbr.long(), val, x)
    with pytest.raises(TypeError):
        ell_spmv.ell_spmv(nbr, val.double(), x.double())
    with pytest.raises(ValueError):
        ell_spmv.ell_spmv(nbr, val, x[:-1])
    with pytest.raises(ValueError):
        ell_spmv.ell_spmv_kernel(nbr, val, x)
    with pytest.raises(TypeError):
        diffusion.diffusion_step(nbr, val.to(torch.bfloat16), x, x)
    with pytest.raises(ValueError):
        diffusion.diffusion_step_kernel(nbr, val, x, x)
    if not torch.cuda.is_available():           # entries default to the card
        with pytest.raises(RuntimeError):
            ops.spmv(nbr, val, x)
        with pytest.raises(RuntimeError):
            ops.diffuse(nbr, val, x, x)


def _ell_batch(seed, L, n, d):
    """L random symmetric ELL graphs (ids, weights), padded to (n, d)."""
    rng = np.random.default_rng(seed)
    nbr = -np.ones((L, n, d), np.int32)
    wgt = np.zeros((L, n, d), np.int32)
    for lane in range(L):
        g = gen.rgg2d(n - 8 * lane, seed=seed + lane)
        ids, w = g.to_ell(d)
        nbr[lane, :g.n], wgt[lane, :g.n] = ids, w
    src = (rng.random((L, n)) < 0.05).astype(np.int32)
    return nbr, wgt, src


def test_band_bfs_batch_equals_reference_entry():
    """The reference's entry against ``bfs_multi``, which the port's band
    stage calls directly."""
    nbr, _, src = _ell_batch(5, 3, 100, 16)
    got = band_batch.bfs_multi(torch.from_numpy(nbr), torch.from_numpy(src),
                               3).numpy()
    want = np.asarray(jops.band_bfs_batch(nbr, src, 3, interpret=True))
    assert np.array_equal(got, want)


def test_match_batch_equals_reference_entry():
    """The reference's entry against ``heavy_edge_matching_multi``, which
    the port's coarsening calls directly."""
    nbr, wgt, _ = _ell_batch(9, 3, 96, 16)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(4), 3))
    got = heavy_edge_matching_multi(torch.from_numpy(nbr),
                                    torch.from_numpy(wgt),
                                    key_from_array(keys))
    want = jops.match_batch(nbr, wgt, keys)
    assert np.array_equal(got.numpy(), np.asarray(want))
