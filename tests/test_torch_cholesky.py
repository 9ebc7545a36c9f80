"""Port blocked Cholesky (left-looking, B3 base) against the JAX package.

On the CPU the B3 wrapper takes its plain version, so these tests hold the
port's driver (panels, GEMM updates, identity-corner padding, NaN
semantics) against the JAX ``cholesky_blocked`` with its Pallas base in
interpret mode (as tests/test_blocked_cholesky.py runs it) and against
``jnp.linalg.cholesky``, in float64, at relative Frobenius error 1e-10.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_processes_tpu.ops import blocked_cholesky as jbc
from gaussian_processes_tpu_torch.ops import _build
from gaussian_processes_tpu_torch.ops import blocked_cholesky as tbc
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

REL = 1e-10


def _spd(n, seed, kind="kernel"):
    rng = np.random.default_rng(seed)
    if kind == "kernel":
        x = np.sort(rng.uniform(-3, 3, n))
        d = x[:, None] - x[None, :]
        return np.exp(-0.5 * d * d) + 0.05 * np.eye(n)
    G = rng.standard_normal((n, n))
    return G @ G.T / n + 0.5 * np.eye(n)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("n,kind", [(128, "random"), (300, "kernel")])
def test_blocked_matches_jax_pallas_base(n, kind):
    A = _spd(n, n, kind)
    want = np.asarray(jbc.cholesky_blocked(jnp.asarray(A), base=128, base_impl="pallas"))
    got = tbc.cholesky_blocked(torch.as_tensor(A)).numpy()
    assert _rel(got, want) < REL
    assert np.abs(np.triu(got, 1)).max() == 0.0


@pytest.mark.parametrize("n,kind", [(64, "kernel"), (256, "random"), (500, "kernel"),
                                    (640, "random")])
def test_blocked_matches_jnp_cholesky(n, kind):
    A = _spd(n, n + 1, kind)
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(A)))
    got = tbc.cholesky_blocked(torch.as_tensor(A))
    assert got.shape == (n, n) and got.is_contiguous()
    assert _rel(got.numpy(), want) < REL
    assert np.abs(np.triu(got.numpy(), 1)).max() == 0.0


def test_padding_path_does_not_touch_input():
    A = torch.as_tensor(_spd(300, 7))  # 300 -> padded to 384
    A0 = A.clone()
    L = tbc.cholesky_blocked(A)
    assert torch.equal(A, A0)
    assert L.shape == (300, 300)
    assert _rel((L @ L.T).numpy(), A.numpy()) < REL


def test_tile_twin_matches_jax_pallas_tile():
    A = _spd(128, 3, "random")
    want = np.asarray(jbc._pallas_chol_tile(jnp.asarray(A), interpret=True))
    got = tbc.chol_tile(torch.as_tensor(A)).numpy()
    assert _rel(got, want) < REL
    assert np.abs(np.triu(got, 1)).max() == 0.0


def test_tile_batch_matches_per_tile():
    tiles = np.stack([_spd(128, s, kind) for s, kind in ((1, "kernel"), (2, "random"))])
    got = tbc.chol_tile(torch.as_tensor(tiles))
    for b in range(2):
        np.testing.assert_array_equal(
            got[b].numpy(), tbc.chol_tile(torch.as_tensor(tiles[b])).numpy())


def test_non_pd_tile_gives_nan_like_jax():
    A = _spd(128, 4, "random")
    A[70, 70] = -3.0
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(A)))
    got = tbc.chol_tile(torch.as_tensor(A)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[np.tril_indices(128)]).all() and (np.triu(got, 1) == 0).all()


def test_non_pd_blocked_gives_nan_like_jax():
    """A failed panel leaves earlier panels finite and NaNs the rest, with
    the same pattern as the JAX blocked factorization over jnp.linalg's
    base; no exception (the samplers reject through the NaN)."""
    A = _spd(300, 5, "random")
    A[200, 200] = -1.0
    want = np.asarray(jbc.cholesky_blocked(jnp.asarray(A), base=128))
    got = tbc.cholesky_blocked(torch.as_tensor(A)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = ~np.isnan(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-10, atol=1e-12)
    assert np.isnan(got[128:, 128:]).any() and np.isfinite(got[:, :128]).all()


def test_reference_batch_nan_only_where_failed():
    good, bad = _spd(16, 1, "random"), _spd(16, 2, "random")
    bad[3, 3] = -1.0
    L = tbc.cholesky_reference(torch.as_tensor(np.stack([good, bad]))).numpy()
    assert np.isfinite(L[0]).all()
    assert np.isnan(L[1][np.tril_indices(16)]).all()


def test_dispatch_by_device():
    cpu = torch.zeros(4, 4, dtype=torch.float64)
    card = types.SimpleNamespace(device=torch.device("cuda", 0))
    assert tbc.choose_cholesky(cpu) is tbc.cholesky_reference
    assert tbc.choose_cholesky(card) is tbc.cholesky_blocked
    assert tbc.choose_solve(cpu) is tbc.choose_solve(card)


def test_solve_vector_and_trans():
    A = torch.as_tensor(_spd(50, 6))
    L = tbc.cholesky_blocked(A)
    b = torch.linspace(-1, 1, 50, dtype=torch.float64)
    solve = tbc.choose_solve(L)
    x = solve(L, solve(L, b), trans=True)
    np.testing.assert_allclose((A @ x).numpy(), b.numpy(), atol=1e-9)
    X = solve(L, torch.eye(50, dtype=torch.float64))
    np.testing.assert_allclose((L @ X).numpy(), np.eye(50), atol=1e-9)


def test_tile_wrapper_checks():
    with pytest.raises(ValueError, match="128"):
        tbc.chol_tile(torch.eye(64, dtype=torch.float64))
    with pytest.raises(RuntimeError, match="no Cholesky tile kernel"):
        tbc.chol_tile(torch.eye(128, device="meta"))
    before = dict(_build.launch_counts)
    tbc.cholesky_blocked(torch.as_tensor(_spd(256, 9)))
    assert dict(_build.launch_counts) == before  # CPU: plain version, no launch


# -- the fused inverse: cholesky_blocked takes (L_kk, L_kk^-1) from one B3 call

# float32: two factorizations of these matrices (kappa ~ 1e2 to 1e3) differ by
# up to ~kappa u, so the factor and the tile inverse are held to 1e-4 relative
# Frobenius distance; float64 to REL
F32_REL = 1e-4


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n", [128, 300, 1000])
def test_blocked_inverse_path_matches_jnp(n, dtype):
    A = _spd(n, 3 * n, "kernel").astype(dtype)
    rel = REL if dtype == "float64" else F32_REL
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(A)), dtype=np.float64)
    got = tbc.cholesky_blocked(torch.as_tensor(A))
    assert got.dtype == getattr(torch, dtype)
    assert _rel(got.double().numpy(), want) < rel
    assert np.abs(np.triu(got.numpy(), 1)).max() == 0.0
    # the panels' (L_kk, L_kk^-1) against jnp: the diagonal tiles of A's
    # leading 128-multiple, as one batch
    m = n // 128 * 128
    tiles = np.stack([A[i:i + 128, i:i + 128] for i in range(0, m, 128)])
    L, Linv = tbc.chol_tile_inv(torch.as_tensor(tiles))
    jL = jnp.linalg.cholesky(jnp.asarray(tiles))
    want_inv = np.asarray(jnp.linalg.inv(jL), dtype=np.float64)
    assert _rel(L.double().numpy(), np.asarray(jL, dtype=np.float64)) < rel
    assert _rel(Linv.double().numpy(), want_inv) < rel
    assert np.abs(np.triu(Linv.numpy(), 1)).max() == 0.0
