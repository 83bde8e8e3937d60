"""Tests for the closed-form / statically-unrolled linear algebra in
flvis_tpu.ops.linalg against NumPy float64 references."""

import jax.numpy as jnp
import numpy as np
import pytest

from flvis_tpu.ops import linalg


def _rand_spd(rng, n, cond=1e4):
    A = rng.normal(size=(n, n))
    U, _ = np.linalg.qr(A)
    s = np.logspace(0, np.log10(cond), n)
    return (U * s) @ U.T


def _f64(x):
    return np.asarray(x, np.float64)


class TestSmallInverses:
    def test_inv3_matches_numpy(self):
        rng = np.random.default_rng(0)
        B = rng.normal(size=(16, 3, 3)) + 3.0 * np.eye(3)
        got = _f64(linalg.inv3(jnp.asarray(B, jnp.float32)))
        np.testing.assert_allclose(got, np.linalg.inv(B), atol=1e-4)

    def test_inv3_singular_is_zero(self):
        B = np.ones((3, 3), np.float32)
        assert np.all(_f64(linalg.inv3(jnp.asarray(B))) == 0.0)

    def test_sym3_inv_matches_numpy(self):
        rng = np.random.default_rng(1)
        H = np.stack([_rand_spd(rng, 3, cond=1e2) for _ in range(16)])
        got = _f64(linalg.sym3_inv(jnp.asarray(H, jnp.float32)))
        for g, h in zip(got, H):
            # Checked as an inverse (H @ g ≈ I): the well-conditioned f32 test.
            np.testing.assert_allclose(h @ g, np.eye(3), atol=1e-4)


class TestChol3:
    def test_factor_reconstructs(self):
        rng = np.random.default_rng(2)
        S = np.stack([_rand_spd(rng, 3, cond=1e2) for _ in range(16)])
        L = _f64(linalg.chol3(jnp.asarray(S, jnp.float32)))
        np.testing.assert_allclose(L, np.linalg.cholesky(S), atol=1e-4)
        assert np.all(np.triu(L, 1) == 0.0)


class TestGsNull:
    @pytest.mark.parametrize("rows,cols", [(2, 3), (11, 12)])
    def test_orthogonal_to_rows(self, rows, cols):
        rng = np.random.default_rng(3)
        A = rng.normal(size=(8, rows, cols))
        h = _f64(linalg.gs_null(jnp.asarray(A, jnp.float32)))
        np.testing.assert_allclose(np.linalg.norm(h, axis=-1), 1.0, atol=1e-5)
        # The reference null vector: the last right-singular vector.
        ref = np.linalg.svd(A)[2][:, -1]
        np.testing.assert_allclose(np.abs(np.sum(h * ref, -1)), 1.0, atol=1e-3)

    def test_rank_deficient_rows(self):
        rng = np.random.default_rng(4)
        A = rng.normal(size=(3, 5))
        A[2] = 2.0 * A[0]                      # dependent row
        h = _f64(linalg.gs_null(jnp.asarray(A, jnp.float32)))
        assert np.abs(A @ h).max() < 1e-4
        np.testing.assert_allclose(np.linalg.norm(h), 1.0, atol=1e-5)


class TestMaxEigvecSym:
    @pytest.mark.parametrize("dim", [4, 12])
    def test_matches_eigh(self, dim):
        rng = np.random.default_rng(5)
        K = np.stack([_rand_spd(rng, dim, cond=10.0) for _ in range(8)])
        v = _f64(linalg.max_eigvec_sym(jnp.asarray(K, jnp.float32)))
        ref = np.linalg.eigh(K)[1][..., -1]
        np.testing.assert_allclose(np.abs(np.sum(v * ref, -1)), 1.0, atol=1e-4)
