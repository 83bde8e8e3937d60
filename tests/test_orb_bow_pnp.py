"""Tests for ORB features, bag-of-words scoring, and batched PnP RANSAC."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flvis_tpu.io.synthetic import textured_image, warp_translate
from flvis_tpu.loop import bow
from flvis_tpu.ops import orb, pnp
from flvis_tpu.geometry import camera, se3, so3


@pytest.fixture(scope="module")
def tex():
    return textured_image(np.random.default_rng(7), 240, 320)


@pytest.fixture(scope="module")
def orb_out(tex):
    return orb.detect_and_compute(jnp.asarray(tex), num_features=200)


class TestORB:
    def test_detects_corners(self, orb_out):
        uv, desc, valid, ang = orb_out
        assert int(valid.sum()) > 50
        assert desc.shape == (200, 8) and desc.dtype == jnp.uint32

    def test_fast_on_synthetic_corner(self):
        img = np.full((64, 64), 50.0, np.float32)
        img[20:44, 20:44] = 200.0
        score = np.asarray(orb.fast_score(jnp.asarray(img), 20.0))
        # Strong responses near the 4 square corners, none in flat areas.
        assert score[20, 20] > 0 or score[21, 21] > 0
        assert score[5:15, 5:15].max() == 0.0

    def test_descriptor_invariance_to_translation(self, tex, orb_out):
        """Same keypoints in a shifted image → nearly identical descriptors."""
        uv, desc, valid, ang = orb_out
        shift = (5.0, 3.0)
        img2 = warp_translate(tex, *shift)
        uv2 = uv + jnp.asarray(shift)
        ang2 = orb.orientations(jnp.asarray(img2), uv2)
        from flvis_tpu.ops import image as imops
        blur2 = imops.gaussian_blur(jnp.asarray(img2), sigma=2.0, ksize=7)
        desc2 = orb.brief_descriptors(blur2, uv2, ang2)
        d = np.asarray(orb.hamming_matrix(desc, desc2))
        diag = np.diag(d)[np.asarray(valid)]
        assert np.median(diag) < 30, f"median hamming {np.median(diag)}"

    def test_hamming_matrix(self):
        a = jnp.asarray([[0, 0, 0, 0, 0, 0, 0, 0]], jnp.uint32)
        b = jnp.asarray([[0xFFFFFFFF] * 8, [0] * 8], jnp.uint32)
        d = orb.hamming_matrix(a, b)
        assert d[0, 0] == 256 and d[0, 1] == 0

    def test_unpack_roundtrip(self, rng):
        desc = jnp.asarray(rng.integers(0, 2**32, (4, 8), dtype=np.uint32))
        pm1 = orb.unpack_pm1(desc)
        assert pm1.shape == (4, 256)
        # Hamming via matmul must equal popcount hamming.
        d_mm = (256 - pm1 @ pm1.T) / 2
        d_pc = orb.hamming_matrix(desc, desc)
        np.testing.assert_allclose(d_mm, d_pc, atol=0.1)

    def test_mutual_ratio_match(self, orb_out, tex):
        uv, desc, valid, _ = orb_out
        idx, good = orb.mutual_ratio_match(desc, desc, valid, valid, ratio=0.9)
        # Self-matching: every valid descriptor matches itself.
        g = np.asarray(good)
        assert np.asarray(idx)[g].tolist() == np.nonzero(g)[0].tolist()


class TestBoW:
    def test_train_and_score(self, tex, rng):
        uv, desc, valid, _ = orb.detect_and_compute(jnp.asarray(tex), num_features=300)
        vocab = bow.train(desc, np.asarray(valid), num_words=64, iters=4)
        v1 = bow.transform(vocab, desc, valid)
        assert abs(float(jnp.sum(jnp.abs(v1))) - 1.0) < 1e-4
        # Same image scores ~1 with itself.
        assert float(bow.score(v1, v1)) > 0.999

    def test_different_images_score_lower(self, tex):
        texB = textured_image(np.random.default_rng(99), 240, 320)
        _, dA, vA, _ = orb.detect_and_compute(jnp.asarray(tex), num_features=300)
        _, dB, vB, _ = orb.detect_and_compute(jnp.asarray(texB), num_features=300)
        vocab = bow.train(jnp.concatenate([dA, dB]), np.ones(600, bool), num_words=128, iters=4)
        a = bow.transform(vocab, dA, vA)
        b = bow.transform(vocab, dB, vB)
        shifted = warp_translate(tex, 4.0, -2.0)
        _, dC, vC, _ = orb.detect_and_compute(jnp.asarray(shifted), num_features=300)
        c = bow.transform(vocab, dC, vC)
        same = float(bow.score(a, c))
        diff = float(bow.score(a, b))
        assert same > diff + 0.1, f"same={same} diff={diff}"

    def test_score_database(self, tex):
        _, dA, vA, _ = orb.detect_and_compute(jnp.asarray(tex), num_features=200)
        vocab = bow.train(dA, np.asarray(vA), num_words=64, iters=3)
        q = bow.transform(vocab, dA, vA)
        db = jnp.stack([q, q * 0.5, jnp.zeros_like(q)])
        s = bow.score_database(q, db, jnp.asarray([True, True, False]))
        assert float(s[0]) > 0.99 and float(s[2]) == 0.0


class TestPnP:
    def test_procrustes(self, rng):
        R_true = np.asarray(so3.to_matrix(so3.exp(jnp.asarray([0.2, -0.1, 0.3]))))
        t_true = np.array([1.0, -2.0, 0.5])
        src = rng.normal(size=(20, 3))
        dst = src @ R_true.T + t_true
        R, t = pnp.procrustes(jnp.asarray(src), jnp.asarray(dst))
        np.testing.assert_allclose(R, R_true, atol=1e-5)
        np.testing.assert_allclose(t, t_true, atol=1e-5)

    def test_pnp_ransac_clean(self, rng):
        T_true = se3.SE3(so3.exp(jnp.asarray([0.1, 0.2, -0.05])), jnp.asarray([0.3, -0.2, 0.5]))
        pts_w = jnp.asarray(rng.uniform([-2, -2, 3], [2, 2, 9], (100, 3)).astype(np.float32))
        pc = se3.transform_points(T_true, pts_w)
        xn = pc[:, :2] / pc[:, 2:]
        T, inl, n = pnp.pnp_ransac(jax.random.PRNGKey(0), pts_w, xn, jnp.ones(100, bool))
        dt, dr = se3.distance(T, T_true)
        assert float(dt) < 0.02 and float(dr) < 0.01
        assert int(n) > 90

    def test_pnp_ransac_outliers(self, rng):
        T_true = se3.SE3(so3.exp(jnp.asarray([-0.05, 0.15, 0.08])), jnp.asarray([0.2, 0.1, -0.3]))
        pts_w = np.asarray(rng.uniform([-2, -2, 3], [2, 2, 9], (100, 3)), np.float32)
        pc = np.asarray(se3.transform_points(T_true, jnp.asarray(pts_w)))
        xn = pc[:, :2] / pc[:, 2:]
        out_idx = rng.choice(100, 30, replace=False)
        xn[out_idx] += rng.uniform(0.05, 0.3, (30, 2)) * rng.choice([-1, 1], (30, 2))
        T, inl, n = pnp.pnp_ransac(
            jax.random.PRNGKey(1), jnp.asarray(pts_w), jnp.asarray(xn), jnp.ones(100, bool),
            num_hypotheses=128,
        )
        dt, dr = se3.distance(T, T_true)
        assert float(dt) < 0.05 and float(dr) < 0.02
        inl = np.asarray(inl)
        assert inl[out_idx].sum() <= 3

    def test_pnp_respects_mask(self, rng):
        T_true = se3.SE3(so3.identity(), jnp.asarray([0.1, 0.0, 0.2]))
        pts_w = np.asarray(rng.uniform([-2, -2, 3], [2, 2, 9], (50, 3)), np.float32)
        pc = np.asarray(se3.transform_points(T_true, jnp.asarray(pts_w)))
        xn = pc[:, :2] / pc[:, 2:]
        xn[25:] = 100.0  # garbage, masked off
        valid = jnp.asarray(np.arange(50) < 25)
        T, inl, n = pnp.pnp_ransac(jax.random.PRNGKey(2), jnp.asarray(pts_w), jnp.asarray(xn), valid)
        dt, _ = se3.distance(T, T_true)
        assert float(dt) < 0.02
        assert not np.any(np.asarray(inl)[25:])
