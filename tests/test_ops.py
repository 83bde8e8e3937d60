"""Tests for image ops, LK optical flow, feature detection and RANSAC,
validated against OpenCV oracles and synthetic ground truth."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from flvis_tpu.io.synthetic import textured_image, warp_translate
from flvis_tpu.ops import features as feat
from flvis_tpu.ops import image as imops
from flvis_tpu.ops import lk as lkops
from flvis_tpu.ops import ransac


@pytest.fixture(scope="module")
def tex():
    return textured_image(np.random.default_rng(3), 240, 320)


class TestImageOps:
    def test_pyr_down_matches_cv(self, tex):
        ours = np.asarray(imops.pyr_down(jnp.asarray(tex)))
        theirs = cv2.pyrDown(tex)
        # cv2.pyrDown uses the same 5-tap kernel but reflect border; compare
        # away from borders.
        np.testing.assert_allclose(ours[4:-4, 4:-4], theirs[4:-4, 4:-4], atol=1.0)

    def test_bilinear_sample_exact_on_grid(self, tex):
        img = jnp.asarray(tex)
        xy = jnp.asarray([[10.0, 20.0], [100.0, 50.0]])
        got = imops.bilinear_sample(img, xy)
        np.testing.assert_allclose(got, [tex[20, 10], tex[50, 100]], rtol=1e-6)

    def test_bilinear_sample_interpolates(self, tex):
        img = jnp.asarray(tex)
        got = imops.bilinear_sample(img, jnp.asarray([[10.5, 20.0]]))
        np.testing.assert_allclose(got, 0.5 * (tex[20, 10] + tex[20, 11]), rtol=1e-5)

    def test_extract_patches_shape(self, tex):
        p = imops.extract_patches(jnp.asarray(tex), jnp.asarray([[50.0, 60.0]]), 7)
        assert p.shape == (1, 15, 15)
        np.testing.assert_allclose(p[0, 7, 7], tex[60, 50], rtol=1e-6)

    def test_equalize_hist(self, tex):
        eq = np.asarray(imops.equalize_hist(jnp.asarray(tex)))
        cveq = cv2.equalizeHist(tex.astype(np.uint8)).astype(np.float32)
        # Same monotone mapping up to quantization.
        assert np.abs(eq - cveq).mean() < 3.0


class TestLK:
    def test_pure_translation(self, tex):
        shift = (3.7, -2.2)
        img2 = warp_translate(tex, *shift)
        pyr1 = imops.build_pyramid(jnp.asarray(tex), 3)
        pyr2 = imops.build_pyramid(jnp.asarray(img2), 3)
        rng = np.random.default_rng(0)
        pts = rng.uniform([30, 30], [290, 210], size=(64, 2)).astype(np.float32)
        valid = jnp.ones(64, bool)
        out, status, err = lkops.pyramidal_lk(
            pyr1, pyr2, jnp.asarray(pts), jnp.asarray(pts), valid,
            lkops.LKParams(radius=10, num_levels=3, iters=12),
        )
        out = np.asarray(out); status = np.asarray(status)
        assert status.mean() > 0.8
        flow = out[status] - pts[status]
        np.testing.assert_allclose(flow.mean(axis=0), shift, atol=0.1)
        assert np.abs(flow - np.array(shift)).max() < 0.5

    def test_matches_opencv(self, tex):
        img2 = warp_translate(tex, 5.0, 3.0)
        rng = np.random.default_rng(1)
        pts = rng.uniform([40, 40], [280, 200], size=(32, 2)).astype(np.float32)
        cv_pts, cv_st, _ = cv2.calcOpticalFlowPyrLK(
            tex.astype(np.uint8), img2.astype(np.uint8), pts.reshape(-1, 1, 2), None,
            winSize=(21, 21), maxLevel=2,
        )
        pyr1 = imops.build_pyramid(jnp.asarray(tex), 3)
        pyr2 = imops.build_pyramid(jnp.asarray(img2), 3)
        out, status, _ = lkops.pyramidal_lk(
            pyr1, pyr2, jnp.asarray(pts), jnp.asarray(pts), jnp.ones(32, bool),
            lkops.LKParams(radius=10, num_levels=3, iters=12),
        )
        both = np.asarray(status) & (cv_st.reshape(-1) == 1)
        assert both.mean() > 0.7
        d = np.abs(np.asarray(out)[both] - cv_pts.reshape(-1, 2)[both])
        assert d.max() < 0.5

    def test_large_motion_with_guess(self, tex):
        """IMU-style initial guess lets LK lock on despite 20 px motion."""
        img2 = warp_translate(tex, 20.0, 0.0)
        pyr1 = imops.build_pyramid(jnp.asarray(tex), 3)
        pyr2 = imops.build_pyramid(jnp.asarray(img2), 3)
        pts = np.array([[100.0, 100.0], [200.0, 150.0]], np.float32)
        guess = pts + np.array([18.0, 0.0], np.float32)
        out, status, _ = lkops.pyramidal_lk(
            pyr1, pyr2, jnp.asarray(pts), jnp.asarray(guess), jnp.ones(2, bool),
            lkops.LKParams(radius=10, num_levels=3, iters=15),
        )
        assert np.all(np.asarray(status))
        np.testing.assert_allclose(np.asarray(out) - pts, [[20, 0], [20, 0]], atol=0.2)

    def test_invalid_slots_stay_invalid(self, tex):
        pyr = imops.build_pyramid(jnp.asarray(tex), 2)
        pts = jnp.asarray([[100.0, 100.0], [50.0, 50.0]])
        valid = jnp.asarray([True, False])
        _, status, _ = lkops.pyramidal_lk(pyr, pyr, pts, pts, valid)
        assert not bool(status[1])

    def test_stereo_lk_disparity(self, tex):
        disp = 6.5
        img_r = warp_translate(tex, -disp, 0.0)
        pyr_l = imops.build_pyramid(jnp.asarray(tex), 3)
        pyr_r = imops.build_pyramid(jnp.asarray(img_r), 3)
        rng = np.random.default_rng(2)
        pts = rng.uniform([40, 40], [280, 200], size=(16, 2)).astype(np.float32)
        d, status = lkops.stereo_lk(pyr_l, pyr_r, jnp.asarray(pts), jnp.full(16, 5.0), jnp.ones(16, bool))
        got = np.asarray(d)[np.asarray(status)]
        assert len(got) > 10
        np.testing.assert_allclose(got, disp, atol=0.2)


class TestFeatures:
    def test_detects_strong_corners(self):
        img = np.full((240, 320), 40.0, np.float32)
        corners = [(60, 60), (160, 60), (60, 180), (250, 120)]
        for (cx, cy) in corners:
            img[cy:cy + 12, cx:cx + 12] = 220.0
        uv, score, valid = feat.detect_grid_features(
            jnp.asarray(img), jnp.zeros((1, 2)), jnp.zeros(1, bool),
            feat.DetectParams(per_cell=8, min_distance=9.0),
        )
        uv = np.asarray(uv)[np.asarray(valid)]
        # Every block contributes 4 corners; each injected corner should have
        # a detection within a few px of one of its block corners.
        for (cx, cy) in corners:
            block_corners = np.array([[cx, cy], [cx + 11, cy], [cx, cy + 11], [cx + 11, cy + 11]])
            d = np.linalg.norm(uv[:, None, :] - block_corners[None], axis=-1).min()
            assert d < 3.0, f"corner {(cx, cy)} missed (min dist {d})"

    def test_suppresses_near_existing(self, tex):
        img = jnp.asarray(tex)
        p = feat.DetectParams(per_cell=8, min_distance=12.0)
        uv1, _, v1 = feat.detect_grid_features(img, jnp.zeros((1, 2)), jnp.zeros(1, bool), p)
        # Feed the first detections back as "existing": nothing new may appear
        # within min_distance of them.
        uv2, _, v2 = feat.detect_grid_features(img, uv1, v1, p)
        uv1n = np.asarray(uv1)[np.asarray(v1)]
        uv2n = np.asarray(uv2)[np.asarray(v2)]
        if len(uv2n) and len(uv1n):
            d = np.linalg.norm(uv2n[:, None] - uv1n[None], axis=-1)
            assert d.min() > 12.0

    def test_respects_margin(self, tex):
        p = feat.DetectParams(margin=25)
        uv, _, valid = feat.detect_grid_features(jnp.asarray(tex), jnp.zeros((1, 2)), jnp.zeros(1, bool), p)
        uvv = np.asarray(uv)[np.asarray(valid)]
        assert np.all(uvv[:, 0] >= 25) and np.all(uvv[:, 0] < 320 - 25)
        assert np.all(uvv[:, 1] >= 25) and np.all(uvv[:, 1] < 240 - 25)

    def test_count_per_cell(self):
        uv = jnp.asarray([[10.0, 10.0], [300.0, 230.0], [310.0, 235.0]])
        mask = jnp.ones(3, bool)
        counts = feat.count_per_cell(uv, mask, (240, 320), feat.DetectParams())
        counts = np.asarray(counts)
        assert counts[0] == 1 and counts[15] == 2 and counts.sum() == 3


class TestRansac:
    def _epipolar_pairs(self, rng, n_in=80, n_out=20):
        # Random rig: camera 1 at identity, camera 2 rotated+translated.
        pts = rng.uniform([-2, -2, 4], [2, 2, 10], size=(n_in, 3))
        R = cv2.Rodrigues(np.array([0.02, -0.1, 0.01]))[0]
        t = np.array([0.4, 0.05, 0.02])
        K = np.array([[400.0, 0, 256], [0, 400.0, 192], [0, 0, 1]])
        p0 = (pts @ K.T)
        p0 = p0[:, :2] / p0[:, 2:]
        pc1 = pts @ R.T + t
        p1 = pc1 @ K.T
        p1 = p1[:, :2] / p1[:, 2:]
        out0 = rng.uniform([0, 0], [512, 384], size=(n_out, 2))
        out1 = rng.uniform([0, 0], [512, 384], size=(n_out, 2))
        P0 = np.vstack([p0, out0]).astype(np.float32)
        P1 = np.vstack([p1, out1]).astype(np.float32)
        labels = np.r_[np.ones(n_in, bool), np.zeros(n_out, bool)]
        return P0, P1, labels

    def test_fundamental_ransac(self, rng):
        import jax
        P0, P1, labels = self._epipolar_pairs(rng)
        inl, F, n = ransac.fundamental_ransac(
            jax.random.PRNGKey(0), jnp.asarray(P0), jnp.asarray(P1),
            jnp.ones(len(P0), bool), threshold=2.0,
        )
        inl = np.asarray(inl)
        # All true inliers kept, a large majority of outliers rejected.
        assert inl[labels].mean() > 0.95
        assert inl[~labels].mean() < 0.2

    def test_ransac_respects_valid_mask(self, rng):
        import jax
        P0, P1, labels = self._epipolar_pairs(rng)
        valid = jnp.asarray(labels)  # mark outlier rows invalid up-front
        inl, _, n = ransac.fundamental_ransac(
            jax.random.PRNGKey(1), jnp.asarray(P0), jnp.asarray(P1), valid, threshold=2.0
        )
        assert not np.any(np.asarray(inl)[~labels])

    def test_mad_gate(self):
        res = jnp.asarray([0.5, 0.6, 0.4, 0.55, 9.0, 0.45, 0.5, 30.0])
        valid = jnp.ones(8, bool)
        keep, thr = ransac.mad_gate(res, valid)
        keep = np.asarray(keep)
        assert not keep[4] and not keep[7]
        assert keep[[0, 1, 2, 3, 5, 6]].all()

    def test_mad_gate_ignores_invalid(self):
        res = jnp.asarray([0.5, 100.0, 0.6, 0.7])
        valid = jnp.asarray([True, False, True, True])
        keep, _ = ransac.mad_gate(res, valid)
        assert not bool(keep[1])


class TestEqualize:
    def test_tracker_equalize_toggle(self, tex):
        """cfg.equalize routes frames through histogram equalization without
        breaking tracking (the reference's blur-gate path)."""
        import numpy as np
        from flvis_tpu.config import FrontendConfig
        from flvis_tpu.frontend import tracker
        from flvis_tpu.geometry import camera
        from flvis_tpu.io.synthetic import PlanarScene, SceneConfig, orbit_trajectory

        scfg = SceneConfig()
        scene = PlanarScene(scfg, plane_depth=8.0, seed=9)
        cfg = FrontendConfig(width=scfg.width, height=scfg.height, num_slots=64,
                             pyramid_levels=3, per_cell=4, min_distance=12.0,
                             margin=22, equalize=True)
        cam = camera.make(scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline,
                          width=scfg.width, height=scfg.height)
        state = tracker.init_state(cfg)
        for (R, t) in orbit_trajectory(4, step=0.03):
            # Low-contrast input: scale intensities into [100, 130].
            img_l, img_r, _ = scene.render(R, t)
            squash = lambda im: (im / 255.0 * 30 + 100).astype(np.float32)
            state, out = tracker.track_frame(cfg, cam, state,
                                             jnp.asarray(squash(img_l)),
                                             jnp.asarray(squash(img_r)))
        assert int(out.status) == tracker.STATUS_TRACKING
        assert int(out.num_inliers) > 20


class TestDisparitySweep:
    """Dense plane-sweep block matching (ops/stereo.py) — the loop node's
    keypoint-depth source (replaces per-point stereo LK over 1000 points
    with a keypoint-count-independent sweep)."""

    def test_constant_disparity_recovered(self, tex):
        from flvis_tpu.ops import stereo

        true_d = 11.4
        right = warp_translate(tex, -true_d, 0.0)   # right image: x' = x - d
        disp, valid = stereo.disparity_sweep(jnp.asarray(tex),
                                             jnp.asarray(right))
        d = np.asarray(disp)
        v = np.asarray(valid)
        # Interior of the image: validity high, subpixel error small.
        assert v[10:-10, 14:-10].mean() > 0.8
        err = np.abs(d[v] - true_d)
        assert np.median(err) < 0.25, np.median(err)

    def test_keypoint_sampling_and_validity(self, tex):
        from flvis_tpu.ops import stereo

        true_d = 8.0
        right = warp_translate(tex, -true_d, 0.0)
        disp, valid = stereo.disparity_sweep(jnp.asarray(tex),
                                             jnp.asarray(right))
        rng = np.random.default_rng(0)
        uv = jnp.asarray(rng.uniform([30, 30], [290, 210],
                                     (100, 2)).astype(np.float32))
        d, ok = stereo.keypoint_disparity(disp, valid, uv)
        ok = np.asarray(ok)
        assert ok.mean() > 0.7
        assert np.median(np.abs(np.asarray(d)[ok] - true_d)) < 0.3

    def test_textureless_region_invalid(self):
        from flvis_tpu.ops import stereo

        rng = np.random.default_rng(1)
        img = textured_image(rng, 240, 320).copy()
        img[60:120, 80:200] = 128.0                 # flat patch
        right = warp_translate(img, -6.0, 0.0)
        disp, valid = stereo.disparity_sweep(jnp.asarray(img),
                                             jnp.asarray(right))
        v = np.asarray(valid)
        # Flat interior (away from its borders, half-res coords) invalid.
        assert v[35:55, 50:90].mean() < 0.2
