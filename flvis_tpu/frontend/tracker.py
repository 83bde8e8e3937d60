"""Frame-to-frame tracking state machine — the frontend hot loop.

Array-native re-design of the reference's F2FTracking
(/root/reference/src/frontend/f2f_tracking.cpp:59-453, states
UnInit/Tracking/TrackingFail in include/f2f_tracking.h:15-17).  The
reference's per-frame pipeline (STEP1..8 comments in image_feed) maps to:

  STEP2  LK tracking with a pose-prior-projected initial guess
         → ops.lk.pyramidal_lk (guess from IMU or constant-velocity model)
  STEP2b fundamental-matrix RANSAC consistency gate → ops.ransac
  STEP3  in-frame motion-only BA (g2o) → backend.motion_ba (robust LM; this
         also subsumes cv::solvePnPRansac since the prior is good)
  STEP4  reprojection outlier rejection with median+MAD threshold
         → ops.ransac.mad_gate (camera_frame.cpp:43-91)
  STEP5  grid redetection → ops.features + landmark_table.fill_new_detections
  STEP6  depth innovation IIR update → _depth_innovation (stereo LK left→
         right + closed-form rectified depth, camera_frame.cpp:93-330)
  STEP7/8 keyframe decision: ‖t‖ ≥ 0.05 m or ‖log R‖ ≥ 0.2 rad, plus every
         5th of the first 40 frames (f2f_tracking.cpp:338-354)

Failure handling mirrors the reference: inlier starvation at any stage
first runs a prior-free PnP RANSAC rescue (the cv::solvePnPRansac role,
lkorb_tracking.cpp:161-200); a still-starved frame is ESCAPED (pose chain
and landmark table untouched — the dummy last/curr swap) and only TWO
consecutive failures enter TrackingFail (continus_tracking_fail_cnt,
f2f_tracking.cpp:233-247).  Recovery re-initialises from the motion prior
and re-detects (357-394), raising `reset_backend` — the KFMSG_CMD_RESET_LM
equivalent — on every OTHER attempt (the reference's cnt%2 reset thinning).

Everything is ONE jitted XLA program over fixed-shape state; the whole
TrackerState pytree stays on device between frames.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..backend import motion_ba
from ..config import FrontendConfig
from ..geometry import camera as cam_m, se3 as se3m, so3, triangulation
from ..geometry.camera import StereoCamera
from ..geometry.se3 import SE3
from ..ops import features as feat_ops
from ..ops import image as imops
from ..ops import lk as lk_ops
from ..ops import pnp as pnp_ops
from ..ops import ransac as ransac_ops
from . import landmark_table as lt

STATUS_UNINIT = 0
STATUS_TRACKING = 1
STATUS_FAIL = 2


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrackerState:
    table: lt.LandmarkTable
    T_c_w: SE3                 # current camera-from-world pose
    T_prev: SE3                # previous frame pose
    velocity: jax.Array        # (6,) twist log(T_k ∘ T_{k-1}⁻¹) — motion model
    img_prev: jax.Array        # previous left image (equalized), (H, W).
    # The previous frame's gradient pyramid is REBUILT each frame in the
    # same stacked pass as the current pair rather than carried: carrying
    # the 12 pyramid arrays through the replay lax.scan materializes them
    # at every loop boundary, while recomputing them in the (3, H, W)
    # stacked build adds ~50 % elements to already-launched fused passes.
    status: jax.Array          # i32: 0 uninit / 1 tracking / 2 fail
    frame_id: jax.Array        # i32
    next_lm_id: jax.Array      # i32 (ids start at 100, landmark.cpp:3-9)
    last_kf_T: SE3
    kf_count: jax.Array        # i32
    frames_since_kf: jax.Array # i32
    # Pose record ring for late-arriving backend corrections — the reference
    # keeps a deque of 1000 pose records and rebases them when CorrectionInf
    # arrives K frames late (f2f_tracking.cpp:189-219, 329-337).
    ring_q: jax.Array          # (R, 4)
    ring_t: jax.Array          # (R, 3)
    ring_fid: jax.Array        # (R,) i32 frame id, -1 empty
    ring_head: jax.Array       # i32
    # Failure bookkeeping (two-strike entry + thinned resets, parity with
    # continus_tracking_fail_cnt / the recovery cnt%2 reset —
    # f2f_tracking.cpp:233-247, 357-394).
    fail_count: jax.Array      # i32 consecutive failed frames while Tracking
    recover_count: jax.Array   # i32 recovery attempts since last success


class FrameOutput(NamedTuple):
    T_c_w: SE3
    is_keyframe: jax.Array
    reset_backend: jax.Array   # KFMSG_CMD_RESET_LM equivalent
    num_inliers: jax.Array
    mean_reproj_err: jax.Array
    status: jax.Array


def init_state(cfg: FrontendConfig, dtype=jnp.float32) -> TrackerState:
    I = se3m.identity(dtype=dtype)
    return TrackerState(
        table=lt.empty(cfg.num_slots, dtype),
        T_c_w=I, T_prev=I,
        velocity=jnp.zeros(6, dtype),
        img_prev=jnp.zeros((cfg.height, cfg.width), dtype),
        status=jnp.asarray(STATUS_UNINIT, jnp.int32),
        frame_id=jnp.asarray(0, jnp.int32),
        next_lm_id=jnp.asarray(100, jnp.int32),
        last_kf_T=I,
        kf_count=jnp.asarray(0, jnp.int32),
        frames_since_kf=jnp.asarray(0, jnp.int32),
        ring_q=jnp.tile(jnp.asarray([1.0, 0, 0, 0], dtype), (64, 1)),
        ring_t=jnp.zeros((64, 3), dtype),
        ring_fid=jnp.full(64, -1, jnp.int32),
        ring_head=jnp.asarray(0, jnp.int32),
        fail_count=jnp.asarray(0, jnp.int32),
        recover_count=jnp.asarray(0, jnp.int32),
    )


def _detect_params(cfg: FrontendConfig) -> feat_ops.DetectParams:
    return feat_ops.DetectParams(
        grid_rows=cfg.grid_rows, grid_cols=cfg.grid_cols, per_cell=cfg.per_cell,
        min_distance=cfg.min_distance, quality_level=cfg.quality_level,
        margin=cfg.margin,
    )


def _lk_params(cfg: FrontendConfig) -> lk_ops.LKParams:
    return lk_ops.LKParams(
        radius=cfg.lk_radius, num_levels=cfg.pyramid_levels, iters=cfg.lk_iters,
        min_eig=cfg.lk_min_eig,
    )


def _measure_depth(cfg: FrontendConfig, cam: StereoCamera, pyr0, pyr1, d_img,
                   table: lt.LandmarkTable, T_c_w: SE3):
    """Depth measurement for all active slots at their current uv.

    Stereo mode: replaces CameraFrame::recover3DPts_c_FromStereo's inner LK
    + per-point SVD (camera_frame.cpp:93-180) with one batched left→right LK
    and the closed-form rectified-disparity depth.  Depth mode: bilinear
    depth-image lookup / depth_factor with range gating
    (recover3DPts_c_FromDepthImg, camera_frame.cpp:182-234).
    """
    if cfg.depth_mode:
        z = imops.bilinear_sample(d_img, table.uv) / cam.depth_factor
        ok = table.active & (z > cfg.depth_min) & (z < cfg.depth_max)
        return z, ok, ok

    p_c = se3m.transform_points(T_c_w, table.p_w)
    # Disparity prior: own depth where known, else the median depth of the
    # current 3D landmarks (scene-adaptive; a fixed wrong prior can trap the
    # stereo LK in false minima on self-similar texture).
    z3d = jnp.where(table.has_3d & table.active, p_c[:, 2], jnp.nan)
    z_med = jnp.nan_to_num(jnp.nanmedian(z3d), nan=4.0)
    z_prior = jnp.where(table.has_3d, p_c[:, 2], z_med)
    disp_guess = cam.fx * cam.baseline / jnp.clip(z_prior, cfg.depth_min, cfg.depth_max)
    # Cap the stereo pyramid at 3 levels: the coarsest levels of a deep
    # pyramid (e.g. 48x64 at level 3) produce rare but catastrophic false
    # disparities with radius-10 patches (self-consistent under the fb
    # check), and their induced reprojection error at the TRUE pose is
    # sub-Huber -- systematically dragging the motion BA toward
    # rotation-only fits.  Three levels still absorb the bootstrap guess
    # error (median-depth prior can be ~10 px off at init).
    nlv = min(3, cfg.pyramid_levels)
    stereo_params = dataclasses.replace(_lk_params(cfg), num_levels=nlv)
    disp, ok = lk_ops.stereo_lk(pyr0[:nlv], pyr1[:nlv], table.uv, disp_guess,
                                table.active, stereo_params)
    z = cam.fx * cam.baseline / jnp.maximum(disp, 1e-3)
    ok = ok & (z > cfg.depth_min) & (z < cfg.depth_max)
    stereo_ok = ok

    # Third source: motion triangulation from the first observation, for
    # slots stereo could not measure, once the translational baseline since
    # first sight exceeds the gate (recover3DPts_c_FromTriangulation,
    # camera_frame.cpp:236-270; baseline ≥ 0.2 m at line 244).
    T0 = table.obs0_pose()
    C0 = -so3.rotate(so3.conj(T0.q), T0.t)
    C1 = -so3.rotate(so3.conj(T_c_w.q), T_c_w.t)
    base = jnp.linalg.norm(C1[None, :] - C0, axis=-1)
    xn0 = cam_m.unit_ray(cam, table.obs0_uv)[:, :2]
    xn1 = cam_m.unit_ray(cam, table.uv)[:, :2]
    # First argument = CURRENT pose so the returned points are in the
    # current camera frame; poses pair 1:1 with the per-landmark
    # first-observation poses (closed-form midpoint — no per-point eigh).
    pts_c1, tri_valid = triangulation.triangulate_midpoint(
        SE3(jnp.broadcast_to(T_c_w.q, T0.q.shape),
            jnp.broadcast_to(T_c_w.t, T0.t.shape)), T0,
        xn1, xn0,
        range_max=cfg.depth_max, range_min=cfg.depth_min,
    )
    z_tri = pts_c1[:, 2]
    tri_ok = (tri_valid & table.active & (base >= cfg.tri_min_baseline)
              & ~ok)
    z = jnp.where(tri_ok, z_tri, z)
    # stereo_ok separately: triangulated depths derive their scale from the
    # odometry itself and must NOT feed the scale-anchoring u_r residuals.
    return z, ok | tri_ok, stereo_ok


def _depth_innovation(cfg: FrontendConfig, cam: StereoCamera, table: lt.LandmarkTable,
                      T_c_w: SE3, z_meas, meas_ok, stereo_ok, key,
                      bootstrap: bool = False):
    """IIR depth fusion — the system's signature depth-innovation scheme
    (CameraFrame::depthInnovation, camera_frame.cpp:271-330).

    For slots with existing 3D: blend measured depth into the map depth with
    ratio `iir_ratio` unless the innovation is a large relative jump.  For
    slots without 3D: adopt the measurement (or, for stereo bootstrap with
    dummy_depth enabled, a random depth — camera_frame.cpp:151-177).
    """
    p_c = se3m.transform_points(T_c_w, table.p_w)
    z_old = p_c[:, 2]
    rel_jump = jnp.abs(z_meas - z_old) / jnp.maximum(z_old, 1e-3)
    accept = meas_ok & (rel_jump < cfg.innovation_gate)
    z_fused = jnp.where(
        table.has_3d,
        jnp.where(accept, (1.0 - cfg.iir_ratio) * z_old + cfg.iir_ratio * z_meas, z_old),
        z_meas,
    )

    # Two-consistent-measurement adoption for new slots: a single stereo LK
    # match can lock onto a false minimum (self-similar texture); adopting it
    # poisons the pose BA (rotation-only fits then beat translation because
    # rotation flow is depth-independent).  Require the first two
    # measurements to agree within the innovation gate.
    pend_rel = jnp.abs(z_meas - table.z_pend) / jnp.maximum(table.z_pend, 1e-3)
    if bootstrap:
        # Sequence init / failure recovery: adopt single measurements so the
        # very next frame has 3D points to track against (init_frame path,
        # f2f_tracking.cpp:402-453).
        adopt = ~table.has_3d & meas_ok
    else:
        adopt = ~table.has_3d & meas_ok & table.pend_ok & (pend_rel < cfg.innovation_gate)
    z_fused = jnp.where(adopt, jnp.where(table.pend_ok & (pend_rel < cfg.innovation_gate),
                                         0.5 * (z_meas + table.z_pend), z_meas), z_fused)
    z_pend = jnp.where(~table.has_3d & meas_ok & ~adopt, z_meas, table.z_pend)
    pend_ok = jnp.where(table.has_3d, False,
                        jnp.where(adopt, False, table.pend_ok | meas_ok))

    # Evict persistently-inconsistent depths: after 3 consecutive rejected
    # innovations the stored depth is presumed wrong and the slot re-enters
    # the bootstrap path.
    rej = jnp.where(table.has_3d & meas_ok & ~accept, table.rej_count + 1,
                    jnp.where(table.has_3d & accept, 0, table.rej_count))
    evict = table.has_3d & (rej >= 3)

    if cfg.dummy_depth:
        lo, hi = cfg.dummy_depth_range
        z_dummy = jax.random.uniform(key, z_meas.shape, z_meas.dtype, lo, hi)
        z_fused = jnp.where(~table.has_3d & ~meas_ok, z_dummy, z_fused)
        adopt = adopt | (~table.has_3d & ~meas_ok)  # dummy counts as adoption
        new_has = table.active & ~evict
    else:
        new_has = table.active & (table.has_3d | adopt) & ~evict

    p_c_new = cam_m.backproject(cam, table.uv, z_fused)
    p_w_new = cam_m.cam_to_world(T_c_w, p_c_new)
    # Only measurement-backed slots are re-anchored onto the current ray;
    # rewriting unmeasured landmarks would absorb LK/pose drift into the
    # map (the reference leaves lm_3d_w untouched without a measurement).
    rewrite = (accept | adopt) & new_has
    p_w = jnp.where(rewrite[:, None], p_w_new, table.p_w)
    # Record the stereo right-image coordinate implied by the *measured*
    # depth (u_r = u − fx·b/z).  Exported with keyframes so the window BA
    # gets scale-fixing stereo residuals (ORB-SLAM2-style; the reference's
    # monocular-only g2o edges leave scale to drift between depth updates).
    ur = table.uv[:, 0] - cam.fx * cam.baseline / jnp.maximum(z_meas, 1e-3)
    ur_ok = stereo_ok & table.active & (cam.baseline > 0)
    return dataclasses.replace(
        table, p_w=p_w, has_3d=new_has,
        ur=jnp.where(ur_ok, ur, table.ur), ur_ok=ur_ok,
        z_pend=z_pend, pend_ok=pend_ok,
        rej_count=jnp.where(evict, 0, rej),
    )


def _redetect(cfg: FrontendConfig, img0, table: lt.LandmarkTable, T_c_w: SE3, next_id):
    cand_uv, _, cand_valid = feat_ops.detect_grid_features(
        img0, table.uv, table.active, _detect_params(cfg)
    )
    return lt.fill_new_detections(table, cand_uv, cand_valid, T_c_w, next_id)


def _init_branch(cfg: FrontendConfig, cam: StereoCamera, state: TrackerState,
                 pyr0, pyr1, d_img, T_init: SE3, key):
    """UnInit / TrackingFail recovery: wipe, detect, recover depth
    (f2f_tracking.cpp:402-453 init_frame; recovery at 357-394)."""
    table = lt.empty(cfg.num_slots, state.table.uv.dtype)
    table, next_id = _redetect(cfg, pyr0[0][0], table, T_init, state.next_lm_id)
    z, ok, st_ok = _measure_depth(cfg, cam, pyr0, pyr1, d_img, table, T_init)
    table = _depth_innovation(cfg, cam, table, T_init, z, ok, st_ok, key,
                              bootstrap=True)
    was_fail = state.status == STATUS_FAIL
    new_state = dataclasses.replace(
        state,
        table=table, T_c_w=T_init, T_prev=T_init,
        velocity=jnp.zeros_like(state.velocity),
        status=jnp.asarray(STATUS_TRACKING, jnp.int32),
        next_lm_id=next_id,
        last_kf_T=T_init,
        kf_count=state.kf_count + 1,
        frames_since_kf=jnp.asarray(0, jnp.int32),
        fail_count=jnp.asarray(0, jnp.int32),
        recover_count=jnp.where(was_fail, state.recover_count + 1, 0)
        .astype(jnp.int32),
    )
    # Backend reset only on every OTHER recovery attempt — the reference
    # thins its KFMSG_CMD_RESET_LM to cnt%2 of the fail-state frames
    # (f2f_tracking.cpp:387-391) so marginal scenes don't wipe the BA
    # window on every hiccup.
    out = FrameOutput(
        T_c_w=T_init,
        is_keyframe=jnp.asarray(True),
        reset_backend=was_fail & (state.recover_count % 2 == 0),
        num_inliers=lt.num_tracked_3d(table),
        mean_reproj_err=jnp.asarray(0.0, jnp.float32),
        status=new_state.status,
    )
    return new_state, out


def _track_branch(cfg: FrontendConfig, cam: StereoCamera, state: TrackerState,
                  pyr_prev, pyr0, pyr1, d_img, T_prior: SE3, key):
    table = state.table
    k_ransac, k_depth, k_pnp = jax.random.split(key, 3)

    # --- STEP2: LK with projected initial guess -----------------------------
    p_c_pred = se3m.transform_points(T_prior, table.p_w)
    uv_guess_3d = cam_m.project(cam, p_c_pred)
    use_proj = table.has_3d & (p_c_pred[:, 2] > cfg.depth_min) \
        & cam_m.in_bounds(cam, uv_guess_3d)
    uv_guess = jnp.where(use_proj[:, None], uv_guess_3d, table.uv)
    uv_new, lk_ok, _ = lk_ops.pyramidal_lk(
        pyr_prev, pyr0, table.uv, uv_guess, table.active, _lk_params(cfg)
    )

    # --- STEP2b: fundamental-matrix consistency gate ------------------------
    f_inl, _, _ = ransac_ops.fundamental_ransac(
        k_ransac, table.uv, uv_new, table.active & lk_ok,
        threshold=cfg.ransac_threshold, num_hypotheses=cfg.ransac_hypotheses,
    )

    # --- STEP3: motion-only BA (robust LM, two starts) ----------------------
    # Near-uniform-depth scenes have a shallow rotation/translation valley;
    # LM from a static prior occasionally settles in a rotation-dominated
    # local minimum whose residual is 3x the true pose's.  A second start
    # that explains the median flow as PURE TRANSLATION brackets the valley
    # from the other side; the lower-residual solution wins.
    ba_mask = table.active & lk_ok & f_inl & table.has_3d
    flow = uv_new - table.uv
    wm = ba_mask.astype(flow.dtype)
    p_c_prior = se3m.transform_points(T_prior, table.p_w)
    z_med = jnp.nan_to_num(
        jnp.nanmedian(jnp.where(ba_mask, p_c_prior[:, 2], jnp.nan)), nan=4.0)
    fl_med = jnp.nanmedian(jnp.where(ba_mask[:, None], flow, jnp.nan), axis=0)
    fl_med = jnp.nan_to_num(fl_med)
    t_hyp = jnp.asarray([-1.0, 0.0, 0.0]) * fl_med[0] * z_med / cam.fx +         jnp.asarray([0.0, -1.0, 0.0]) * fl_med[1] * z_med / cam.fy
    T_prior_b = se3m.compose(SE3(so3.identity(), t_hyp), T_prior)

    def run_ba(T0):
        return motion_ba.optimize_pose(
            cam, T0, table.p_w, uv_new, ba_mask,
            iters1=cfg.ba_iters1, iters2=cfg.ba_iters2,
            huber_delta=cfg.huber_delta, chi2_cull=cfg.chi2_cull,
            min_points=cfg.min_inliers,
        )

    # Both starts run as ONE vmapped LM program (batch=2): the LM loop is
    # latency-bound (a chain of small ops), so batching the starts costs
    # little arithmetic but halves the sequential op chain.
    T0s = jax.tree.map(lambda a, b: jnp.stack([a, b]), T_prior, T_prior_b)
    ba_pair = jax.vmap(run_ba)(T0s)

    def mean_err(T):
        r = cam_m.project_world(cam, T, table.p_w) - uv_new
        rn = jnp.linalg.norm(r, axis=-1)
        return jnp.sum(jnp.where(ba_mask, jnp.minimum(rn, 5.0), 0.0)) /             jnp.maximum(jnp.sum(ba_mask), 1)

    errs = jax.vmap(mean_err)(ba_pair.T_c_w)
    use_b = errs[1] < errs[0]
    ba = jax.tree.map(lambda x: jnp.where(use_b, x[1], x[0]), ba_pair)
    T_new = ba.T_c_w

    # --- STEP4: median+MAD reprojection gate --------------------------------
    def eval_pose(T, ba_inl):
        reproj = cam_m.project_world(cam, T, table.p_w)
        err = jnp.linalg.norm(reproj - uv_new, axis=-1)
        mad_ok, _ = ransac_ops.mad_gate(err, ba_mask & ba_inl,
                                        sigma_mult=cfg.mad_sigma)
        survivors = table.active & lk_ok & f_inl & \
            jnp.where(table.has_3d, mad_ok, True)
        return survivors, jnp.sum(survivors & table.has_3d), err

    survivors, num_inl, err = eval_pose(T_new, ba.inliers)

    if cfg.pnp_fallback:
        # Prior-free PnP rescue before declaring failure: when the prior-
        # seeded motion BA starves (abrupt un-predicted motion breaks both
        # LM starts), solve the pose from the F-gated LK matches with
        # EPnP RANSAC and re-polish — the reference runs cv::solvePnPRansac
        # on every frame for exactly this robustness
        # (lkorb_tracking.cpp:161-200); here it costs only starving frames.
        def rescue(_):
            xn = jnp.stack([(uv_new[:, 0] - cam.cx) / cam.fx,
                            (uv_new[:, 1] - cam.cy) / cam.fy], axis=-1)
            T_pnp, _, _ = pnp_ops.pnp_ransac(
                k_pnp, table.p_w, xn, ba_mask,
                threshold_n=cfg.ransac_threshold / cam.fx,
                num_hypotheses=cfg.ransac_hypotheses)
            ba2 = run_ba(T_pnp)
            s2, n2, e2 = eval_pose(ba2.T_c_w, ba2.inliers)
            return ba2.T_c_w, s2, n2, e2

        def keep(_):
            return T_new, survivors, num_inl, err

        T_new, survivors, num_inl, err = jax.lax.cond(
            num_inl < cfg.min_inliers, rescue, keep, None)

    failed = num_inl < cfg.min_inliers

    # --- update table with tracking results ---------------------------------
    table = dataclasses.replace(
        table,
        uv=jnp.where(lk_ok[:, None], uv_new, table.uv),
        inlier=survivors,
        age=jnp.where(survivors, table.age + 1, table.age),
    )
    table = lt.kill(table, table.active & ~survivors)

    mean_err = jnp.sum(jnp.where(survivors & table.has_3d, err, 0.0)) / jnp.maximum(num_inl, 1)

    # --- STEP5: redetect into freed slots -----------------------------------
    table, next_id = _redetect(cfg, pyr0[0][0], table, T_new, state.next_lm_id)

    # --- STEP6: depth innovation --------------------------------------------
    z, z_ok, st_ok = _measure_depth(cfg, cam, pyr0, pyr1, d_img, table, T_new)
    table = _depth_innovation(cfg, cam, table, T_new, z, z_ok, st_ok, k_depth)

    # --- STEP7/8: motion model + keyframe decision --------------------------
    velocity = se3m.log(se3m.compose(T_new, se3m.inverse(state.T_prev)))
    dt_norm, dr_norm = se3m.distance(state.last_kf_T, T_new)
    bootstrap = (state.frame_id < cfg.kf_bootstrap_frames) & (
        (state.frames_since_kf + 1) >= cfg.kf_bootstrap_every
    )
    is_kf = (~failed) & (
        (dt_norm >= cfg.kf_min_trans) | (dr_norm >= cfg.kf_min_rot) | bootstrap
    )

    # Two-strike failure entry (continus_tracking_fail_cnt >= 2,
    # f2f_tracking.cpp:233-247): the first bad frame is ESCAPED — pose
    # chain, velocity, and landmark table survive unchanged (the reference's
    # dummy last/curr swap) and tracking continues; only a second
    # consecutive failure enters the FAIL state.
    second = failed & (state.fail_count + 1 >= 2)
    new_status = jnp.where(second, STATUS_FAIL, STATUS_TRACKING).astype(jnp.int32)
    new_fail_count = jnp.where(
        failed, jnp.where(second, 0, state.fail_count + 1), 0).astype(jnp.int32)

    new_state = dataclasses.replace(
        state,
        table=table,
        T_c_w=T_new,
        T_prev=jax.tree.map(lambda a: a, T_new),
        velocity=velocity,
        status=new_status,
        next_lm_id=next_id,
        last_kf_T=jax.tree.map(
            lambda a, b: jnp.where(is_kf, b, a), state.last_kf_T, T_new
        ),
        kf_count=state.kf_count + is_kf.astype(jnp.int32),
        frames_since_kf=jnp.where(is_kf, 0, state.frames_since_kf + 1).astype(jnp.int32),
        fail_count=new_fail_count,
        recover_count=jnp.asarray(0, jnp.int32),
    )
    esc_state = dataclasses.replace(
        state, status=new_status, fail_count=new_fail_count,
        recover_count=jnp.asarray(0, jnp.int32))
    new_state = jax.tree.map(lambda a, b: jnp.where(failed, a, b),
                             esc_state, new_state)
    out = FrameOutput(
        T_c_w=jax.tree.map(lambda a, b: jnp.where(failed, a, b),
                           state.T_c_w, T_new),
        is_keyframe=is_kf,
        reset_backend=jnp.asarray(False),
        num_inliers=num_inl,
        mean_reproj_err=mean_err,
        status=new_status,
    )
    return new_state, out


# NOTE: no buffer donation — several state fields legitimately alias the same
# device buffer (e.g. T_c_w and T_prev right after a keyframe), and XLA
# rejects donating one buffer twice.
@functools.partial(jax.jit, static_argnames=("cfg", "use_prior"))
def track_frame(cfg: FrontendConfig, cam: StereoCamera, state: TrackerState,
                img0, img1, prior_T: Optional[SE3] = None, use_prior: bool = False,
                rng_key=None):
    """Process one stereo frame.  The whole step is a single XLA program.

    Args:
      img0/img1: (H, W) float32 left/right rectified images.
      prior_T: optional externally-supplied pose prediction (IMU feedforward,
        VIMOTION::viGetCorrFrameState equivalent).  When absent the
        constant-velocity model extrapolates the last inter-frame twist.
      rng_key: optional PRNGKey; defaults to a fold of the frame id.
    """
    if rng_key is None:
        rng_key = jax.random.fold_in(jax.random.PRNGKey(7), state.frame_id)

    # Accept uint8 frames and widen ON DEVICE: real cameras produce uint8,
    # and shipping f32 over the host link quadruples the transfer (2.8 MB
    # per EuRoC-resolution f32 stereo pair).  Depth-mode img1
    # (Z16/float depth) is NOT intensity and keeps its dtype.
    if img0.dtype != jnp.float32:
        img0 = img0.astype(jnp.float32)
    if not cfg.depth_mode and img1.dtype != jnp.float32:
        img1 = img1.astype(jnp.float32)

    # Gradient pyramids for the PREVIOUS left image (temporal LK template),
    # the current left image and the current right image are built in ONE
    # stacked (3, H, W) pass: equalization, each separable filter tap and
    # each decimation runs as a single fused pass over all images at once
    # instead of one launch per image.  img_prev is stored post-equalization, so only
    # the current images go through equalize_hist here.  In depth mode img1
    # is the raw depth image and needs no pyramid or equalization.
    if cfg.depth_mode:
        if cfg.equalize:
            # Depth images are never intensity data and are left untouched.
            img0 = imops.equalize_hist(img0)
        stack = jnp.stack([state.img_prev, img0])
        pyrs = imops.build_grad_pyramid(stack, cfg.pyramid_levels)
        pyr_prev = tuple((im[0], gx[0], gy[0]) for im, gx, gy in pyrs)
        pyr0 = tuple((im[1], gx[1], gy[1]) for im, gx, gy in pyrs)
        pyr1, d_img = None, img1
        img_prev_next = img0
    else:
        pair = jnp.stack([img0, img1])
        if cfg.equalize:
            # Each image gets its own histogram (cv::equalizeHist semantics,
            # applied to the pair as the reference does,
            # f2f_tracking.cpp:127-148).
            pair = imops.equalize_hist(pair)
        stack = jnp.concatenate([state.img_prev[None], pair])
        pyrs = imops.build_grad_pyramid(stack, cfg.pyramid_levels)
        pyr_prev = tuple((im[0], gx[0], gy[0]) for im, gx, gy in pyrs)
        pyr0 = tuple((im[1], gx[1], gy[1]) for im, gx, gy in pyrs)
        pyr1 = tuple((im[2], gx[2], gy[2]) for im, gx, gy in pyrs)
        d_img = None
        img_prev_next = pair[0]

    if use_prior and prior_T is not None:
        T_pred = prior_T
    else:
        T_pred = se3m.compose(se3m.exp(state.velocity), state.T_prev)

    def do_init(st):
        return _init_branch(cfg, cam, st, pyr0, pyr1, d_img, T_pred, rng_key)

    def do_track(st):
        return _track_branch(cfg, cam, st, pyr_prev, pyr0, pyr1, d_img, T_pred,
                             rng_key)

    new_state, out = jax.lax.cond(state.status == STATUS_TRACKING, do_track, do_init, state)
    # Escaped frames keep the last GOOD LK template: the reference's dummy
    # swap makes the corrupted image the next template, so even a single
    # blank frame cascades into TrackingFail on the following good frame;
    # holding the template lets tracking resume across the gap (the pose
    # prior absorbs the doubled inter-template motion).
    escaped = (new_state.fail_count > state.fail_count) | \
        (new_state.status == STATUS_FAIL)
    # Record this frame's pose in the rebase ring (STEP7 pose_records push,
    # f2f_tracking.cpp:329-337).
    h = new_state.ring_head
    new_state = dataclasses.replace(
        new_state,
        img_prev=jnp.where(escaped, state.img_prev, img_prev_next),
        frame_id=state.frame_id + 1,
        ring_q=new_state.ring_q.at[h].set(new_state.T_c_w.q),
        ring_t=new_state.ring_t.at[h].set(new_state.T_c_w.t),
        ring_fid=new_state.ring_fid.at[h].set(state.frame_id),
        ring_head=(h + 1) % new_state.ring_fid.shape[0],
    )
    return new_state, out


@jax.jit
def make_keyframe_packet(state: TrackerState, out: FrameOutput):
    """Snapshot the landmark table as a KeyframePacket for the backends —
    the /vo_kf publication (KeyFrameMsg::pub, keyframe_msg.cpp:30-124).
    The frame id is the one just processed (frame_id was incremented)."""
    from ..backend.window_ba import KeyframePacket

    t = state.table
    mask = t.active & t.has_3d & t.inlier
    return KeyframePacket(
        frame_id=state.frame_id - 1,
        q=state.T_c_w.q, t=state.T_c_w.t,
        lm_id=t.lm_id, lm_uv=t.uv,
        lm_ur=t.ur, lm_ur_mask=t.ur_ok & mask,
        lm_pw=t.p_w, lm_mask=mask,
    )


def apply_correction_(state: TrackerState, corr):
    """Traced-context variant of apply_correction (no jit wrapper): the
    fused chunk programs call THIS so the cond inlines into their scan body
    — a nested jit inside a scan is kept as a separate XLA call and blocks
    cross-op fusion.  The whole body runs under lax.cond on corr.valid:
    inside the fused chunk scan this is a REAL branch, so the ~45% of
    frames that carry no pending correction skip the two
    (slots × capacity) id-matching masks entirely.
    Under vmap (multi-sequence DP) the cond lowers to select."""
    return jax.lax.cond(corr.valid,
                        lambda st: _apply_correction_body(st, corr),
                        lambda st: st, state)


@jax.jit
def apply_correction(state: TrackerState, corr):
    """Apply a (late) backend Correction: rebase the current pose chain onto
    the corrected keyframe pose, overwrite landmark positions, kill outliers
    — F2FTracking's STEP1 (f2f_tracking.cpp:189-219) plus
    forceCorrectLM3DW / forceMarkOutlier (camera_frame.cpp:332-376).
    One compiled program for the eager per-frame path; fused chunk
    programs use apply_correction_."""
    return apply_correction_(state, corr)


def _apply_correction_body(state: TrackerState, corr):
    hit = state.ring_fid == corr.frame_id
    found = jnp.any(hit) & corr.valid
    idx = jnp.argmax(hit)
    T_old = SE3(state.ring_q[idx], state.ring_t[idx])
    T_new = SE3(corr.q, corr.t)
    # Right-multiplicative rebase: T' = T ∘ T_old⁻¹ ∘ T_new.
    delta = se3m.compose(se3m.inverse(T_old), T_new)

    def rebase(T: SE3) -> SE3:
        Tc = se3m.compose(T, delta)
        return jax.tree.map(lambda a, b: jnp.where(found, b, a), T, Tc)

    # Landmark correction by id matching (corr arrays are backend-capacity).
    t = state.table
    eq = (t.lm_id[:, None] == corr.lm_id[None, :]) & corr.lm_mask[None, :] & (t.lm_id[:, None] >= 0)
    has = jnp.any(eq, axis=1) & found
    src = jnp.argmax(eq, axis=1)
    p_w = jnp.where(has[:, None], corr.lm_pw[src], t.p_w)

    out_eq = (t.lm_id[:, None] == corr.outlier_id[None, :]) & corr.outlier_mask[None, :] & (t.lm_id[:, None] >= 0)
    is_out = jnp.any(out_eq, axis=1) & found
    table = dataclasses.replace(
        t, p_w=p_w, active=t.active & ~is_out, inlier=t.inlier & ~is_out
    )

    # Rebase ring entries recorded at or after the corrected frame.
    newer = (state.ring_fid >= corr.frame_id) & (state.ring_fid >= 0) & found
    ring_T = se3m.compose(SE3(state.ring_q, state.ring_t), delta)
    return dataclasses.replace(
        state,
        table=table,
        T_c_w=rebase(state.T_c_w),
        T_prev=rebase(state.T_prev),
        last_kf_T=rebase(state.last_kf_T),
        ring_q=jnp.where(newer[:, None], ring_T.q, state.ring_q),
        ring_t=jnp.where(newer[:, None], ring_T.t, state.ring_t),
    )


def rebase_pose_(state: TrackerState, frame_id, T_new: SE3, do):
    """Traced-context variant of rebase_pose (no jit wrapper — see
    apply_correction_): pose-only rebase of the chain and the ring entries
    at/after `frame_id` onto T_new, leaving the landmark table untouched —
    the viVisionRPCompensation write-back (f2f_tracking.cpp:251-254)."""
    hit = state.ring_fid == frame_id
    found = jnp.any(hit) & do
    idx = jnp.argmax(hit)
    T_old = SE3(state.ring_q[idx], state.ring_t[idx])
    delta = se3m.compose(se3m.inverse(T_old), T_new)

    def rebase(T: SE3) -> SE3:
        Tc = se3m.compose(T, delta)
        return jax.tree.map(lambda a, b: jnp.where(found, b, a), T, Tc)

    newer = (state.ring_fid >= frame_id) & (state.ring_fid >= 0) & found
    ring_T = se3m.compose(SE3(state.ring_q, state.ring_t), delta)
    return dataclasses.replace(
        state,
        T_c_w=rebase(state.T_c_w),
        T_prev=rebase(state.T_prev),
        last_kf_T=rebase(state.last_kf_T),
        ring_q=jnp.where(newer[:, None], ring_T.q, state.ring_q),
        ring_t=jnp.where(newer[:, None], ring_T.t, state.ring_t),
    )


@jax.jit
def rebase_pose(state: TrackerState, frame_id, T_new: SE3, do):
    """One compiled program for the eager per-frame path (advisor round 2);
    fused chunk programs use rebase_pose_."""
    return rebase_pose_(state, frame_id, T_new, do)


@functools.partial(jax.jit, static_argnames=("cfg", "with_packets"))
def track_frames_scan(cfg: FrontendConfig, cam: StereoCamera,
                      state: TrackerState, imgs0, imgs1,
                      with_packets: bool = False):
    """Process a chunk of T frames as ONE device program (lax.scan).

    The replay mode: per-frame Python dispatch disappears and XLA
    pipelines the chunk; outputs come back stacked.  Semantics match calling
    track_frame T times with no prior and no interleaved corrections (the
    per-frame RNG is the same frame-id fold, so results are bitwise
    identical) — backend feedback then applies at chunk boundaries instead
    of per frame, which is exactly the reference's "corrections arrive K
    frames late" contract (f2f_tracking.cpp:189-219) with K = chunk length.

    Args:
      imgs0/imgs1: (T, H, W) stacked rectified stereo (or depth) frames.
      with_packets: also return a KeyframePacket per frame (the /vo_kf
        stream for the backends; rows are meaningful where is_keyframe).
    Returns: (final TrackerState, FrameOutput stacked over T[, packets]).
    """
    def step(st, xs):
        i0, i1 = xs
        st2, out = track_frame(cfg, cam, st, i0, i1)
        if with_packets:
            return st2, (out, make_keyframe_packet(st2, out))
        return st2, out

    return jax.lax.scan(step, state, (imgs0, imgs1))
