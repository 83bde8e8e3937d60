"""Trajectory evaluation: ATE and RPE with Umeyama alignment.

The reference evaluates offline with the external `evo` toolkit over
TUM/KITTI text files (/root/reference/results/1_readme:1-3).  This engine
ships the metrics in-repo so golden-trajectory tests can assert on them:
  - ATE RMSE after SE(3) (optionally Sim(3)) Umeyama alignment — evo_ape.
  - RPE over fixed frame deltas — evo_rpe.
"""

from __future__ import annotations

import numpy as np


def associate(t_a, t_b, max_dt=0.02):
    """Nearest-timestamp association of two trajectories → index pairs."""
    idx_b = np.searchsorted(t_b, t_a)
    idx_b = np.clip(idx_b, 0, len(t_b) - 1)
    idx_b_prev = np.clip(idx_b - 1, 0, len(t_b) - 1)
    use_prev = np.abs(t_b[idx_b_prev] - t_a) < np.abs(t_b[idx_b] - t_a)
    idx_b = np.where(use_prev, idx_b_prev, idx_b)
    ok = np.abs(t_b[idx_b] - t_a) <= max_dt
    return np.nonzero(ok)[0], idx_b[ok]


def umeyama_alignment(src, dst, with_scale=False):
    """Least-squares similarity transform aligning src → dst, (N, 3) each.

    Returns (s, R, t) with dst ≈ s·R·src + t."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_pos, gt_pos, align=True, with_scale=False):
    """Absolute trajectory error RMSE (metres) after alignment.

    est_pos, gt_pos: (N, 3) associated positions."""
    est = np.asarray(est_pos, float)
    gt = np.asarray(gt_pos, float)
    if align and len(est) >= 3:
        s, R, t = umeyama_alignment(est, gt, with_scale)
        est = (s * (R @ est.T)).T + t
    err = np.linalg.norm(est - gt, axis=1)
    return float(np.sqrt(np.mean(err ** 2))), err


def rpe(poses_est, poses_gt, delta: int = 1):
    """Relative pose error over a fixed frame delta.

    poses_*: (N, 4, 4) homogeneous T_w_c.  Returns (trans_rmse, rot_rmse_rad).
    """
    pe = np.asarray(poses_est)
    pg = np.asarray(poses_gt)
    n = min(len(pe), len(pg)) - delta
    terrs, rerrs = [], []
    for i in range(n):
        de = np.linalg.inv(pe[i]) @ pe[i + delta]
        dg = np.linalg.inv(pg[i]) @ pg[i + delta]
        e = np.linalg.inv(dg) @ de
        terrs.append(np.linalg.norm(e[:3, 3]))
        c = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        rerrs.append(np.arccos(c))
    return float(np.sqrt(np.mean(np.square(terrs)))), float(np.sqrt(np.mean(np.square(rerrs))))
