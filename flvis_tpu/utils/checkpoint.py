"""Checkpoint/resume for SLAM state.

The reference has NO state checkpointing — only debug dumps of the
similarity matrix and g2o graphs to hard-coded home paths
(/root/reference/src/backend/vo_loopclosing.cpp:439-452,879,887).  This
engine treats map/trajectory persistence as a first-class capability: any
jax pytree (TrackerState, WindowState, VioState, ...) round-trips through a
single .npz via its flattened key paths, with structure checked against a
template on load.  No pickle — files are plain arrays.
"""

from __future__ import annotations

import numpy as np

import jax


def _key(path) -> str:
    parts = []
    for p in path:
        if hasattr(p, "name"):
            parts.append(str(p.name))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        elif hasattr(p, "key"):
            parts.append(str(p.key))
        else:
            parts.append(str(p))
    return "/".join(parts)


def save_pytree(path: str, tree) -> None:
    """Write a pytree of arrays to `path` (.npz)."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    arrays = {}
    for p, leaf in flat:
        arrays[_key(p)] = np.asarray(leaf)
    np.savez_compressed(path, **arrays)


def load_pytree(path: str, template):
    """Load a pytree saved by save_pytree, using `template` for structure
    (shapes/dtypes are validated; static dataclass fields come from the
    template)."""
    data = np.load(path)
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    leaves = []
    for p, leaf in flat:
        k = _key(p)
        if k not in data:
            raise KeyError(f"checkpoint missing leaf {k!r}")
        arr = data[k]
        want = np.asarray(leaf)
        if arr.shape != want.shape:
            raise ValueError(f"leaf {k!r}: shape {arr.shape} != template {want.shape}")
        leaves.append(jax.numpy.asarray(arr.astype(want.dtype)))
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template), leaves
    )


def save_slam_system(path: str, slam) -> None:
    """Checkpoint a pipeline.runner.SlamSystem (frontend + backend + VIO
    state and the trajectory log).  A pipelined system drains its in-flight
    chunk and deferred loop batches first so the snapshot is
    stream-consistent."""
    if getattr(slam, "_inflight", None) is not None or \
            getattr(slam, "_pending_gate", None) is not None or \
            getattr(slam, "_pending_verify", None) is not None:
        slam.flush()
    state = {
        "fe": slam.fe_state,
        "ba": slam.ba_state,
        "vio": slam.vio_state,
    }
    save_pytree(path, state)
    traj = np.asarray(
        [[fid, t, *np.asarray(q), *np.asarray(tt)] for (fid, t, q, tt) in slam.trajectory],
        np.float64,
    ).reshape(-1, 9)
    np.save(path + ".traj.npy", traj)
    if slam.loop_closer is not None:
        save_loop_closer(path + ".loop.npz", slam.loop_closer)


def load_slam_system(path: str, slam) -> None:
    """Restore a SlamSystem checkpoint in place (slam provides templates)."""
    state = load_pytree(path, {
        "fe": slam.fe_state, "ba": slam.ba_state, "vio": slam.vio_state,
    })
    slam.fe_state = state["fe"]
    slam.ba_state = state["ba"]
    slam.vio_state = state["vio"]
    traj = np.load(path + ".traj.npy")
    slam.trajectory = [
        (int(r[0]), float(r[1]), r[2:6].astype(np.float32), r[6:9].astype(np.float32))
        for r in traj
    ]
    # Host mirror of fe_state.frame_id (one trajectory entry per frame).
    slam._frames_processed = len(slam.trajectory)
    import os

    if slam.loop_closer is not None and os.path.exists(path + ".loop.npz"):
        load_loop_closer(path + ".loop.npz", slam.loop_closer)


def save_loop_closer(path: str, lc) -> None:
    """Checkpoint a loop.loop_closing.LoopCloser: keyframe database (BoW
    vectors, ORB features, keypoint 3D), node poses, accepted closures,
    drift transform, and the trained vocabulary."""
    n = lc.count
    arrays = {
        "bow_db": np.asarray(lc.bow_db)[:n],
        "kf_uv": np.asarray(lc.kf_uv[:n]), "kf_desc": np.asarray(lc.kf_desc[:n]),
        "kf_kp_valid": np.asarray(lc.kf_kp_valid[:n]),
        "kf_pc": np.asarray(lc.kf_pc[:n]),
        "kf_pc_valid": np.asarray(lc.kf_pc_valid[:n]),
        "kf_frame_id": lc.kf_frame_id[:n],
        "T_wc_odom_q": np.asarray(lc.kf_q_odom[:n]),
        "T_wc_odom_t": np.asarray(lc.kf_t_odom[:n]),
        "T_wc_q": np.asarray(lc.kf_q[:n]),
        "T_wc_t": np.asarray(lc.kf_t[:n]),
        "closures": np.asarray(
            [[c.kf_i, c.kf_j, c.num_inliers, *np.asarray(c.T_ij.q),
              *np.asarray(c.T_ij.t)] for c in lc.closures],
            np.float64).reshape(-1, 10),
        "T_map_odom_q": np.asarray(lc.T_map_odom.q),
        "T_map_odom_t": np.asarray(lc.T_map_odom.t),
    }
    if lc.vocab is not None:
        arrays["vocab_words"] = np.asarray(lc.vocab.words_pm1)
        arrays["vocab_idf"] = np.asarray(lc.vocab.idf)
    np.savez_compressed(path, **arrays)


def load_loop_closer(path: str, lc) -> None:
    """Restore a LoopCloser checkpoint in place (lc provides capacity)."""
    import jax.numpy as jnp

    from ..geometry.se3 import SE3
    from ..loop import bow
    from ..loop.loop_closing import LoopClosure

    d = np.load(path)
    n = len(d["kf_frame_id"])
    if n > lc.cfg.max_keyframes:
        raise ValueError(f"checkpoint has {n} KFs > capacity {lc.cfg.max_keyframes}")
    if "vocab_words" in d:
        lc.vocab = bow.Vocabulary(jnp.asarray(d["vocab_words"]),
                                  jnp.asarray(d["vocab_idf"]))
    lc.count = n
    for i in range(n):
        lc._set_db_row(i, jnp.asarray(d["bow_db"][i]))
    lc.kf_uv = lc.kf_uv.at[:n].set(jnp.asarray(d["kf_uv"]))
    lc.kf_desc = lc.kf_desc.at[:n].set(jnp.asarray(d["kf_desc"]))
    lc.kf_kp_valid = lc.kf_kp_valid.at[:n].set(jnp.asarray(d["kf_kp_valid"]))
    lc.kf_pc = lc.kf_pc.at[:n].set(jnp.asarray(d["kf_pc"]))
    lc.kf_pc_valid = lc.kf_pc_valid.at[:n].set(jnp.asarray(d["kf_pc_valid"]))
    lc.kf_frame_id[:n] = d["kf_frame_id"]
    lc.kf_q_odom = lc.kf_q_odom.at[:n].set(jnp.asarray(d["T_wc_odom_q"]))
    lc.kf_t_odom = lc.kf_t_odom.at[:n].set(jnp.asarray(d["T_wc_odom_t"]))
    lc.kf_q = lc.kf_q.at[:n].set(jnp.asarray(d["T_wc_q"]))
    lc.kf_t = lc.kf_t.at[:n].set(jnp.asarray(d["T_wc_t"]))
    lc.closures = [
        # Host-side numpy, matching the live creation path (loop-edge
        # rebuilds read these with np.asarray per event).
        LoopClosure(int(r[0]), int(r[1]), int(r[2]),
                    SE3(np.asarray(r[3:7], np.float32),
                        np.asarray(r[7:10], np.float32)))
        for r in d["closures"]
    ]
    lc.T_map_odom = SE3(jnp.asarray(d["T_map_odom_q"]),
                        jnp.asarray(d["T_map_odom_t"]))


def save_multiseq(path: str, ms) -> None:
    """Checkpoint a parallel.multiseq_loop.MultiSeqSlam: the batched
    (tracker, BA, correction[, VIO]) device states, per-sequence
    trajectories, and each sequence's loop node.  Drains the in-flight
    chunk and deferred loop batches first (stream-consistent snapshot)."""
    ms.flush()
    state = {"fe": ms.fe, "ba": ms.ba, "corr": ms.corr}
    if ms.vio is not None:
        state["vio"] = ms.vio
    save_pytree(path, state)
    for s in range(ms.S):
        traj = np.asarray(
            [[fid, t, *np.asarray(q), *np.asarray(tt)]
             for (fid, t, q, tt) in ms.trajectories[s]],
            np.float64).reshape(-1, 9)
        np.save(f"{path}.traj{s}.npy", traj)
        if ms.loopers[s] is not None:
            save_loop_closer(f"{path}.loop{s}.npz", ms.loopers[s])


def load_multiseq(path: str, ms) -> None:
    """Restore a MultiSeqSlam checkpoint in place (ms provides templates,
    sequence count, and loop-node capacity)."""
    import os

    tmpl = {"fe": ms.fe, "ba": ms.ba, "corr": ms.corr}
    if ms.vio is not None:
        tmpl["vio"] = ms.vio
    state = load_pytree(path, tmpl)
    ms.fe, ms.ba, ms.corr = state["fe"], state["ba"], state["corr"]
    if ms.vio is not None:
        ms.vio = state["vio"]
    for s in range(ms.S):
        traj = np.load(f"{path}.traj{s}.npy")
        ms.trajectories[s] = [
            (int(r[0]), float(r[1]), r[2:6].astype(np.float32),
             r[6:9].astype(np.float32)) for r in traj]
        lp = f"{path}.loop{s}.npz"
        if ms.loopers[s] is not None and os.path.exists(lp):
            load_loop_closer(lp, ms.loopers[s])
    ms._frames = len(ms.trajectories[0])
