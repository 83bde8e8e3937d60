"""Sharded place-recognition: keyframe BoW database over a device mesh.

The reference's loop node keeps every keyframe's BoW vector in a host
vector and scores a new keyframe against ALL of them in an O(N) loop on one
CPU thread (/root/reference/src/backend/vo_loopclosing.cpp:421-436) — the
cost that grows with trajectory length (SURVEY.md §5 "long-context").

Design: the (K, V) BoW database is row-sharded over a `kf` mesh
axis ("context parallelism over the map"); scoring one query is an
embarrassingly-parallel per-shard matvec with NO collective — each device
scores its own keyframe rows, and only the (K,) score vector (sharded) comes
back.  The top-candidate reduction runs as a per-shard argmax + one small
all_gather of (value, index) pairs, so the interconnect carries O(devices)
floats per query regardless of map size.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_kf_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()[: n_devices or len(jax.devices())]
    return jax.make_mesh((len(devs),), ("kf",), devices=devs,
                         axis_types=(jax.sharding.AxisType.Auto,))


def shard_db(mesh: Mesh, db, valid):
    """Place a (K, V) BoW database and its (K,) validity row-sharded on `kf`."""
    return (jax.device_put(db, NamedSharding(mesh, P("kf", None))),
            jax.device_put(valid, NamedSharding(mesh, P("kf"))))


@functools.partial(jax.jit, static_argnames=("mesh",), donate_argnums=1)
def set_row(mesh: Mesh, db, k, row):
    """Insert one keyframe's BoW vector; donation keeps the sharded buffer
    in place (no (K, V) copy across HBM)."""
    out = db.at[k].set(row)
    return jax.lax.with_sharding_constraint(
        out, NamedSharding(mesh, P("kf", None)))


@functools.partial(jax.jit, static_argnames=("mesh",))
def score_database_sharded(mesh: Mesh, query, db, db_valid):
    """L1 BoW similarity of one query against all sharded rows → (K,).

    Per-shard work only; the result stays sharded on `kf` until the host
    reads it."""
    def shard_fn(db_s, valid_s):
        s = 1.0 - 0.5 * jnp.sum(jnp.abs(db_s - query[None, :]), axis=1)
        return jnp.where(valid_s, s, 0.0)

    return jax.shard_map(shard_fn, mesh=mesh,
                         in_specs=(P("kf", None), P("kf")),
                         out_specs=P("kf"))(db, db_valid)


@functools.partial(jax.jit, static_argnames=("mesh",))
def best_candidate_sharded(mesh: Mesh, query, db, db_valid, cand_mask):
    """Top-scoring candidate under an eligibility mask (the temporal gates
    lcKFDist/lcKFMaxDist): per-shard argmax, then a final reduce over the
    tiny (n_devices,) partials — no collective inside the shard body.

    Returns (best_score, best_index) as scalars."""
    k_total = db.shape[0]

    def shard_fn(db_s, valid_s, cand_s):
        s = 1.0 - 0.5 * jnp.sum(jnp.abs(db_s - query[None, :]), axis=1)
        s = jnp.where(valid_s & cand_s, s, -jnp.inf)
        i_local = jnp.argmax(s)
        v_local = s[i_local]
        shard = jax.lax.axis_index("kf")
        k_shard = db_s.shape[0]
        idx_global = shard * k_shard + i_local
        return v_local[None], idx_global[None]

    vals, idxs = jax.shard_map(shard_fn, mesh=mesh,
                               in_specs=(P("kf", None), P("kf"), P("kf")),
                               out_specs=(P("kf"), P("kf")))(
        db, db_valid, cand_mask)
    j = jnp.argmax(vals)
    i = jnp.clip(idxs[j], 0, k_total - 1)
    return vals[j], i
