"""Pose-graph optimization on SE(3) — batched Levenberg-Marquardt.

Array-native replacement for the reference's g2o pose graph
(loopClosureOnCovGraphG2ONew, /root/reference/src/backend/
vo_loopclosing.cpp:742-944): VertexSE3 nodes for every keyframe, sequential
EdgeSE3 constraints to the next 5 successors with a Cauchy robust kernel,
loop-closure edges, optimize(100).

Design: fixed-capacity node/edge arrays with validity masks.  Edge residual
r = log(T_meas⁻¹ · T_i⁻¹ · T_j) ∈ ℝ⁶ with exact Jacobians from forward-mode
autodiff, vmapped over all edges at once; the normal system is scatter-added
into a dense (6K, 6K) matrix (K ≤ a few hundred keyframes participate in any
reference PGO — the window is [first loop id, last loop id]) and solved with
one Cholesky.  Cauchy weights match the reference's kernel choice.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from ..geometry import se3 as se3m, so3
from ..geometry.se3 import SE3


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PoseGraph:
    """Nodes are world-from-camera poses T_w_c (VertexSE3 convention)."""

    node_q: jax.Array      # (K, 4)
    node_t: jax.Array      # (K, 3)
    node_valid: jax.Array  # (K,) bool
    edge_i: jax.Array      # (E,) i32 source node
    edge_j: jax.Array      # (E,) i32 target node
    edge_q: jax.Array      # (E, 4) measured T_i_j = T_wi⁻¹ T_wj
    edge_t: jax.Array      # (E, 3)
    edge_valid: jax.Array  # (E,) bool
    edge_weight: jax.Array  # (E,) information scale (loop edges can be upweighted)

    @property
    def num_nodes(self):
        return self.node_q.shape[0]


def empty(max_nodes: int, max_edges: int, dtype=jnp.float32) -> PoseGraph:
    return PoseGraph(
        node_q=jnp.tile(jnp.asarray([1.0, 0, 0, 0], dtype), (max_nodes, 1)),
        node_t=jnp.zeros((max_nodes, 3), dtype),
        node_valid=jnp.zeros(max_nodes, bool),
        edge_i=jnp.zeros(max_edges, jnp.int32),
        edge_j=jnp.zeros(max_edges, jnp.int32),
        edge_q=jnp.tile(jnp.asarray([1.0, 0, 0, 0], dtype), (max_edges, 1)),
        edge_t=jnp.zeros((max_edges, 3), dtype),
        edge_valid=jnp.zeros(max_edges, bool),
        edge_weight=jnp.ones(max_edges, dtype),
    )


def _edge_residual(xi_i, xi_j, Ti: SE3, Tj: SE3, Tij: SE3):
    """r = log(Tij⁻¹ · (Ti·exp(ξi))⁻¹ · (Tj·exp(ξj)))."""
    Ti_p = se3m.compose(Ti, se3m.exp(xi_i))
    Tj_p = se3m.compose(Tj, se3m.exp(xi_j))
    rel = se3m.compose(se3m.inverse(Ti_p), Tj_p)
    return se3m.log(se3m.compose(se3m.inverse(Tij), rel))


def _edge_res_jac(Ti: SE3, Tj: SE3, Tij: SE3):
    z = jnp.zeros(6, Ti.t.dtype)
    r = _edge_residual(z, z, Ti, Tj, Tij)
    Ji = jax.jacfwd(_edge_residual, argnums=0)(z, z, Ti, Tj, Tij)
    Jj = jax.jacfwd(_edge_residual, argnums=1)(z, z, Ti, Tj, Tij)
    return r, Ji, Jj


def _cauchy_weight(r2, c: float):
    return 1.0 / (1.0 + r2 / (c * c))


@functools.partial(jax.jit, static_argnames=("iters",))
def optimize(graph: PoseGraph, fixed_mask, iters: int = 20, cauchy_c: float = 1.0,
             lam0: float = 1e-4):
    """Run LM on the pose graph.  fixed_mask: (K,) bool nodes held constant
    (the reference fixes the first loop keyframe).  Returns updated graph."""
    K = graph.num_nodes
    Ti_all = SE3(graph.node_q, graph.node_t)

    def total_cost(nodes: SE3):
        Ti = se3m.index(nodes, graph.edge_i)
        Tj = se3m.index(nodes, graph.edge_j)
        Tij = SE3(graph.edge_q, graph.edge_t)
        z = jnp.zeros((graph.edge_i.shape[0], 6), nodes.t.dtype)
        r = jax.vmap(_edge_residual)(z, z, Ti, Tj, Tij)
        r2 = jnp.sum(r * r, axis=-1)
        rho = (cauchy_c ** 2) * jnp.log1p(r2 / cauchy_c ** 2)
        return jnp.sum(jnp.where(graph.edge_valid, rho * graph.edge_weight, 0.0))

    fix = jnp.repeat(fixed_mask | ~graph.node_valid, 6)

    def linearize(nodes: SE3):
        Ti = se3m.index(nodes, graph.edge_i)
        Tj = se3m.index(nodes, graph.edge_j)
        Tij = SE3(graph.edge_q, graph.edge_t)
        r, Ji, Jj = jax.vmap(_edge_res_jac)(Ti, Tj, Tij)      # (E,6), (E,6,6)×2
        r2 = jnp.sum(r * r, axis=-1)
        w = _cauchy_weight(r2, cauchy_c) * graph.edge_weight
        w = jnp.where(graph.edge_valid, w, 0.0)

        # Assemble dense H (6K, 6K) and b (6K) by scatter-add of edge blocks.
        H = jnp.zeros((K, K, 6, 6))
        b = jnp.zeros((K, 6))
        JiW = Ji * w[:, None, None]
        JjW = Jj * w[:, None, None]
        ii = graph.edge_i
        jj = graph.edge_j
        H = H.at[ii, ii].add(jnp.einsum("eki,ekj->eij", JiW, Ji, precision="highest"))
        H = H.at[jj, jj].add(jnp.einsum("eki,ekj->eij", JjW, Jj, precision="highest"))
        H = H.at[ii, jj].add(jnp.einsum("eki,ekj->eij", JiW, Jj, precision="highest"))
        H = H.at[jj, ii].add(jnp.einsum("eki,ekj->eij", JjW, Ji, precision="highest"))
        b = b.at[ii].add(-jnp.einsum("eki,ek->ei", JiW, r, precision="highest"))
        b = b.at[jj].add(-jnp.einsum("eki,ek->ei", JjW, r, precision="highest"))

        Hd = H.transpose(0, 2, 1, 3).reshape(6 * K, 6 * K)
        Hd = jnp.where(fix[:, None] | fix[None, :], 0.0, Hd)
        diag = jnp.diag(Hd)
        bv = jnp.where(fix, 0.0, b.reshape(-1))
        return Hd, diag, bv

    def solve(nodes: SE3, lin, lam):
        Hd, diag, bv = lin
        Hd = Hd + jnp.diag(jnp.where(fix, 1.0, lam * jnp.maximum(diag, 1e-6) + 1e-9))
        dx = jnp.linalg.solve(Hd, bv).reshape(K, 6)
        return se3m.compose(nodes, se3m.exp(dx)), jnp.max(jnp.abs(dx))

    nodes, cost = _lm_outer_loop(linearize, solve, total_cost, Ti_all, lam0, iters)
    return dataclasses.replace(graph, node_q=nodes.q, node_t=nodes.t), cost


def _lm_outer_loop(linearize, solve, total_cost, nodes0: SE3, lam0: float,
                   iters: int):
    """Shared LM accept/reject loop with early exit: stop once an ACCEPTED
    step improves the cost by < 1e-4 relative, OR after 2 consecutive
    REJECTED steps — a converged LM mostly rejects (no step can improve),
    so an accept-only criterion never fires and the loop burns the full
    iteration cap re-solving a finished problem (the 2048-node bench graph
    converges by iteration ~4 of 15).
    This is the "chi² stopped moving" behaviour of g2o's optimize(N).

    The rejection exit only fires after at least one ACCEPTED step (or once
    lam has reached its 1e4 cap): a cold start whose lam0 is too small for a
    hard graph can overshoot and reject its first steps — without the gate
    that returned the INITIAL drifted poses as "converged" after 2
    iterations instead of escalating lambda.

    A WARM start (the steady per-event case: node init = previous solution,
    one fresh loop edge) also exits on STEP SIZE: the relative-improvement
    test never fires when the base cost is already near its floor (every
    small absolute gain is "large relative"), which burned the full
    iteration cap per event — g2o's analogous terminate criterion is the
    step-norm test.  5e-3 in the se3 tangent (5 mm / 0.3°) is far below
    the cm-to-m scale the PGO corrects; likewise the relative-improvement
    exit sits at 1e-4 — a 2000-node ring with a handful of loop anchors has
    near-free low-frequency modes along which LM slides at ~1e-4 absolute
    cost per iteration forever (measured: cost and node error identical at
    cap 4 and cap 15, yet no sub-1e-6 exit ever fired).

    The step is split into `linearize(nodes)` (jacobians + normal-equation
    assembly — the expensive ~60% of an iteration) and `solve(nodes, lin,
    lam)` (damp + factor + back-substitute): a REJECTED step leaves H and b
    unchanged, so only the damped solve reruns with the larger lambda —
    g2o's LM does exactly this (re-push lambda, re-solve the stored
    system).  The carried linearization refreshes under lax.cond only when
    a step is accepted."""

    def body(carry):
        it, nodes, lin, lam, cost, rej, acc_any, _ = carry
        new_nodes, dx_inf = solve(nodes, lin, lam)
        new_cost = total_cost(new_nodes)
        better = new_cost < cost
        nodes = jax.tree.map(
            lambda a, b_: jnp.where(better, b_, a), nodes, new_nodes)
        lam = jnp.where(better, jnp.maximum(lam * 0.3, 1e-8),
                        jnp.minimum(lam * 6.0, 1e4))
        rej = jnp.where(better, 0, rej + 1)
        acc_any = acc_any | better
        done = (better & (cost - new_cost < 1e-4 * cost)) | (
            (rej >= 2) & (acc_any | (lam >= 1e4))) | (
            better & (dx_inf < 5e-3))
        # Refresh the linearization only for accepted steps the loop will
        # actually continue from: the final accepted step's jacobians+
        # assembly (~60% of an iteration) would be computed and immediately
        # discarded by the exit.
        lin = jax.lax.cond(better & ~done & (it + 1 < iters),
                           linearize, lambda _n: lin, nodes)
        cost = jnp.where(better, new_cost, cost)
        return it + 1, nodes, lin, lam, cost, rej, acc_any, done

    def cond(carry):
        it, _, _, _, _, _, _, done = carry
        return (it < iters) & ~done

    _, nodes, _, _, cost, _, _, _ = jax.lax.while_loop(
        cond, body,
        (jnp.asarray(0, jnp.int32), nodes0, linearize(nodes0),
         jnp.asarray(lam0), total_cost(nodes0), jnp.asarray(0, jnp.int32),
         jnp.asarray(False), jnp.asarray(False)))
    return nodes, cost


# ---------------------------------------------------------------------------
# Scalable solver: block-tridiagonal (super-node) Cholesky + Woodbury.
#
# The dense path above allocates a (K, K, 6, 6) H — 604 MB at K=2048 — and
# solves O((6K)³).  But the reference's PGO graph is nearly banded: the
# sequential edges span ≤5 keyframes (vo_loopclosing.cpp:834-859) and only
# the few loop-closure edges couple distant nodes.  Grouping `super` (=16)
# consecutive poses into one 96-dof super-node makes the banded part exactly
# BLOCK-TRIDIAGONAL (any edge with span ≤ super couples adjacent super-nodes
# only), which a lax.scan Thomas elimination factors in O(K) with fixed
# shapes — a sequential but compiled pattern.  Loop edges
# enter as a rank-6L Woodbury correction:
#     H = B + U Uᵀ,   H⁻¹b = B⁻¹b − B⁻¹U (I + UᵀB⁻¹U)⁻¹ UᵀB⁻¹b
# so one multi-RHS Thomas solve against [b, U] plus a small (6L, 6L) dense
# solve replaces the dense factorization.  Memory is O(K·super·36 + K·6·6L).
# ---------------------------------------------------------------------------

# Poses per super-node; must be ≥ the max sequential-edge span (5).  The
# Thomas scan is a SEQUENTIAL chain of small LU solves, so 16 halves the
# step count of 8 (256 → 128 at 2048 nodes) for 2× bigger (96, 96) blocks,
# which are still small.
_SUPER = 16


def _thomas_solve(D, U, X):
    """Solve the symmetric block-tridiagonal system  B · x = X  where
    B[g,g] = D[g], B[g,g+1] = U[g], B[g+1,g] = U[g]ᵀ.

    D: (G, S, S), U: (G, S, S) (row G-1 ignored), X: (G, S, N).
    Returns (G, S, N).  Forward elimination and back-substitution are two
    lax.scan passes; each step is one LU solve shared across all N RHS.
    """
    S = D.shape[1]

    def fwd(carry, inp):
        Dt_g, X_g = carry
        D_next, U_g, X_next = inp
        sol = jnp.linalg.solve(Dt_g, jnp.concatenate([U_g, X_g], axis=1))
        C_g, Y_g = sol[:, :S], sol[:, S:]
        Dt_next = D_next - jnp.matmul(U_g.T, C_g, precision="highest")
        Xn = X_next - jnp.matmul(U_g.T, Y_g, precision="highest")
        return (Dt_next, Xn), (C_g, Y_g)

    (Dt_last, X_last), (C, Y) = jax.lax.scan(
        fwd, (D[0], X[0]), (D[1:], U[:-1], X[1:]))
    Y_last = jnp.linalg.solve(Dt_last, X_last)

    def bwd(sol_next, inp):
        C_g, Y_g = inp
        sol_g = Y_g - jnp.matmul(C_g, sol_next, precision="highest")
        return sol_g, sol_g

    _, sols = jax.lax.scan(bwd, Y_last, (C, Y), reverse=True)
    return jnp.concatenate([sols, Y_last[None]], axis=0)


@functools.partial(jax.jit, static_argnames=("band_edges", "iters"))
def optimize_banded(graph: PoseGraph, fixed_mask, band_edges: int,
                    iters: int = 20, cauchy_c: float = 1.0, lam0: float = 1e-4):
    """LM on the pose graph with the block-tridiagonal + Woodbury solver.

    Same semantics as `optimize`, scalable to thousands of nodes.  Edges
    [0:band_edges] are "band" edges and must satisfy edge_i ≤ edge_j ≤
    edge_i + _SUPER (the sequential 5-successor edges do); edges
    [band_edges:] are loop edges, may connect any pair, and are handled by
    the low-rank Woodbury correction (keep that bucket small — memory and
    the dense correction solve scale with it).
    Requires num_nodes % _SUPER == 0 (callers pad to power-of-2 buckets).
    """
    K = graph.num_nodes
    s = _SUPER
    assert K % s == 0, "pad node count to a multiple of _SUPER"
    G, S = K // s, 6 * s
    E = graph.edge_i.shape[0]
    Eb = band_edges
    Lp = E - Eb                   # loop-edge bucket (Woodbury columns)
    Ti_all = SE3(graph.node_q, graph.node_t)
    Tij = SE3(graph.edge_q, graph.edge_t)
    hp = dict(precision="highest")
    held = fixed_mask | ~graph.node_valid                       # (K,)

    def total_cost(nodes: SE3):
        Ti = se3m.index(nodes, graph.edge_i)
        Tj = se3m.index(nodes, graph.edge_j)
        z = jnp.zeros((E, 6), nodes.t.dtype)
        r = jax.vmap(_edge_residual)(z, z, Ti, Tj, Tij)
        r2 = jnp.sum(r * r, axis=-1)
        rho = (cauchy_c ** 2) * jnp.log1p(r2 / cauchy_c ** 2)
        return jnp.sum(jnp.where(graph.edge_valid, rho * graph.edge_weight, 0.0))

    r6 = jnp.arange(6)
    ei, ej = graph.edge_i, graph.edge_j
    gi, oi = ei[:Eb] // s, (ei[:Eb] % s) * 6
    gj, oj = ej[:Eb] // s, (ej[:Eb] % s) * 6
    same_g = gi == gj

    def linearize(nodes: SE3):
        Ti = se3m.index(nodes, ei)
        Tj = se3m.index(nodes, ej)
        r, Ji, Jj = jax.vmap(_edge_res_jac)(Ti, Tj, Tij)        # (E,6),(E,6,6)
        r2 = jnp.sum(r * r, axis=-1)
        w = _cauchy_weight(r2, cauchy_c) * graph.edge_weight
        w = jnp.where(graph.edge_valid, w, 0.0)                 # (E,)
        JiW, JjW = Ji * w[:, None, None], Jj * w[:, None, None]

        # Full gradient (all edges, incl. loop edges).
        b = jnp.zeros((K, 6))
        b = b.at[ei].add(-jnp.einsum("eki,ek->ei", JiW, r, **hp))
        b = b.at[ej].add(-jnp.einsum("eki,ek->ei", JjW, r, **hp))

        # --- banded part: scatter 6x6 blocks into block-tridiagonal (D, U).
        Hii = jnp.einsum("eki,ekj->eij", JiW[:Eb], Ji[:Eb], **hp)
        Hjj = jnp.einsum("eki,ekj->eij", JjW[:Eb], Jj[:Eb], **hp)
        Hij = jnp.einsum("eki,ekj->eij", JiW[:Eb], Jj[:Eb], **hp)
        D = jnp.zeros((G, S, S))
        U = jnp.zeros((G, S, S))
        rows_i = oi[:, None, None] + r6[None, :, None]
        cols_i = oi[:, None, None] + r6[None, None, :]
        rows_j = oj[:, None, None] + r6[None, :, None]
        cols_j = oj[:, None, None] + r6[None, None, :]
        gib = gi[:, None, None]
        gjb = gj[:, None, None]
        D = D.at[gib, rows_i, cols_i].add(Hii)
        D = D.at[gjb, rows_j, cols_j].add(Hjj)
        w_same = same_g.astype(Hij.dtype)[:, None, None]
        D = D.at[gib, rows_i, cols_j].add(w_same * Hij)
        D = D.at[gib, rows_j, cols_i].add(
            w_same * jnp.swapaxes(Hij, -1, -2))
        # Inter-super coupling (g_j == g_i + 1 for band edges crossing).
        U = U.at[gib, rows_i, cols_j].add((1.0 - w_same) * Hij)

        # --- loop part: U_w columns (rank 6 per loop edge, Woodbury).
        sqw = jnp.sqrt(w[Eb:])                                  # (Lp,)
        Ui_col = jnp.swapaxes(Ji[Eb:], -1, -2) * sqw[:, None, None]
        Uj_col = jnp.swapaxes(Jj[Eb:], -1, -2) * sqw[:, None, None]
        Uw = jnp.zeros((K, 6, Lp, 6))
        eidx = jnp.arange(Lp)
        Uw = Uw.at[ei[Eb:], :, eidx, :].add(Ui_col)
        Uw = Uw.at[ej[Eb:], :, eidx, :].add(Uj_col)

        # --- damping BASE from the FULL H diagonal (band + loop); the
        # lam-scaled term is applied in solve() so a rejected step only
        # re-damps and re-factors, never re-assembles.
        d_band = jnp.diagonal(D, axis1=1, axis2=2).reshape(K, 6)
        d_loop = jnp.sum(Uw * Uw, axis=(2, 3))
        damp_base = jnp.maximum(d_band + d_loop, 1e-6)
        damp_base = jnp.where(held[:, None], 0.0, damp_base)    # (K, 6)

        # --- gauge fixing: identity rows/cols for held nodes (lam-free).
        fix = jnp.repeat(held, 6).reshape(G, S)                 # (G, S)
        keep = 1.0 - fix.astype(D.dtype)
        D = D * keep[:, :, None] * keep[:, None, :]
        D = D + jax.vmap(jnp.diag)(fix.astype(D.dtype))
        U = U * keep[:, :, None]
        U = U * jnp.concatenate([keep[1:], jnp.ones((1, S))])[:, None, :]
        bv = b * (1.0 - held.astype(b.dtype))[:, None]          # (K, 6)
        Uw = Uw * (1.0 - held.astype(Uw.dtype))[:, None, None, None]
        return D, U, Uw, bv, damp_base

    def solve(nodes: SE3, lin, lam):
        D, U, Uw, bv, damp_base = lin
        damp = lam * damp_base + jnp.where(damp_base > 0.0, 1e-9, 0.0)
        dd = damp.reshape(G, s, 6).reshape(G, S)
        D = D + jax.vmap(jnp.diag)(dd)

        # --- solve: one multi-RHS Thomas pass against [b, U_w], Woodbury.
        N = 1 + Lp * 6
        X = jnp.concatenate(
            [bv.reshape(K, 6, 1), Uw.reshape(K, 6, Lp * 6)], axis=-1)
        Z = _thomas_solve(D, U, X.reshape(G, S, N)).reshape(K * 6, N)
        z_b, Z_u = Z[:, 0], Z[:, 1:]
        Uf = Uw.reshape(K * 6, Lp * 6)
        M = jnp.eye(Lp * 6) + jnp.matmul(Uf.T, Z_u, precision="highest")
        y = jnp.linalg.solve(M, jnp.matmul(Uf.T, z_b, precision="highest"))
        dx = (z_b - jnp.matmul(Z_u, y, precision="highest")).reshape(K, 6)
        dx = jnp.where(held[:, None], 0.0, dx)
        return se3m.compose(nodes, se3m.exp(dx)), jnp.max(jnp.abs(dx))

    nodes, cost = _lm_outer_loop(linearize, solve, total_cost, Ti_all, lam0,
                                 iters)
    return dataclasses.replace(graph, node_q=nodes.q, node_t=nodes.t), cost
