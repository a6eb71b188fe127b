"""Keyframe marginalization: missions outlive ``max_keyframes``.

The reference grows its keyframe vector without bound
(``/root/reference/src/icpslam/icpslam.cpp:88``, octree likewise at
``src/icpslam/octree_mapper.cpp:63-70``) — unbounded memory is its answer
to long missions. Under static shapes the keyframe store is a fixed
capacity, and before r5 it simply froze when full (no new nodes, no new
loop closures — measured ATE degradation 0.49→1.13 m on the 2000-scan
capacity-exhaustion endurance run). This module frees slots instead:

- ``select_victim``: pick the most *redundant* frozen keyframe — smallest
  sum of distances to its temporal neighbors, with a penalty per incident
  loop edge (loop anchors carry global information) and protection for
  node 0 (the gauge anchor) and the recent trail.
- ``marginalize_keyframe``: remove the victim ``v`` by composing it into
  its predecessor ``p = v-1``: every edge incident on ``v`` is re-homed to
  ``p`` through the measured sequential hop ``Z_pv``, with first-order
  SE(3) covariance composition (the hop's uncertainty is *added* to every
  re-homed edge — information is never invented). The hop edge itself
  becomes a self-edge and is dropped; the victim's other sequential edge
  ``(v → v+1)`` becomes the composed edge ``(p → v+1)`` — exactly the
  "compose its two sequential edges into one" marginalization-by-edge-
  composition scheme. Stores and edges are then compacted so index order
  stays temporal order (the invariant ``optimize_window`` and the
  loop-closure id gap rely on).

This is the sparsified (chain-topology-preserving) approximation of exact
Schur marginalization: exact elimination of node ``v`` would create a
dense clique over *all* its neighbors; composing through the predecessor
keeps the graph sparse at the cost of routing the loop-edge information
through one extra hop whose covariance is accounted for. Evictions are
counted (``KeyframeStore.evictions``) — no silent capacity behavior.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from icpslam_tpu.geometry import se3
from icpslam_tpu.geometry.se3 import Pose
from icpslam_tpu.graph import keyframes as kf
from icpslam_tpu.graph import pose_graph as pg


def compose_covariance(
    Za: Pose, Sa: jnp.ndarray, Zb: Pose, Sb: jnp.ndarray
) -> jnp.ndarray:
    """Right-perturbation covariance of ``Za ∘ Zb``.

    With ``Z = Ẑ·exp(ξ)`` convention: ``Σ' = Ad(Zb⁻¹) Σa Ad(Zb⁻¹)ᵀ + Σb``
    (the perturbation of the left factor is carried through the right
    factor's frame). Exact to first order; validated against Monte-Carlo
    sampling in ``tests/test_marginalize.py``.
    """
    Ad = se3.adjoint(se3.inverse(Zb))
    return Ad @ Sa @ jnp.swapaxes(Ad, -1, -2) + Sb


def inverse_covariance(Z: Pose, S: jnp.ndarray) -> jnp.ndarray:
    """Right-perturbation covariance of ``Z⁻¹``: ``Ad(Z) Σ Ad(Z)ᵀ``."""
    Ad = se3.adjoint(Z)
    return Ad @ S @ jnp.swapaxes(Ad, -1, -2)


def select_victim(
    store: kf.KeyframeStore,
    edges: pg.EdgeSet,
    protect_recent: int = 8,
    loop_edge_penalty: float = 10.0,
) -> jnp.ndarray:
    """Index of the most redundant evictable keyframe.

    Redundancy score = distance to the previous + next keyframe (graph
    poses) + ``loop_edge_penalty`` meters per incident loop edge (an
    anchor of global information is worth keeping over a corridor
    filler). Node 0 (gauge) and the last ``protect_recent`` live nodes
    are never picked. Call only on a full store with
    ``capacity > protect_recent + 1``.
    """
    K = store.capacity
    ids = jnp.arange(K, dtype=jnp.int32)
    t = store.pose_graph.t
    d_prev = jnp.linalg.norm(t - t[jnp.maximum(ids - 1, 0)], axis=-1)
    d_next = jnp.linalg.norm(t[jnp.minimum(ids + 1, K - 1)] - t, axis=-1)
    score = d_prev + d_next
    # loop edges carry non-local information — penalize evicting anchors
    is_loop = edges.valid & ((edges.j - edges.i) > 1)
    w = is_loop.astype(score.dtype)
    deg = (
        jnp.zeros((K,), score.dtype).at[edges.i].add(w).at[edges.j].add(w)
    )
    score = score + loop_edge_penalty * deg
    protected = (ids == 0) | (ids >= store.count - protect_recent)
    score = jnp.where(protected, jnp.inf, score)
    return jnp.maximum(jnp.argmin(score).astype(jnp.int32), 1)


def fuse_duplicate_edges(edges: pg.EdgeSet) -> pg.EdgeSet:
    """One pass of parallel-edge fusion: edges sharing the same (i, j)
    are combined information-weighted — ``Ω' = Ω₁+Ω₂`` and the measured
    relative blended in the tangent, ``Z' = Z₁ ∘ exp((Ω')⁻¹ Ω₂ ξ)`` with
    ``ξ = log(Z₁⁻¹ Z₂)`` — reclaiming the duplicate's slot.

    Re-homing during marginalization piles parallel edges onto the
    predecessor over long missions, which drains edge capacity (the r5
    endurance capacity run counted 23 drops at the 2048 cap); one fusion
    pass per eviction keeps the live set minimal. A run of k duplicates
    fuses pairwise (one pair per pass) — successive evictions finish the
    job. Output is compacted to a live prefix.
    """
    dt = edges.rel_t.dtype
    eye6 = jnp.eye(6, dtype=dt)
    big = jnp.iinfo(jnp.int32).max
    # (i, j) -> unique int32 key: the multiplier must DOMINATE any node
    # index (edge capacity does not bound node ids — max_keyframes can
    # exceed max_edges). 2^15 covers any plausible keyframe capacity
    # while i * 2^15 + j stays well inside int32.
    key = jnp.where(edges.valid, edges.i * 32768 + edges.j, big)
    order = jnp.argsort(key, stable=True)
    key_s = key[order]
    i_s, j_s = edges.i[order], edges.j[order]
    t_s, q_s = edges.rel_t[order], edges.rel_q[order]
    info_s, valid_s = edges.info[order], edges.valid[order]

    prev_same = jnp.concatenate([
        jnp.asarray([False]), (key_s[1:] == key_s[:-1]) & (key_s[1:] != big)
    ])
    # fuse only the second of each pair; a third-in-run waits a pass
    second = prev_same & ~jnp.concatenate([jnp.asarray([False]), prev_same[:-1]])
    first = jnp.concatenate([second[1:], jnp.asarray([False])])

    # pair data aligned at FIRST positions (partner = next row)
    nxt = lambda a: jnp.roll(a, -1, axis=0)
    rel1 = Pose(t=t_s, q=q_s)
    rel2 = Pose(t=nxt(t_s), q=nxt(q_s))
    info2 = nxt(info_s)
    info_sum = info_s + info2
    xi = se3.se3_log(se3.relative(rel1, rel2))  # (E, 6)
    rhs = jnp.einsum("eab,eb->ea", info2, xi)
    delta = jnp.linalg.solve(info_sum + 1e-6 * eye6[None], rhs[..., None])[..., 0]
    fused = se3.compose(rel1, se3.se3_exp(delta))
    fused = Pose(
        t=jnp.where(first[:, None], fused.t, t_s),
        q=jnp.where(first[:, None], se3.normalize(fused).q, q_s),
    )
    new_info = jnp.where(first[:, None, None], info_sum, info_s)
    valid_out = valid_s & ~second

    # compact to a live prefix
    order2 = jnp.argsort((~valid_out).astype(jnp.int32), stable=True)
    return pg.EdgeSet(
        i=i_s[order2],
        j=j_s[order2],
        rel_t=fused.t[order2],
        rel_q=fused.q[order2],
        info=new_info[order2],
        valid=valid_out[order2],
        count=jnp.sum(valid_out.astype(jnp.int32)),
        overflow=edges.overflow,
    )


def marginalize_keyframe(
    store: kf.KeyframeStore, edges: pg.EdgeSet, victim: jnp.ndarray
) -> Tuple[kf.KeyframeStore, pg.EdgeSet]:
    """Remove keyframe ``victim`` (≥ 1), re-homing its edges to its
    predecessor with covariance-correct composition, and compact both
    stores so the live prefix stays index-ordered.

    Pure and jit-safe (static shapes); O(E) edge work + one gather over
    the keyframe arrays.
    """
    v = jnp.asarray(victim, jnp.int32)
    p = v - 1
    E = edges.capacity
    K = store.capacity
    dt = store.pose_graph.t.dtype
    eye6 = jnp.eye(6, dtype=dt)

    # --- the hop measurement Z_pv (p → v): prefer the measured sequential
    # edge (strongest information when both ICP and wheel edges exist);
    # fall back to the graph-estimate relative with the victim's stored
    # registration covariance (zeros → a conservative 1e-2 I).
    tr_info = jnp.einsum("eii->e", edges.info)
    seq_match = edges.valid & (edges.i == p) & (edges.j == v)
    any_seq = jnp.any(seq_match)
    k = jnp.argmax(jnp.where(seq_match, tr_info, -jnp.inf))
    Z_est = se3.relative(
        se3.index(store.pose_graph, p), se3.index(store.pose_graph, v)
    )
    Z_pv = Pose(
        t=jnp.where(any_seq, edges.rel_t[k], Z_est.t),
        q=jnp.where(any_seq, edges.rel_q[k], Z_est.q),
    )
    Sig_meas = jnp.linalg.inv(edges.info[k] + 1e-6 * eye6)
    cov_v = store.cov[v]
    Sig_fall = jnp.where(jnp.trace(cov_v) > 0, cov_v, 1e-2 * eye6)
    Sig_pv = jnp.where(any_seq, Sig_meas, Sig_fall)

    # --- re-home every edge incident on v (vectorized over all E) -------
    rel = edges.rel()
    Sig_e = jnp.linalg.inv(edges.info + 1e-6 * eye6[None])  # (E, 6, 6)
    Zb = Pose(
        t=jnp.broadcast_to(Z_pv.t, (E, 3)), q=jnp.broadcast_to(Z_pv.q, (E, 4))
    )

    # case A — edge (v → x) becomes (p → x): Z' = Z_pv ∘ Z,
    # Σ' = Ad(Z⁻¹) Σ_pv Ad(Z⁻¹)ᵀ + Σ
    mA = edges.valid & (edges.i == v)
    ZA = se3.compose(Zb, rel)
    AdA = se3.adjoint(se3.inverse(rel))  # (E, 6, 6)
    SigA = (
        jnp.einsum("eab,bc,edc->ead", AdA, Sig_pv, AdA) + Sig_e
    )

    # case B — edge (x → v) becomes (x → p): Z' = Z ∘ Z_pv⁻¹,
    # Σ' = Ad(Z_pv) (Σ + Σ_pv) Ad(Z_pv)ᵀ   (simplified closed form)
    mB = edges.valid & (edges.j == v)
    ZB = se3.compose(rel, Pose(
        t=jnp.broadcast_to(se3.inverse(Z_pv).t, (E, 3)),
        q=jnp.broadcast_to(se3.inverse(Z_pv).q, (E, 4)),
    ))
    AdB = se3.adjoint(Z_pv)  # (6, 6)
    SigB = jnp.einsum(
        "ab,ebc,dc->ead", AdB, Sig_e + Sig_pv[None], AdB
    )

    mA_ = mA[:, None]
    new_t = jnp.where(mA_, ZA.t, jnp.where(mB[:, None], ZB.t, edges.rel_t))
    new_q = jnp.where(
        mA[:, None], ZA.q, jnp.where(mB[:, None], ZB.q, edges.rel_q)
    )
    touched = mA | mB
    new_sig = jnp.where(mA[:, None, None], SigA,
                        jnp.where(mB[:, None, None], SigB, Sig_e))
    new_info = jnp.where(
        touched[:, None, None],
        jnp.linalg.inv(new_sig + 1e-8 * eye6[None]),
        edges.info,
    )
    new_i = jnp.where(mA, p, edges.i)
    new_j = jnp.where(mB, p, edges.j)
    # the hop edge (p → v) — and any wheel twin — became a self-edge; drop
    valid = edges.valid & (new_i != new_j)
    # index remap: everything above the victim shifts down by one
    new_i = new_i - (new_i > v).astype(jnp.int32)
    new_j = new_j - (new_j > v).astype(jnp.int32)

    # --- fuse the parallel edges re-homing creates, then compact to a
    # live prefix (bucketed/dist solvers rely on "first count edges are
    # the whole live graph"); fusion also reclaims capacity so long
    # missions don't drain max_edges (counted, never silent) ------------
    new_edges = fuse_duplicate_edges(pg.EdgeSet(
        i=new_i,
        j=new_j,
        rel_t=new_t,
        rel_q=new_q,
        info=new_info,
        valid=valid,
        count=jnp.sum(valid.astype(jnp.int32)),
        overflow=edges.overflow,
    ))

    # --- compact the keyframe store (shift-down gather keeps index order
    # == temporal order) -------------------------------------------------
    ids = jnp.arange(K, dtype=jnp.int32)
    src = jnp.where(ids >= v, jnp.minimum(ids + 1, K - 1), ids)
    take = lambda a: jnp.take(a, src, axis=0)
    new_store = kf.KeyframeStore(
        pose_odom=Pose(t=take(store.pose_odom.t), q=take(store.pose_odom.q)),
        pose_graph=Pose(t=take(store.pose_graph.t), q=take(store.pose_graph.q)),
        stamp=take(store.stamp),
        points=take(store.points),
        point_mask=take(store.point_mask),
        cov=take(store.cov),
        count=store.count - 1,
        evictions=store.evictions + 1,
    )
    return new_store, new_edges
