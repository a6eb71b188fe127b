"""Distributed pose-graph Gauss-Newton: edge-sharded assembly over a mesh.

The reference's back-end is one sequential g2o solve
(``/root/reference/src/icpslam/icpslam.cpp:171``). Here the expensive part
— per-edge residual/Jacobian evaluation and block scatter-assembly — is
sharded across devices by *edge* (each device owns E/D edges), and the
partial normal equations are reduced with ``psum`` over the mesh inside
``shard_map``. Three linear solvers on top:

- ``direct``: replicated dense 6K×6K Cholesky (cheap for keyframe scale)
- ``pcg``: fully distributed matrix-free CG (edge-sharded matvecs + psum)
- ``schur``: distributed Schur complement — node chunks map to devices
  (chunk ↔ device), each device eliminates its chunk's interior nodes
  locally inside ``shard_map``, the small separator system is solved
  replicated (one ``all_gather`` of the per-chunk Schur contributions),
  and back-substitution runs locally (BASELINE.md config 5).

Numerically identical to the single-device solver — asserted by tests on
an 8-virtual-device CPU mesh.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from icpslam_tpu.geometry import se3
from icpslam_tpu.geometry.se3 import Pose
from icpslam_tpu.graph import pose_graph as pg

# Timing-ablation knob (parallel/scaling.py): True replaces every
# collective with a shape-preserving LOCAL op at trace time — same
# per-device FLOPs, zero communication — so a rung timed once normally
# and once ablated splits into {compute_ms, collective_ms}. Numerically
# wrong by construction; never enable outside the scaling harness.
ABLATE_COLLECTIVES = False


def _psum(x, axis):
    return x if ABLATE_COLLECTIVES else jax.lax.psum(x, axis)


def _check_vma() -> bool:
    # ablated outputs are NOT actually replicated — tell shard_map not to
    # statically require it (timing-only mode, results are discarded)
    return not ABLATE_COLLECTIVES


def _all_gather_tiled(x, axis, n_devices: int):
    if ABLATE_COLLECTIVES:
        return jnp.concatenate([x] * n_devices, axis=0)
    return jax.lax.all_gather(x, axis, tiled=True)


def _shardable_edges(edges: pg.EdgeSet, n_shards: int) -> pg.EdgeSet:
    """Pad edge arrays so the capacity divides the shard count (padding
    entries are invalid and contribute zero)."""
    E = edges.capacity
    Ep = (E + n_shards - 1) // n_shards * n_shards
    if Ep == E:
        return edges
    pad = Ep - E
    return pg.EdgeSet(
        i=jnp.pad(edges.i, (0, pad)),
        j=jnp.pad(edges.j, (0, pad)),
        rel_t=jnp.pad(edges.rel_t, ((0, pad), (0, 0))),
        rel_q=jnp.pad(edges.rel_q, ((0, pad), (0, 0)), constant_values=0).at[E:, 0].set(1.0),
        info=jnp.pad(edges.info, ((0, pad), (0, 0), (0, 0))),
        valid=jnp.pad(edges.valid, (0, pad)),
        count=edges.count,
        overflow=edges.overflow,
    )


def sharded_edge_contributions(
    nodes: Pose, edges: pg.EdgeSet, mesh: Mesh, axis: str = "dp"
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(K,6,K,6) H and (K,6) b assembled from device-sharded edges.

    Nodes are replicated; each device evaluates Jacobians for its edge
    shard and the partial H/b are psum-reduced across the mesh.
    """
    n = mesh.shape[axis]
    ep = _shardable_edges(edges, n)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(), P(),                      # nodes (replicated)
            P(axis), P(axis), P(axis), P(axis), P(axis), P(axis),  # edge arrays
        ),
        out_specs=(P(), P()),
        check_vma=_check_vma(),
    )
    def assemble(nt, nq, ei, ej, ert, erq, einfo, evalid):
        local = pg.EdgeSet(
            i=ei, j=ej, rel_t=ert, rel_q=erq, info=einfo, valid=evalid,
            count=jnp.sum(evalid.astype(jnp.int32)),
            overflow=jnp.asarray(0, jnp.int32),
        )
        H, b = pg.edge_contributions(Pose(t=nt, q=nq), local)
        return _psum(H, axis), _psum(b, axis)

    return assemble(
        nodes.t, nodes.q, ep.i, ep.j, ep.rel_t, ep.rel_q, ep.info, ep.valid
    )


def _sharded_pcg_step(
    nodes: Pose,
    edges: pg.EdgeSet,
    node_mask: jnp.ndarray,
    damping,
    mesh: Mesh,
    axis: str = "dp",
    anchor_weight: float = 1e6,
    cg_iterations: int = 50,
) -> Pose:
    """One GN/LM step solved by distributed matrix-free PCG.

    Edges are sharded; each device linearizes its shard once, then every
    CG matvec is a local edge sweep + one ``psum`` — memory and compute
    per device scale with E/D (no (6K)² factorization anywhere). This is
    the large-graph path; the dense 'direct' solver wins below ~1k nodes.
    """
    n = mesh.shape[axis]
    ep = _shardable_edges(edges, n)
    K = nodes.t.shape[0]
    damping = jnp.asarray(damping, nodes.t.dtype)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(), P(),
            P(axis), P(axis), P(axis), P(axis), P(axis), P(axis),
            P(), P(),
        ),
        out_specs=P(),
        check_vma=_check_vma(),
    )
    def step(nt, nq, ei, ej, ert, erq, einfo, evalid, nmask, lam):
        local = pg.EdgeSet(
            i=ei, j=ej, rel_t=ert, rel_q=erq, info=einfo, valid=evalid,
            count=jnp.sum(evalid.astype(jnp.int32)),
            overflow=jnp.asarray(0, jnp.int32),
        )
        nds = Pose(t=nt, q=nq)
        r, Ji, Jj, info = pg._edge_linearization(nds, local)

        b = _psum(pg._edge_gradient(r, Ji, Jj, info, ei, ej, K), axis)
        b = b * nmask[:, None]
        D = _psum(pg._edge_diag_blocks(Ji, Jj, info, ei, ej, K), axis)
        D = pg._regularize_diag(D, nmask, anchor_weight)
        scale = jnp.einsum("kaa->k", D) / 6.0
        damping_diag = (lam * jnp.maximum(scale, 1e-6))[:, None]
        eye6 = jnp.eye(6, dtype=D.dtype)
        Dinv = jnp.linalg.inv(D + damping_diag[..., None] * eye6 + 1e-9 * eye6)

        def apply_fn(x):
            y = _psum(pg._apply_H_edges(Ji, Jj, info, ei, ej, x), axis)
            return pg._regularize_apply(y, x, nmask, anchor_weight, damping_diag)

        delta, _ = pg.pcg_solve(apply_fn, Dinv, -b, iterations=cg_iterations)
        delta = delta * nmask[:, None]
        return delta

    delta = step(
        nodes.t, nodes.q, ep.i, ep.j, ep.rel_t, ep.rel_q, ep.info, ep.valid,
        node_mask, damping,
    )
    from icpslam_tpu.geometry import se3

    return se3.normalize(se3.compose(nodes, se3.se3_exp(delta)))


def _sharded_schur_delta(
    Hd: jnp.ndarray,        # (K, 6, K, 6) regularized + damped, PD
    b: jnp.ndarray,         # (K, 6) rhs (already negated as needed)
    sep_mask: jnp.ndarray,  # (K,) bool from schur.separator_mask
    mesh: Mesh,
    axis: str = "dp",
    sep_capacity: int = 64,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Distributed Schur solve of ``Hd x = b``: chunk ↔ device.

    Each device eliminates the interior nodes of its own K/D-node chunk
    (one masked dense inversion, ``schur.chunk_eliminate``), the per-chunk
    Schur contributions are ``all_gather``ed once, every device solves the
    small (6S)² separator system replicated, and back-substitution is
    local. Exactness-preserving padding as in ``graph/schur.py``; returns
    ``(delta (K,6), ok)`` where ``ok`` is False iff the true separator
    count exceeds ``sep_capacity``.
    """
    from icpslam_tpu.graph import schur as schur_mod

    K = b.shape[0]
    D = mesh.shape[axis]
    if K % D:
        raise ValueError(f"node capacity {K} must divide the mesh axis {D}")
    chunk = K // D
    n = 6 * chunk
    # a separator can never exceed the node count — clamp so small
    # (bucketed) systems don't build an S > K reduced system
    S = min(sep_capacity, K)

    n_sep = jnp.sum(sep_mask.astype(jnp.int32))
    ok = n_sep <= S
    order = jnp.argsort(~sep_mask, stable=True)
    sep_idx = order[:S]
    rank = jnp.zeros((K,), jnp.int32).at[order].set(jnp.arange(K, dtype=jnp.int32))
    elim = rank >= S

    H6 = Hd.reshape(D, chunk, 6, D, chunk, 6)
    dd = jnp.arange(D)
    A = H6[dd, :, :, dd, :, :].reshape(D, n, n)
    b_c = b.reshape(D, n)
    elim_c = jnp.repeat(elim.reshape(D, chunk), 6, axis=1)

    # replicated small pieces: separator cross-couplings + bookkeeping
    cross = H6.at[dd, :, :, dd, :, :].set(0.0).reshape(K, 6, K, 6)
    R_cross = cross[sep_idx][:, :, sep_idx, :]          # (S, 6, S, 6)
    sep_chunk = (sep_idx // chunk).astype(jnp.int32)
    sep_within = (sep_idx % chunk).astype(jnp.int32)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(), P(), P(), P()),
        out_specs=P(axis),
        check_vma=_check_vma(),
    )
    def solve(A_l, b_l, e_l, R_cross, sep_chunk, sep_within, sep_idx):
        # local interior elimination: (Dl, n, n) chunks on this device
        Sc, bs, Minv, A_es = jax.vmap(schur_mod.chunk_eliminate)(A_l, b_l, e_l)
        # one gather of the (small) per-chunk Schur contributions
        Sc_all = _all_gather_tiled(Sc, axis, D)              # (D, n, n)
        bs_all = _all_gather_tiled(bs, axis, D)              # (D, n)

        # replicated separator system: blockdiag(Sc) restricted to the
        # keep-set + cross couplings
        Sc6 = Sc_all.reshape(D, chunk, 6, chunk, 6)
        c1 = sep_chunk[:, None]
        w1 = sep_within[:, None]
        w2 = sep_within[None, :]
        bd = Sc6[c1, w1, :, w2, :]                    # (S, S, 6, 6)
        same = sep_chunk[:, None] == sep_chunk[None, :]
        bd = jnp.where(same[:, :, None, None], bd, 0.0)
        R = jnp.swapaxes(bd, 1, 2) + R_cross          # (S, 6, S, 6)
        R = R.reshape(S * 6, S * 6)
        b_red = bs_all.reshape(K, 6)[sep_idx].reshape(S * 6)
        chol = jax.scipy.linalg.cho_factor(R + 1e-9 * jnp.eye(S * 6, dtype=R.dtype))
        x_s = jax.scipy.linalg.cho_solve(chol, b_red).reshape(S, 6)

        # local back-substitution on this device's chunks
        delta_full = jnp.zeros((K, 6), b_red.dtype).at[sep_idx].set(x_s)
        Dl = A_l.shape[0]
        d0 = jax.lax.axis_index(axis) * Dl
        delta_c = jax.lax.dynamic_slice_in_dim(
            delta_full.reshape(D, n), d0, Dl, axis=0
        )
        x_e = jax.vmap(schur_mod.back_substitute)(Minv, A_es, b_l, e_l, delta_c)
        return jnp.where(e_l, x_e, delta_c)

    delta = solve(A, b_c, elim_c, R_cross, sep_chunk, sep_within, sep_idx)
    return delta.reshape(K, 6), ok


def _sharded_schur_step(
    nodes: Pose,
    edges: pg.EdgeSet,
    node_mask: jnp.ndarray,
    damping,
    mesh: Mesh,
    axis: str = "dp",
    sep_capacity: int = 64,
) -> Pose:
    """One GN/LM step: edge-sharded assembly + distributed Schur solve,
    falling back to the replicated direct factorization when the
    separator capacity overflows (``SchurResult.ok`` honored)."""
    from icpslam_tpu.graph import schur as schur_mod

    K = nodes.t.shape[0]
    H, b = sharded_edge_contributions(nodes, edges, mesh, axis)
    H, b = pg.regularize_normal_equations(H, b, node_mask)
    # same adaptive diagonal damping as the direct path
    eye6 = jnp.eye(6, dtype=nodes.t.dtype)
    diag_idx = jnp.arange(K)
    diag_blocks = H[diag_idx, :, diag_idx, :]
    scale = jnp.einsum("kii->k", diag_blocks) / 6.0
    Hd = H.at[diag_idx, :, diag_idx, :].add(
        (jnp.asarray(damping, nodes.t.dtype) * jnp.maximum(scale, 1e-6))[:, None, None]
        * eye6
    )
    D = mesh.shape[axis]
    sm = schur_mod.separator_mask(edges.i, edges.j, edges.valid, K, K // D)
    delta_s, ok = _sharded_schur_delta(
        Hd, -b, sm, mesh, axis, sep_capacity=sep_capacity
    )

    def direct_delta(_):
        Hm = Hd.reshape(K * 6, K * 6)
        chol = jax.scipy.linalg.cho_factor(Hm, lower=True)
        return jax.scipy.linalg.cho_solve(chol, -b.reshape(K * 6)).reshape(K, 6)

    delta = jax.lax.cond(ok, lambda _: delta_s, direct_delta, operand=None)
    delta = delta * node_mask[:, None]
    return se3.normalize(se3.compose(nodes, se3.se3_exp(delta)))


def optimize(
    nodes: Pose,
    edges: pg.EdgeSet,
    node_mask: jnp.ndarray,
    mesh: Mesh,
    iterations: int = 10,
    mode: str = "lm",
    init_damping: float = 1e-4,
    axis: str = "dp",
    linear_solver: str = "direct",
    cg_iterations: int = 50,
    sep_capacity: int = 64,
) -> Tuple[Pose, pg.SolveStats]:
    """Distributed drop-in for ``pose_graph.optimize``.

    ``linear_solver='direct'``: edge-sharded assembly + replicated dense
    Cholesky. ``'pcg'``: fully distributed matrix-free CG (no dense H).
    ``'schur'``: edge-sharded assembly + distributed Schur elimination
    (chunk ↔ device) with replicated separator solve. ``'auto'`` matches
    ``pose_graph.optimize``: direct up to K=256, PCG above.
    """
    linear_solver = pg.resolve_linear_solver(linear_solver, nodes.t.shape[0])
    c0 = pg.graph_cost(nodes, edges)
    pcg = linear_solver == "pcg"
    use_schur = linear_solver == "schur"

    def one_step(nds, lam):
        if pcg:
            return _sharded_pcg_step(
                nds, edges, node_mask, lam, mesh, axis=axis,
                cg_iterations=cg_iterations,
            )
        if use_schur:
            return _sharded_schur_step(
                nds, edges, node_mask, lam, mesh, axis=axis,
                sep_capacity=sep_capacity,
            )
        H, b = sharded_edge_contributions(nds, edges, mesh, axis)
        H, b = pg.regularize_normal_equations(H, b, node_mask)
        new, _ = pg._solve_and_update(nds, H, b, lam, node_mask)
        return new

    if mode == "gn":
        def body(it, nds):
            return one_step(nds, 0.0)

        final = jax.lax.fori_loop(0, iterations, body, nodes)
        return final, pg.SolveStats(c0, pg.graph_cost(final, edges), jnp.asarray(iterations))

    def body(it, carry):
        nds, lam, cost = carry
        cand = one_step(nds, lam)
        c_new = pg.graph_cost(cand, edges)
        accept = c_new < cost
        nds = jax.tree_util.tree_map(lambda a, b_: jnp.where(accept, a, b_), cand, nds)
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-9), jnp.minimum(lam * 4.0, 1e6))
        cost = jnp.where(accept, c_new, cost)
        return nds, lam, cost

    final, _, c_end = jax.lax.fori_loop(
        0, iterations, body, (nodes, jnp.asarray(init_damping, nodes.t.dtype), c0)
    )
    return final, pg.SolveStats(c0, c_end, jnp.asarray(iterations))
