"""Pipelined back-end: overlap the windowed graph solve with streaming.

The reference's main loop BLOCKS on g2o's ``optimize()``
(``/root/reference/src/icpslam/icpslam.cpp:171``) — the front-end stalls
for every solve. The pipeline-parallel formulation here (SURVEY
§2.3 "double-buffered device steps") exploits JAX async dispatch instead:

1. when the keyframe window fills, the solve is dispatched as its OWN
   device program over a snapshot of the graph (``launch``) — the call
   returns immediately, the device schedules it behind the in-flight
   ``slam_step``s;
2. the front-end keeps streaming scans (``config.defer_optimization``
   compiles the inline solve out of ``slam_step``);
3. when the solve result is ready (``jax.Array.is_ready``) — or a lag
   bound is hit — ``fold`` merges it into the live state: snapshot
   keyframes take their optimized poses, keyframes created *during* the
   solve are re-based onto the corrected map→odom (their graph pose is
   ``m2o ∘ pose_in_odom`` by construction, ``icpslam.cpp:76-77``), and
   the map is reset per the reference's contract (``:170``).

Semantics: the same graph is solved at the same window boundary; the
correction lands late by the solve latency instead of stalling the
stream. Use via ``DeferredBackend`` (the runner's
``--deferred-optimize``) or the jitted pieces directly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from icpslam_tpu.config import SlamConfig
from icpslam_tpu.geometry import se3
from icpslam_tpu.geometry.se3 import Pose
from icpslam_tpu.graph import keyframes as kf
from icpslam_tpu.graph import pose_graph as pg
from icpslam_tpu.mapping import backend as map_backend
from icpslam_tpu.pipeline import slam


class SnapshotSolve(NamedTuple):
    nodes: Pose            # (K,) optimized graph poses (snapshot prefix live)
    map_to_odom: Pose      # correction at the snapshot's last keyframe
    final_cost: jnp.ndarray
    snapshot_count: jnp.ndarray  # int32 keyframes included in the solve
    snapshot_lc: jnp.ndarray     # int32 lc_since_opt the solve consumed


def solve_snapshot(
    state: slam.SlamState, config: SlamConfig, mesh=None
) -> SnapshotSolve:
    """The windowed solve on a snapshot of the live graph.

    Pure + jittable (``static_argnums=(1,)``); dispatch it WITHOUT
    blocking on the result — that is the entire point. Honors the same
    back-end configuration as the inline solve: incremental window solves
    between loop closures (``config.graph_incremental``) and the
    distributed edge-sharded solvers when ``mesh`` is bound and
    ``graph_linear_solver`` is a ``dist-*`` variant.
    """
    store = state.keyframes

    if config.graph_incremental:
        def full(st):
            return slam._full_solve(st, config, mesh)

        def window(st):
            return pg.optimize_window(
                st.keyframes.pose_graph,
                st.edges,
                st.keyframes.valid_mask(),
                node_count=st.keyframes.count,
                window=config.graph_window,
                iterations=config.graph_solver_iterations,
                mode=config.graph_solver,
            )

        nodes, stats = jax.lax.cond(state.lc_since_opt > 0, full, window, state)
    else:
        nodes, stats = slam._full_solve(state, config, mesh)
    last = jnp.maximum(store.count - 1, 0)
    m2o = se3.normalize(
        se3.compose(
            Pose(t=nodes.t[last], q=nodes.q[last]),
            se3.inverse(se3.index(store.pose_odom, last)),
        )
    )
    return SnapshotSolve(
        nodes=nodes,
        map_to_odom=m2o,
        final_cost=stats.final_cost,
        snapshot_count=store.count,
        snapshot_lc=state.lc_since_opt,
    )


def fold(
    state: slam.SlamState, solve: SnapshotSolve, config: SlamConfig
) -> slam.SlamState:
    """Merge an asynchronous solve back into the live state.

    Keyframes ``i < snapshot_count`` take their optimized poses; newer
    ones (created while the solve ran) are re-based as
    ``new_m2o ∘ pose_in_odom`` — the same composition that created them
    (``icpslam.cpp:76-77``), now with the corrected map→odom. Also resets
    the map (``:170`` contract, unless disabled) and restarts the window
    from the keyframes the solve did NOT see.
    """
    store = state.keyframes
    K = store.capacity
    ids = jnp.arange(K, dtype=jnp.int32)
    live = ids < store.count
    in_snap = ids < solve.snapshot_count
    m2o = solve.map_to_odom
    rebased = se3.compose(m2o, store.pose_odom)  # (K,) batched compose
    new_graph = Pose(
        t=jnp.where(
            in_snap[:, None], solve.nodes.t,
            jnp.where(live[:, None], rebased.t, store.pose_graph.t),
        ),
        q=jnp.where(
            in_snap[:, None], solve.nodes.q,
            jnp.where(live[:, None], rebased.q, store.pose_graph.q),
        ),
    )
    new_map = (
        map_backend.reset(state.map) if config.reset_map_on_optimize else state.map
    )
    return state._replace(
        keyframes=store._replace(pose_graph=new_graph),
        map=new_map,
        map_to_odom=m2o,
        kf_since_opt=(state.keyframes.count - solve.snapshot_count).astype(jnp.int32),
        # loop edges that arrived AFTER the snapshot stay pending so the
        # next solve goes full-graph (exact: the counter is monotone
        # between resets)
        lc_since_opt=jnp.maximum(
            state.lc_since_opt - solve.snapshot_lc, 0
        ).astype(jnp.int32),
        num_optimizations=state.num_optimizations + 1,
    )


class DeferredBackend:
    """Host-side driver for the pipelined solve.

    Call ``maybe_launch_or_fold(state)`` after every ``slam_step``. The
    solve is dispatched when the window fills; the fold happens on the
    first later call whose solve result ``is_ready()`` (or after
    ``max_lag`` scans, where the fold blocks — the bounded-staleness
    guarantee). ``flush`` folds any pending solve at end of stream.
    """

    def __init__(
        self,
        config: SlamConfig,
        max_lag: int = 8,
        check_every: int = 1,
        mesh=None,
    ):
        if not config.defer_optimization:
            raise ValueError("config.defer_optimization must be True")
        if config.graph_linear_solver.startswith("dist-") and mesh is None:
            raise ValueError(
                f"graph_linear_solver='{config.graph_linear_solver}' "
                "requires mesh= (the deferred solve runs edge-sharded)"
            )
        self.config = config
        self.mesh = mesh
        self.max_lag = max_lag
        # launch-trigger cadence: how often to (re)arm the async probe of
        # kf_since_opt. The probe is polled with ``is_ready()`` and only
        # read once ready, so the host NEVER blocks on the trigger
        # (ADVICE r2: the old ``int(state.kf_since_opt)`` stalled the host
        # behind the just-dispatched slam_step once per check). The solve
        # launches a few scans after the window actually fills — which
        # the fold's re-basing absorbs like any other lag.
        self.check_every = max(1, check_every)
        # jit the MODULE-LEVEL function with mesh as a static arg — a
        # functools.partial here would be a fresh function object per
        # backend instance, defeating jit-cache sharing across instances
        # (measured: a 25 s recompile inside the timed stream when the
        # bench builds one backend for warmup and another for the run)
        self._solve = jax.jit(solve_snapshot, static_argnums=(1, 2))
        self._fold = jax.jit(fold, static_argnums=(2,))
        self._pending: Optional[SnapshotSolve] = None
        self._probe = None  # in-flight async copy of state.kf_since_opt
        self._probe_age = 0
        self._age = 0
        self._since_check = 0
        self.num_launched = 0
        self.num_folded = 0

    def maybe_launch_or_fold(self, state: slam.SlamState) -> slam.SlamState:
        if self._pending is not None:
            self._age += 1
            if self._age >= self.max_lag or self._pending.final_cost.is_ready():
                state = self._fold(state, self._pending, self.config)
                self._pending = None
                self._probe = None
                self.num_folded += 1
            return state
        if self._probe is not None:
            self._probe_age += 1
            # block on the probe only once it is max_lag polls stale —
            # the host must not outrun the device forever or launches
            # would be skipped entirely (the trigger would never observe
            # a filled window). Worst case: one sync per max_lag scans,
            # vs one per check before (ADVICE r2).
            if self._probe.is_ready() or self._probe_age >= self.max_lag:
                if int(self._probe) >= self.config.keyframes_window:
                    self._pending = self._solve(state, self.config, self.mesh)  # async
                    self._probe = None
                    self._age = 0
                    self.num_launched += 1
                    return state
                self._probe = None
        if self._probe is None:
            self._since_check += 1
            if self._since_check >= self.check_every:
                self._since_check = 0
                self._probe = state.kf_since_opt  # async dispatch readback
                self._probe_age = 0
        return state

    def flush(self, state: slam.SlamState) -> slam.SlamState:
        """Fold any pending solve; then, if the window has filled with no
        solve in flight, run the due solve synchronously — end-of-stream
        parity with the inline back-end."""
        if self._pending is not None:
            state = self._fold(state, self._pending, self.config)
            self._pending = None
            self.num_folded += 1
        self._probe = None
        if int(state.kf_since_opt) >= self.config.keyframes_window:
            solve = self._solve(state, self.config, self.mesh)
            state = self._fold(state, solve, self.config)
            self.num_launched += 1
            self.num_folded += 1
        return state
