"""Synthetic worlds and scan streams with ground truth.

The reference has no test fixtures at all (SURVEY.md §4) — its only
verification is replaying rosbags into rviz. This module is the framework's
fixture generator: dense surface worlds, loop trajectories, and a simple
range-limited scan renderer, all with exact ground-truth poses, used by the
integration tests, the toy-loop benchmark config, and the examples.

Host-side numpy (data generation is not a device workload); outputs feed the
jitted pipeline as padded ``PointCloud``s.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from icpslam_tpu.cloud import pointcloud as pc
from icpslam_tpu.geometry import se3

import jax.numpy as jnp


def make_room_world(
    seed: int = 0,
    n_points: int = 20000,
    size: float = 20.0,
    height: float = 3.0,
    pillar_frac: float = 0.15,
) -> np.ndarray:
    """Dense points on the surfaces of a box room: floor + 4 walls + interior
    pillars. Returns (n, 3) float32.

    ``pillar_frac`` of the points go onto ~a dozen cylindrical pillars —
    without them the world is all axis-aligned planes, ICP's translation
    along a wall is unconstrained (the classic corridor degeneracy), and any
    trajectory metric on top is meaningless noise.
    """
    rng = np.random.RandomState(seed)
    half = size / 2.0
    n_pillar = max(int(n_points * pillar_frac), 200)
    n_rest = n_points - n_pillar
    n_wall = (n_rest - n_rest // 3) // 4
    n_floor = n_rest - 4 * n_wall  # floor absorbs the rounding remainder
    parts = [
        np.c_[rng.uniform(-half, half, (n_floor, 2)), np.zeros(n_floor)],
        np.c_[rng.uniform(-half, half, n_wall), np.full(n_wall, half), rng.uniform(0, height, n_wall)],
        np.c_[rng.uniform(-half, half, n_wall), np.full(n_wall, -half), rng.uniform(0, height, n_wall)],
        np.c_[np.full(n_wall, half), rng.uniform(-half, half, n_wall), rng.uniform(0, height, n_wall)],
        np.c_[np.full(n_wall, -half), rng.uniform(-half, half, n_wall), rng.uniform(0, height, n_wall)],
    ]
    # pillars break the symmetry so ICP locks in all DoF
    n_pil = 12
    centers = rng.uniform(-half * 0.85, half * 0.85, (n_pil, 2))
    radii = rng.uniform(0.2, 0.6, n_pil)
    th = rng.uniform(0, 2 * np.pi, n_pillar)
    which = rng.randint(0, n_pil, n_pillar)
    pillar = np.c_[
        centers[which, 0] + radii[which] * np.cos(th),
        centers[which, 1] + radii[which] * np.sin(th),
        rng.uniform(0, height, n_pillar),
    ]
    parts.append(pillar)
    return np.concatenate(parts).astype(np.float32)


def make_street_grid_world(
    seed: int = 0,
    n_points: int = 60000,
    blocks: int = 2,
    block_size: float = 24.0,
    street_width: float = 8.0,
    height: float = 6.0,
) -> np.ndarray:
    """City-like world: a grid of building blocks separated by streets —
    ground plane + building walls. Supports long multi-loop trajectories
    (the KITTI-00-style workload of BASELINE config 3)."""
    rng = np.random.RandomState(seed)
    pitch = block_size + street_width
    extent = blocks * pitch + street_width
    n_ground = n_points // 3
    parts = [
        np.c_[rng.uniform(0, extent, (n_ground, 2)), np.zeros(n_ground)]
    ]
    n_wall_pts = (n_points - n_ground) // (blocks * blocks * 4)
    for bx in range(blocks):
        for by in range(blocks):
            x0 = street_width + bx * pitch
            y0 = street_width + by * pitch
            x1, y1 = x0 + block_size, y0 + block_size
            walls = [
                np.c_[rng.uniform(x0, x1, n_wall_pts), np.full(n_wall_pts, y0),
                      rng.uniform(0, height, n_wall_pts)],
                np.c_[rng.uniform(x0, x1, n_wall_pts), np.full(n_wall_pts, y1),
                      rng.uniform(0, height, n_wall_pts)],
                np.c_[np.full(n_wall_pts, x0), rng.uniform(y0, y1, n_wall_pts),
                      rng.uniform(0, height, n_wall_pts)],
                np.c_[np.full(n_wall_pts, x1), rng.uniform(y0, y1, n_wall_pts),
                      rng.uniform(0, height, n_wall_pts)],
            ]
            parts.extend(walls)
    return np.concatenate(parts).astype(np.float32)


def make_urban_world(
    seed: int = 0,
    blocks: int = 3,
    block_size: float = 80.0,
    street_width: float = 18.0,
    height: float = 12.0,
    ground_density: float = 3.0,
    wall_density: float = 9.0,
    n_poles: int = 200,
) -> np.ndarray:
    """KITTI-proxy urban world: a grid of city blocks at velodyne scale
    (default ~310 m extent) — ground plane, building facades of varying
    heights, and pole-like verticals (lamp posts / trunks) that break the
    planar degeneracy. Densities are points per m² (surfaces must be dense
    enough for the 64-beam z-buffer renderer to see solid walls).

    This is the VERDICT r1 workload stand-in for KITTI (no dataset on the
    machine): urban extent, occlusions, long straight streets + corners.
    """
    rng = np.random.RandomState(seed)
    pitch = block_size + street_width
    extent = blocks * pitch + street_width
    parts = []
    # ground
    n_ground = int(extent * extent * ground_density)
    parts.append(
        np.c_[rng.uniform(0, extent, (n_ground, 2)), np.zeros(n_ground)]
    )
    # building facades with per-block random heights; slight facade
    # roughness so plane-mode ICP sees realistic normals
    for bx in range(blocks):
        for by in range(blocks):
            x0 = street_width + bx * pitch
            y0 = street_width + by * pitch
            x1, y1 = x0 + block_size, y0 + block_size
            h = rng.uniform(0.5, 1.0) * height
            n_wall = int(block_size * h * wall_density)
            rough = lambda n: rng.randn(n).astype(np.float64) * 0.03
            walls = [
                np.c_[rng.uniform(x0, x1, n_wall), np.full(n_wall, y0) + rough(n_wall),
                      rng.uniform(0, h, n_wall)],
                np.c_[rng.uniform(x0, x1, n_wall), np.full(n_wall, y1) + rough(n_wall),
                      rng.uniform(0, h, n_wall)],
                np.c_[np.full(n_wall, x0) + rough(n_wall), rng.uniform(y0, y1, n_wall),
                      rng.uniform(0, h, n_wall)],
                np.c_[np.full(n_wall, x1) + rough(n_wall), rng.uniform(y0, y1, n_wall),
                      rng.uniform(0, h, n_wall)],
            ]
            parts.extend(walls)
    # poles along the streets
    pts_per_pole = 150
    px = rng.uniform(0, extent, n_poles)
    py = rng.uniform(0, extent, n_poles)
    for i in range(n_poles):
        z = rng.uniform(0, 5.0, pts_per_pole)
        th = rng.uniform(0, 2 * np.pi, pts_per_pole)
        parts.append(
            np.c_[px[i] + 0.15 * np.cos(th), py[i] + 0.15 * np.sin(th), z]
        )
    return np.concatenate(parts).astype(np.float32)


def make_urban_drive(
    n_poses: int = 500,
    blocks: int = 3,
    block_size: float = 80.0,
    street_width: float = 18.0,
    speed: float = 8.0,
    rate_hz: float = 10.0,
    z: float = 1.7,
    lap_margin: float = 0.0,
) -> se3.Pose:
    """10 Hz urban drive around the first city block — long straights,
    rounded 90° corners (a vehicle can't yaw 90° between two 10 Hz
    scans; instantaneous corners break any odometry, real or simulated),
    and a loop closure when the route returns to the start. ``speed`` m/s
    at ``rate_hz`` scans/s (KITTI-like ~0.8 m between scans). The route
    loops as many times as ``n_poses`` requires."""
    del lap_margin  # route geometry is fixed by the block layout
    half = street_width / 2.0
    c0 = half
    c1 = street_width + block_size + half
    corner_r = min(6.0, half * 0.9 + 2.0)  # turn radius within the street
    # rectangle around the first block with quarter-circle corner arcs:
    # straights shortened by corner_r at each end
    corners = np.array([[c0, c0], [c1, c0], [c1, c1], [c0, c1]], np.float64)
    step = speed / rate_hz
    pts = []
    yaws = []
    i = 0
    while len(pts) < n_poses:
        a = corners[i % 4]
        b = corners[(i + 1) % 4]
        c = corners[(i + 2) % 4]
        d1 = (b - a) / np.linalg.norm(b - a)
        d2 = (c - b) / np.linalg.norm(c - b)
        seg_len = np.linalg.norm(b - a) - 2 * corner_r
        # straight part (from a+r·d1 for seg_len)
        n_seg = max(int(seg_len / step), 1)
        for k in range(n_seg):
            if len(pts) >= n_poses:
                break
            p = a + d1 * (corner_r + k * step)
            pts.append([p[0], p[1], z])
            yaws.append(np.arctan2(d1[1], d1[0]))
        # quarter-circle arc from (b - r·d1) to (b + r·d2)
        center = b - d1 * corner_r + d2 * corner_r
        yaw0 = np.arctan2(d1[1], d1[0])
        # left turn (counter-clockwise route): heading advances +90°
        arc_len = np.pi / 2 * corner_r
        n_arc = max(int(arc_len / step), 1)
        for k in range(n_arc):
            if len(pts) >= n_poses:
                break
            th = (k + 0.5) / n_arc * (np.pi / 2)
            heading = yaw0 + th
            # position on the arc: start point rotated about the center
            start = b - d1 * corner_r
            rel = start - center
            rot = np.array(
                [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
            )
            p = center + rot @ rel
            pts.append([p[0], p[1], z])
            yaws.append(heading)
        i += 1
    pos = np.asarray(pts, np.float64)
    yaw = np.asarray(yaws, np.float64)
    q = np.stack(
        [np.cos(yaw / 2), np.zeros_like(yaw), np.zeros_like(yaw), np.sin(yaw / 2)],
        axis=-1,
    )
    return se3.Pose(t=jnp.asarray(pos, jnp.float32), q=jnp.asarray(q, jnp.float32))


def _quat_slerp_np(q0: np.ndarray, q1: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Slerp q0→q1 at fractions u (n,) → (n, 4), host numpy (wxyz)."""
    q0 = q0 / np.linalg.norm(q0)
    q1 = q1 / np.linalg.norm(q1)
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:  # nearly parallel: lerp + renorm
        out = q0[None, :] + u[:, None] * (q1 - q0)[None, :]
        return out / np.linalg.norm(out, axis=-1, keepdims=True)
    th = np.arccos(np.clip(d, -1, 1))
    s = np.sin(th)
    a = np.sin((1 - u) * th) / s
    b = np.sin(u * th) / s
    return a[:, None] * q0[None, :] + b[:, None] * q1[None, :]


def _quat_rot_np(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vectors v (n, 3) by unit quaternions q (n, 4) wxyz, numpy."""
    w, x, y, z = q[:, 0:1], q[:, 1:2], q[:, 2:3], q[:, 3:4]
    uv = 2.0 * np.cross(q[:, 1:], v)
    return v + w * uv + np.cross(q[:, 1:], uv)


def render_velodyne_scan(
    world: np.ndarray,
    pose_t: np.ndarray,
    pose_q: np.ndarray,
    n_beams: int = 64,
    azimuth_bins: int = 2048,
    elevation_range: Tuple[float, float] = (-24.8, 2.0),
    max_range: float = 80.0,
    min_range: float = 2.5,
    noise: float = 0.02,
    noise_range_coeff: float = 0.0,
    dropout: float = 0.0,
    seed: int = 0,
    max_points: Optional[int] = None,
    next_pose_t: Optional[np.ndarray] = None,
    next_pose_q: Optional[np.ndarray] = None,
    return_times: bool = False,
):
    """Simulate a 64-beam spinning lidar with occlusion: world points are
    projected into (elevation-beam, azimuth) bins in the sensor frame and
    only the NEAREST return per bin survives (a spherical z-buffer). This
    reproduces the velodyne scan structure the reference targets
    (``/root/reference/config/icpslam.yaml:13`` '20 for velodyne') —
    occluded facades genuinely disappear, beam density falls off with
    range. Returns (n, 3) float32 in the sensor frame (of ``pose``, the
    sweep-start pose); with ``return_times`` also the per-point sweep
    fraction (n,) float32 in [0, 1).

    Real-sensor physics (VERDICT r2 item 5):

    - **Motion distortion**: when ``next_pose`` is given, each return is
      re-measured from the *interpolated* sensor pose at its azimuth's
      capture time (the sweep spans the full inter-scan motion) — the
      smeared geometry every spinning lidar actually outputs. Consumers
      either de-skew at ingest (``deskew_scan``) or absorb the error.
    - **Range-dependent noise**: σ(r) = noise + noise_range_coeff·r
      meters along the ray (beam divergence + weaker returns far out).
    - **Dropout**: each return independently lost with prob ``dropout``
      (absorptive surfaces, specular bounces).
    """
    rng = np.random.RandomState(seed)
    # world → sensor frame — pure host numpy: routing the 1M-point world
    # through jnp would round-trip it over the device per scan
    d = np.linalg.norm(world - np.asarray(pose_t, np.float32)[None, :], axis=-1)
    near = world[(d <= max_range) & (d >= min_range * 0.5)]
    q_np = np.asarray(pose_q, np.float64)
    q_conj0 = np.r_[q_np[0], -q_np[1:]] / np.linalg.norm(q_np)
    local = _quat_rot_np(
        q_conj0[None, :], near.astype(np.float64) - np.asarray(pose_t, np.float64)
    ).astype(np.float32)

    r = np.linalg.norm(local, axis=-1)
    keep = (r >= min_range) & (r <= max_range)
    local, r = local[keep], r[keep]
    near = near[keep]
    az = np.arctan2(local[:, 1], local[:, 0])  # [-pi, pi)
    el = np.degrees(np.arcsin(np.clip(local[:, 2] / np.maximum(r, 1e-9), -1, 1)))

    lo, hi = elevation_range
    beam = np.floor((el - lo) / (hi - lo) * n_beams).astype(np.int64)
    in_fov = (beam >= 0) & (beam < n_beams)
    abin = np.floor((az + np.pi) / (2 * np.pi) * azimuth_bins).astype(np.int64)
    abin = np.clip(abin, 0, azimuth_bins - 1)

    local, r, beam, abin = local[in_fov], r[in_fov], beam[in_fov], abin[in_fov]
    world_pts = near[in_fov]
    cell = beam * azimuth_bins + abin
    # z-buffer: nearest return per cell
    order = np.lexsort((r, cell))
    cell_sorted = cell[order]
    first = np.ones(cell_sorted.shape[0], bool)
    first[1:] = cell_sorted[1:] != cell_sorted[:-1]
    hits = local[order][first]
    rr = r[order][first]
    world_hits = world_pts[order][first]
    abin_hits = abin[order][first]
    # sweep fraction from azimuth: the scanner sweeps [-pi, pi) once per
    # period, so capture time offset = fraction of the bin index
    frac = (abin_hits.astype(np.float64) + 0.5) / azimuth_bins

    if next_pose_t is not None:
        # motion distortion: re-measure each world hit from the sensor
        # pose interpolated to its capture time; output stays expressed
        # in the sweep-START sensor frame (what the device would report
        # without an INS): p_meas = T(start)⁻¹-convention raw points are
        # literally T(frac)⁻¹ · w stacked as one "cloud"
        u = frac.astype(np.float64)
        t_interp = (
            np.asarray(pose_t, np.float64)[None, :] * (1 - u[:, None])
            + np.asarray(next_pose_t, np.float64)[None, :] * u[:, None]
        )
        q_interp = _quat_slerp_np(
            np.asarray(pose_q, np.float64), np.asarray(next_pose_q, np.float64), u
        )
        # conjugate quaternion rotates world → sensor
        q_conj = np.c_[q_interp[:, 0], -q_interp[:, 1:]]
        hits = _quat_rot_np(q_conj, world_hits.astype(np.float64) - t_interp)
        rr = np.linalg.norm(hits, axis=-1)

    if noise or noise_range_coeff:
        sigma = noise + noise_range_coeff * rr
        scale = 1.0 + rng.randn(hits.shape[0]) * sigma / np.maximum(rr, 1e-6)
        hits = hits * scale[:, None]
    if dropout:
        keep_m = rng.uniform(size=hits.shape[0]) >= dropout
        hits, frac = hits[keep_m], frac[keep_m]
    if max_points is not None and hits.shape[0] > max_points:
        sel = rng.choice(hits.shape[0], max_points, replace=False)
        hits, frac = hits[sel], frac[sel]
    hits = hits.astype(np.float32)
    if return_times:
        return hits, frac.astype(np.float32)
    return hits


def deskew_scan(
    points: np.ndarray,
    rel_t: np.ndarray,
    rel_q: np.ndarray,
    times: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Causal motion de-skew: undo intra-sweep motion using a constant-
    velocity model (``rel`` ≈ the previous inter-scan transform, e.g. the
    odometry front-end's last accepted estimate — exactly the information
    a real pipeline has at ingest).

    ``times``: per-point sweep fraction in [0, 1); derived from each
    point's azimuth when omitted (how real de-skew works without
    per-point stamps). Points are re-expressed in the sweep-start frame:
    ``p' = T(u)·p`` with ``T(u)`` the pose of the sensor at fraction
    ``u`` under the constant-velocity extrapolation of ``rel``.
    """
    if times is None:
        az = np.arctan2(points[:, 1], points[:, 0])
        times = ((az + np.pi) / (2 * np.pi)).astype(np.float64)
    u = np.asarray(times, np.float64)
    t1 = np.asarray(rel_t, np.float64)
    q0 = np.array([1.0, 0.0, 0.0, 0.0])
    q_u = _quat_slerp_np(q0, np.asarray(rel_q, np.float64), u)
    t_u = t1[None, :] * u[:, None]
    return (_quat_rot_np(q_u, points.astype(np.float64)) + t_u).astype(np.float32)


def make_moving_objects(
    seed: int = 0,
    n_vehicles: int = 6,
    blocks: int = 3,
    block_size: float = 80.0,
    street_width: float = 18.0,
    speed_range: Tuple[float, float] = (5.0, 12.0),
    pts_per_vehicle: int = 900,
):
    """Dynamic objects for the urban proxy: box-shaped 'vehicles' driving
    along the street grid. Returns a callable ``t -> (n, 3) float32`` of
    the moving points at time t (seconds) — per-scan world augmentation.
    """
    rng = np.random.RandomState(seed)
    pitch = block_size + street_width
    extent = blocks * pitch + street_width
    half = street_width / 2.0
    lanes = [street_width + k * pitch - half for k in range(blocks + 1)]
    vehicles = []
    for v in range(n_vehicles):
        along_x = bool(rng.randint(2))
        lane = lanes[rng.randint(len(lanes))] + rng.uniform(-2.0, 2.0)
        speed = rng.uniform(*speed_range) * (1 if rng.randint(2) else -1)
        phase = rng.uniform(0, extent)
        # box point cloud: 4.5 x 1.8 x 1.6 m shell
        n = pts_per_vehicle
        face = rng.randint(0, 5, n)
        lx = rng.uniform(-2.25, 2.25, n)
        ly = rng.uniform(-0.9, 0.9, n)
        lz = rng.uniform(0.0, 1.6, n)
        lx = np.where(face == 0, -2.25, np.where(face == 1, 2.25, lx))
        ly = np.where(face == 2, -0.9, np.where(face == 3, 0.9, ly))
        lz = np.where(face == 4, 1.6, lz)
        box = np.c_[lx, ly, lz]
        vehicles.append((along_x, lane, speed, phase, box))

    def at_time(t: float) -> np.ndarray:
        parts = []
        for along_x, lane, speed, phase, box in vehicles:
            pos = (phase + speed * t) % extent
            if along_x:
                center = np.array([pos, lane, 0.0])
                pts = box + center
            else:
                center = np.array([lane, pos, 0.0])
                # rotate the box 90° for cross-street travel
                pts = np.c_[box[:, 1], box[:, 0], box[:, 2]] + center
            parts.append(pts)
        return np.concatenate(parts).astype(np.float32)

    return at_time


def _quat_mul_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def ins_relative_motion(
    t: np.ndarray, q: np.ndarray, i: int, rng, noise_t: float, noise_r: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Noisy INS measurement of the sensor motion over sweep ``i``
    (relative transform body_i → body_{i+1}); KITTI rigs carry an OXTS
    INS, which is what real de-skew consumes."""
    j = min(i + 1, t.shape[0] - 1)
    q_conj = np.array([q[i][0], -q[i][1], -q[i][2], -q[i][3]])
    q_conj = q_conj / np.linalg.norm(q_conj)
    rel_q = _quat_mul_np(q_conj, q[j] / np.linalg.norm(q[j]))
    rel_t = _quat_rot_np(q_conj[None, :], (t[j] - t[i])[None, :])[0]
    if noise_t:
        rel_t = rel_t + rng.randn(3) * noise_t
    if noise_r:
        dq = np.concatenate([[1.0], rng.randn(3) * noise_r])
        rel_q = _quat_mul_np(rel_q, dq / np.linalg.norm(dq))
    return rel_t, rel_q / np.linalg.norm(rel_q)


def velodyne_stream(
    world: np.ndarray,
    trajectory: se3.Pose,
    capacity: int,
    rate_hz: float = 10.0,
    seed: int = 0,
    with_stamps: bool = True,
    dynamic=None,
    distortion: bool = False,
    deskew: bool = False,
    ins_noise_t: float = 0.01,
    ins_noise_r: float = 0.002,
    **render_kw,
):
    """Yield 64-beam scans (with 10 Hz stamps) along a trajectory.

    ``dynamic``: optional ``t -> (n, 3)`` callable of moving-object points
    appended to the world per scan (``make_moving_objects``).
    ``distortion=True`` smears each sweep across the inter-scan motion
    (see ``render_velodyne_scan``); ``deskew=True`` then undoes it at
    ingest with a *noisy INS* relative-motion measurement (σ =
    ``ins_noise_t`` m / ``ins_noise_r`` rad — the causal information a
    real KITTI-style rig has; using ground truth directly would be
    cheating).
    """
    t = np.asarray(trajectory.t, np.float64)
    q = np.asarray(trajectory.q, np.float64)
    n = t.shape[0]
    ins_rng = np.random.RandomState(seed + 90001)
    for i in range(n):
        world_i = (
            world if dynamic is None
            else np.concatenate([world, dynamic(i / rate_hz)])
        )
        kw = dict(render_kw)
        if distortion and i + 1 < n:
            kw.update(next_pose_t=t[i + 1], next_pose_q=q[i + 1])
        pts = render_velodyne_scan(
            world_i, t[i], q[i], seed=seed + i, max_points=capacity, **kw
        )
        if deskew and distortion and i + 1 < n:
            rel_t, rel_q = ins_relative_motion(
                t, q, i, ins_rng, ins_noise_t, ins_noise_r
            )
            pts = deskew_scan(pts, rel_t, rel_q)
        cloud = pc.from_points(pts, capacity=capacity)
        yield (cloud, i / rate_hz) if with_stamps else cloud


def make_figure_eight_trajectory(
    n_poses: int = 120,
    radius: float = 16.0,
    center: Tuple[float, float] = (20.0, 20.0),
    z: float = 1.2,
) -> "se3.Pose":
    """Figure-eight (lemniscate of Gerono) — self-intersecting, so loop
    closures fire away from the start as well."""
    t = np.linspace(0, 2 * np.pi, n_poses, endpoint=False)
    x = center[0] + radius * np.sin(t)
    y = center[1] + radius * np.sin(t) * np.cos(t)
    dx = radius * np.cos(t)
    dy = radius * (np.cos(t) ** 2 - np.sin(t) ** 2)
    yaw = np.arctan2(dy, dx)
    pos = np.c_[x, y, np.full(n_poses, z)]
    q = np.stack(
        [np.cos(yaw / 2), np.zeros_like(yaw), np.zeros_like(yaw), np.sin(yaw / 2)],
        axis=-1,
    )
    return se3.Pose(t=jnp.asarray(pos, jnp.float32), q=jnp.asarray(q, jnp.float32))


def make_loop_trajectory(
    n_poses: int = 60,
    radius: float = 6.0,
    z: float = 1.0,
    laps: float = 1.0,
) -> se3.Pose:
    """Circular loop trajectory (batched Pose, world-from-body), heading
    tangent to the circle. One full lap returns to the start — the loop-
    closure test case."""
    theta = np.linspace(0, 2 * np.pi * laps, n_poses, endpoint=False)
    t = np.c_[radius * np.cos(theta), radius * np.sin(theta), np.full(n_poses, z)]
    yaw = theta + np.pi / 2  # tangent heading
    q = np.stack([np.cos(yaw / 2), np.zeros_like(yaw), np.zeros_like(yaw), np.sin(yaw / 2)], axis=-1)
    return se3.Pose(t=jnp.asarray(t, jnp.float32), q=jnp.asarray(q, jnp.float32))


def render_scan(
    world: np.ndarray,
    pose_t: np.ndarray,
    pose_q: np.ndarray,
    max_range: float = 10.0,
    n_points: int = 2048,
    noise: float = 0.01,
    seed: int = 0,
) -> np.ndarray:
    """Simulate a scan: world points within range, expressed in the sensor
    frame, subsampled to ``n_points`` with Gaussian range noise. (n, 3)."""
    rng = np.random.RandomState(seed)
    d = np.linalg.norm(world - pose_t[None, :], axis=-1)
    visible = world[d <= max_range]
    if visible.shape[0] > n_points:
        sel = rng.choice(visible.shape[0], n_points, replace=False)
        visible = visible[sel]
    # world → sensor frame: R⁻¹ (p - t)
    inv = se3.inverse(se3.Pose(t=jnp.asarray(pose_t, jnp.float32), q=jnp.asarray(pose_q, jnp.float32)))
    local = np.asarray(se3.transform_points(inv, jnp.asarray(visible, jnp.float32)))
    if noise:
        local = local + rng.randn(*local.shape).astype(np.float32) * noise
    return local.astype(np.float32)


def scan_stream(
    world: np.ndarray,
    trajectory: se3.Pose,
    capacity: int,
    max_range: float = 10.0,
    n_points: int = 2048,
    noise: float = 0.01,
    seed: int = 0,
    rate_hz: float = 0.0,
):
    """Yield padded sensor-frame scans along a trajectory; with
    ``rate_hz > 0`` yields ``(cloud, stamp)`` pairs at that scan rate."""
    t = np.asarray(trajectory.t)
    q = np.asarray(trajectory.q)
    for i in range(t.shape[0]):
        pts = render_scan(
            world, t[i], q[i], max_range=max_range, n_points=n_points,
            noise=noise, seed=seed + i,
        )
        cloud = pc.from_points(pts, capacity=capacity)
        yield (cloud, i / rate_hz) if rate_hz > 0 else cloud
