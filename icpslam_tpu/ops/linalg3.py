"""Small batched linear algebra helpers (3x3 / 6x6) used by registration.

Closed-form adjugate inverses avoid calling general LAPACK-style kernels for
tiny matrices inside hot loops — everything is elementwise math that
broadcasts over arbitrary leading batch axes.
"""

from __future__ import annotations

import jax.numpy as jnp


def det3(m: jnp.ndarray) -> jnp.ndarray:
    """Determinant of (..., 3, 3)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def inv3(m: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Closed-form inverse of (..., 3, 3) via the adjugate.

    Singular inputs are regularized by clamping |det| away from zero; the
    caller is expected to have conditioned the matrices (e.g. GICP epsilon-
    inflated covariances are always invertible).
    """
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d
    det = a * A + b * B + c * C
    det = jnp.where(jnp.abs(det) < eps, jnp.sign(det) * eps + (det == 0) * eps, det)
    adj = jnp.stack([A, D, G, B, E, H, C, F, I], axis=-1).reshape(m.shape)
    return adj / det[..., None, None]


def solve_psd(H: jnp.ndarray, b: jnp.ndarray, damping: float = 0.0) -> jnp.ndarray:
    """Solve (H + damping*diag(H)) x = b for symmetric PSD H (..., n, n).

    Levenberg-style diagonal damping; uses Cholesky via jnp.linalg.solve
    (small n, batched).
    """
    n = H.shape[-1]
    eye = jnp.eye(n, dtype=H.dtype)
    if damping:
        diag = jnp.diagonal(H, axis1=-2, axis2=-1)
        H = H + damping * diag[..., None] * eye
    # tiny Tikhonov floor for numerical safety
    H = H + 1e-9 * eye
    return jnp.linalg.solve(H, b[..., None])[..., 0]


def solve_chol_unrolled(
    H: jnp.ndarray, b: jnp.ndarray, damping: float = 0.0
) -> jnp.ndarray:
    """Solve ``(H + damping·diag(H)) x = b`` for one small SPD system via a
    fully unrolled Cholesky (n fixed at trace time, e.g. the 6×6 GN normal
    equations inside the ICP loop).

    ``jnp.linalg.solve`` lowers a single tiny system to a general LU
    kernel — scalar-sequential and disproportionately expensive inside a
    ``while_loop`` body. Unrolling emits ~n³/3 fused scalar FLOPs instead.
    Same Tikhonov/damping conditioning as :func:`solve_psd`.
    """
    n = H.shape[-1]
    diag = jnp.diagonal(H)
    d = damping * diag + 1e-9 if damping else jnp.full((n,), 1e-9, H.dtype)
    A = [[H[i, j] + (d[i] if i == j else 0.0) for j in range(n)] for i in range(n)]
    # Cholesky A = L Lᵀ (scalar unroll; guarded sqrt for robustness)
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    # forward substitution L y = b
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # back substitution Lᵀ x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x)


def symmetrize(m: jnp.ndarray) -> jnp.ndarray:
    return 0.5 * (m + jnp.swapaxes(m, -1, -2))


def eigvals_sym3(A: jnp.ndarray) -> jnp.ndarray:
    """Analytic eigenvalues of symmetric (..., 3, 3), ascending (..., 3).

    Trigonometric Cardano solution — pure elementwise math, orders of
    magnitude faster than LAPACK-style ``eigh`` for large batches of tiny
    matrices (the GICP covariance path runs this on every point).
    """
    lo, mid, hi = eigvals_sym3_comps(*sym3_comps(A))
    return jnp.stack([lo, mid, hi], axis=-1)


def eigvals_sym3_comps(a00, a01, a02, a11, a12, a22):
    """Component-form :func:`eigvals_sym3`: six (...,) arrays in, three
    (...,) eigenvalue arrays out (ascending)."""
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    d0, d1, d2 = a00 - q, a11 - q, a22 - q
    p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0 * p1
    small = p2 < 1e-20
    p = jnp.sqrt(jnp.where(small, 1.0, p2) / 6.0)
    pinv = jnp.where(small, 0.0, 1.0 / p)
    # det((A - qI)/p) / 2
    b00, b11, b22 = d0 * pinv, d1 * pinv, d2 * pinv
    b01, b02, b12 = a01 * pinv, a02 * pinv, a12 * pinv
    detB = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = jnp.clip(0.5 * detB, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    e_hi = q + 2.0 * p * jnp.cos(phi)
    e_lo = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    # isotropic matrices (p2 ≈ 0) have all eigenvalues equal to q; the
    # guarded p above is a dummy there, so select q explicitly
    e_lo = jnp.where(small, q, e_lo)
    e_mid = jnp.where(small, q, e_mid)
    e_hi = jnp.where(small, q, e_hi)
    return e_lo, e_mid, e_hi


def smallest_eigenvector_sym3(
    A: jnp.ndarray, fallback: tuple = (0.0, 0.0, 1.0)
) -> jnp.ndarray:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., 3, 3).

    Null-space extraction via row cross products of ``A − λ_min I`` (the
    best-conditioned of the three row pairs). Near-isotropic matrices have
    no well-defined direction; those fall back to ``fallback`` — harmless
    for GICP, where an isotropic patch carries no plane constraint anyway.
    """
    vx, vy, vz = smallest_eigenvector_sym3_comps(*sym3_comps(A), fallback=fallback)
    return jnp.stack([vx, vy, vz], axis=-1)


def smallest_eigenvector_sym3_comps(
    a, b, c, d, e, f, fallback: tuple = (0.0, 0.0, 1.0)
):
    """Component-form :func:`smallest_eigenvector_sym3` (see layout note on
    :func:`inv_sym3_comps`): six symmetric components in, three unit-vector
    components out."""
    lam = eigvals_sym3_comps(a, b, c, d, e, f)[0]
    # rows of A − λ_min I
    r0 = (a - lam, b, c)
    r1 = (b, d - lam, e)
    r2 = (c, e, f - lam)

    def cross(u, v):
        return (
            u[1] * v[2] - u[2] * v[1],
            u[2] * v[0] - u[0] * v[2],
            u[0] * v[1] - u[1] * v[0],
        )

    c01, c02, c12 = cross(r0, r1), cross(r0, r2), cross(r1, r2)
    n01 = c01[0] ** 2 + c01[1] ** 2 + c01[2] ** 2
    n02 = c02[0] ** 2 + c02[1] ** 2 + c02[2] ** 2
    n12 = c12[0] ** 2 + c12[1] ** 2 + c12[2] ** 2
    use01 = (n01 >= n02) & (n01 >= n12)
    use02 = ~use01 & (n02 >= n12)
    v = tuple(
        jnp.where(use01, x01, jnp.where(use02, x02, x12))
        for x01, x02, x12 in zip(c01, c02, c12)
    )
    n2 = jnp.where(use01, n01, jnp.where(use02, n02, n12))
    n = jnp.sqrt(n2)
    ok = n > 1e-10
    inv_n = jnp.where(ok, 1.0 / jnp.where(ok, n, 1.0), 0.0)
    return tuple(
        jnp.where(ok, vi * inv_n, fb) for vi, fb in zip(v, fallback)
    )


def inv_sym3_comps(a, b, c, d, e, f, eps: float = 1e-12):
    """Inverse of symmetric ``[[a,b,c],[b,d,e],[c,e,f]]`` in component form.

    Operands and results are six same-shaped arrays (typically ``(N,)``) —
    the structure-of-arrays layout keeps every op elementwise over the
    batch, instead of ``(N, 3, 3)`` tensors with short trailing dims.
    Same det-clamp regularization as :func:`inv3`.
    """
    cof00 = d * f - e * e
    cof01 = c * e - b * f
    cof02 = b * e - c * d
    det = a * cof00 + b * cof01 + c * cof02
    det = jnp.where(jnp.abs(det) < eps, jnp.sign(det) * eps + (det == 0) * eps, det)
    inv_det = 1.0 / det
    return (
        cof00 * inv_det,
        cof01 * inv_det,
        cof02 * inv_det,
        (a * f - c * c) * inv_det,
        (b * c - a * e) * inv_det,
        (a * d - b * b) * inv_det,
    )


def rotate_sym3_comps(R: jnp.ndarray, comps):
    """``B = R C Rᵀ`` for symmetric C in component form (see above).

    ``R`` is a single (3, 3) rotation (scalar entries, unrolled at trace
    time); ``comps`` are the six (...,)-shaped components of C. Returns
    B's six components.
    """
    a, b, c, d, e, f = comps
    C = ((a, b, c), (b, d, e), (c, e, f))
    V = [
        [sum(R[i, k] * C[k][j] for k in range(3)) for j in range(3)]
        for i in range(3)
    ]
    B = [
        [sum(V[i][k] * R[j, k] for k in range(3)) for j in range(3)]
        for i in (0, 1, 2)
    ]
    return B[0][0], B[0][1], B[0][2], B[1][1], B[1][2], B[2][2]


def sym3_comps(A: jnp.ndarray):
    """Split symmetric (..., 3, 3) into its six (...,) components."""
    return (
        A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
        A[..., 1, 1], A[..., 1, 2], A[..., 2, 2],
    )


def pack_sym3(A: jnp.ndarray) -> jnp.ndarray:
    """Pack symmetric (..., 3, 3) into (..., 6) as [xx, xy, xz, yy, yz, zz]
    (the canonical component order of :func:`sym3_comps`)."""
    return jnp.stack(sym3_comps(A), axis=-1)


def unpack_sym3(p: jnp.ndarray) -> jnp.ndarray:
    """Inverse of ``pack_sym3``: (..., 6) → symmetric (..., 3, 3)."""
    xx, xy, xz, yy, yz, zz = (p[..., i] for i in range(6))
    row0 = jnp.stack([xx, xy, xz], axis=-1)
    row1 = jnp.stack([xy, yy, yz], axis=-1)
    row2 = jnp.stack([xz, yz, zz], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def mat_to_sym6(A: jnp.ndarray) -> jnp.ndarray:
    """Symmetric (..., 3, 3) → components-first (6, ...) packed array.

    ``(6, N)`` is the canonical covariance layout of the registration
    path: the batch axis is the last, contiguous one, so every per-point
    op runs elementwise over it (no ``(N, 3, 3)`` intermediates).
    Component order: [xx, xy, xz, yy, yz, zz].
    """
    return jnp.stack(sym3_comps(A))


def sym6_to_mat(c: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`mat_to_sym6`: (6, ...) → symmetric (..., 3, 3)."""
    xx, xy, xz, yy, yz, zz = c
    row0 = jnp.stack([xx, xy, xz], axis=-1)
    row1 = jnp.stack([xy, yy, yz], axis=-1)
    row2 = jnp.stack([xz, yz, zz], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)
