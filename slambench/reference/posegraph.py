"""Plain NumPy reference of the final pose-graph optimization.

g2o's Levenberg-Marquardt as the reference system runs it at
saveFinalResult: vertices SE(3), edge error log(Z^-1 Xi^-1 Xj) in
(translation, rotation) tangent coordinates, local right perturbations,
information-weighted squares, the Cauchy kernel (delta 1) on the edges
added by loop closure, recovery and findMoreLoops, fixed vertices held,
damping lambda*(diag(H) + 1e-6) that halves on a step that lowers the
cost and quadruples on one that does not, at most `iterations` steps and
a stop when the relative decrease falls under 1e-8. Float64, Jacobians
by central differences. Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np


def _hat(w):
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    o = np.zeros_like(x)
    return np.stack([np.stack([o, -z, y], -1), np.stack([z, o, -x], -1),
                     np.stack([-y, x, o], -1)], -2)


def _coeffs(theta):
    """sin t / t, (1 - cos t)/t^2, (t - sin t)/t^3 with series near 0."""
    t2 = theta * theta
    small = t2 < 1e-8
    ts = np.where(small, 1.0, theta)
    a = np.where(small, 1 - t2 / 6, np.sin(ts) / ts)
    b = np.where(small, 0.5 - t2 / 24, (1 - np.cos(ts)) / (ts * ts))
    c = np.where(small, 1 / 6 - t2 / 120, (ts - np.sin(ts)) / (ts ** 3))
    return a, b, c


def exp_se3(xi):
    rho, phi = xi[..., :3], xi[..., 3:]
    theta = np.linalg.norm(phi, axis=-1)
    a, b, c = _coeffs(theta)
    K = _hat(phi)
    I = np.broadcast_to(np.eye(3), K.shape)
    R = I + a[..., None, None] * K + b[..., None, None] * (K @ K)
    V = I + b[..., None, None] * K + c[..., None, None] * (K @ K)
    T = np.zeros(xi.shape[:-1] + (4, 4))
    T[..., :3, :3] = R
    T[..., :3, 3] = (V @ rho[..., None])[..., 0]
    T[..., 3, 3] = 1
    return T


def log_se3(T):
    R, t = T[..., :3, :3], T[..., :3, 3]
    cos = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1) / 2, -1, 1)
    theta = np.arccos(cos)
    w = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                  R[..., 1, 0] - R[..., 0, 1]], -1)
    small = theta < 1e-6
    s = np.where(small, 1.0, np.sin(theta))
    phi = np.where(small[..., None], 0.5 * w, (theta / (2 * s))[..., None] * w)
    _, b, c = _coeffs(np.linalg.norm(phi, axis=-1))
    K = _hat(phi)
    V = np.eye(3) + b[..., None, None] * K + c[..., None, None] * (K @ K)
    rho = np.linalg.solve(V, t[..., None])[..., 0]
    return np.concatenate([rho, phi], -1)


def _inv(T):
    R, t = T[..., :3, :3], T[..., :3, 3]
    out = np.zeros_like(T)
    out[..., :3, :3] = np.swapaxes(R, -1, -2)
    out[..., :3, 3] = -(np.swapaxes(R, -1, -2) @ t[..., None])[..., 0]
    out[..., 3, 3] = 1
    return out


def optimize(poses, fixed, edges, iterations: int, delta: float = 1.0,
             step: float = 1e-6):
    """poses (V,4,4), fixed (V,) bool, edges [(i, j, Z 4x4, info 6x6,
    robust)] with vertex positions i, j. Returns the optimized (V,4,4)."""
    X = np.asarray(poses, np.float64)
    ei = np.array([e[0] for e in edges])
    ej = np.array([e[1] for e in edges])
    Zinv = _inv(np.stack([np.asarray(e[2], np.float64) for e in edges]))
    info = np.stack([np.asarray(e[3], np.float64) for e in edges])
    robust = np.array([bool(e[4]) for e in edges])
    V = X.shape[0]
    free = ~np.asarray(fixed, bool)
    fmask = np.repeat(free, 6)

    def residuals(Xi, Xj):
        return log_se3(Zinv @ _inv(Xi) @ Xj)

    def cost_terms(X):
        Xi, Xj = X[ei], X[ej]
        r = residuals(Xi, Xj)
        chi = np.einsum("ea,eab,eb->e", r, info, r)
        w = np.where(robust, 1.0 / (1.0 + chi / delta ** 2), 1.0)
        rho = np.where(robust, delta ** 2 * np.log1p(chi / delta ** 2), chi)
        # Jacobians of r by central differences of right perturbations
        E = len(edges)
        J = np.zeros((E, 6, 12))
        for k in range(12):
            d = np.zeros(6)
            d[k % 6] = step
            D = exp_se3(d)
            Dm = exp_se3(-d)
            if k < 6:
                rp, rm = residuals(Xi @ D, Xj), residuals(Xi @ Dm, Xj)
            else:
                rp, rm = residuals(Xi, Xj @ D), residuals(Xi, Xj @ Dm)
            J[:, :, k] = (rp - rm) / (2 * step)
        Wi = info * w[:, None, None]
        Ji, Jj = J[:, :, :6], J[:, :, 6:]

        def quad(A, B):
            return np.einsum("eai,eab,ebj->eij", A, Wi, B)

        H = np.zeros((V, V, 6, 6))
        np.add.at(H, (ei, ei), quad(Ji, Ji))
        np.add.at(H, (ej, ej), quad(Jj, Jj))
        np.add.at(H, (ei, ej), quad(Ji, Jj))
        np.add.at(H, (ej, ei), quad(Jj, Ji))
        g = np.zeros((V, 6))
        np.add.at(g, ei, np.einsum("eai,eab,eb->ei", Ji, Wi, r))
        np.add.at(g, ej, np.einsum("eai,eab,eb->ei", Jj, Wi, r))
        H = H.transpose(0, 2, 1, 3)
        return float(np.sum(rho)), H.reshape(6 * V, 6 * V), g.reshape(-1)

    cur = cost_terms(X)
    lam = 1e-4
    for _ in range(iterations):
        chi, H, g = cur
        Hd = np.where(fmask[:, None] & fmask[None, :], H, 0.0)
        dg = np.diag(Hd).copy()
        Hd[np.diag_indices_from(Hd)] += np.where(fmask, lam * (dg + 1e-6), 1.0)
        dx = np.linalg.solve(Hd, -np.where(fmask, g, 0.0))
        cand = (X @ exp_se3(dx.reshape(V, 6) * free[:, None]))
        new = cost_terms(cand)
        if new[0] < chi:
            X, cur = cand, new
            if (chi - new[0]) / max(chi, 1e-12) < 1e-8:
                break
            lam = max(lam * 0.5, 1e-8)
        else:
            if lam >= 1e6:
                break
            lam = min(lam * 4.0, 1e6)
    return X
