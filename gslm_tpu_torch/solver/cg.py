"""Conjugate-gradient solvers over generalized vectors
(gslm_tpu/solver/cg.py): textbook CG and damped CGLS with periodic
restart, normal-equations CG on min ‖Ax−b‖² + xᵀDx where A is available
only through matvec/matvec_T callables and D through a damped dot.

- ``conjugate_gradient`` and ``cgls_damped``: host drivers, feature parity
  with the reference (conjugate_gradient.py:3-127); every scalar syncs to
  the host with ``float()``.
- ``cgls_damped_unrolled``: the LM step's solver. The same recurrence,
  unrolled over ``max_iter`` iterations, every scalar a 0-d device tensor
  and termination a ``done`` flag that freezes the iterate through
  ``torch.where``: no host sync.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def conjugate_gradient(matvec, dot, saxpy, scale, b, x0, tol=1e-10, atol=0.0,
                       max_iter=1000, callback=None, verbose=False):
    """Textbook CG for SPD systems (host driver)."""
    x = x0
    r = saxpy(-1.0, matvec(x), b)
    p = r
    rs_old = float(dot(r, r))
    if math.sqrt(rs_old) < atol:
        return x
    norm_r0 = math.sqrt(rs_old)
    for k in range(max_iter):
        ap = matvec(p)
        alpha = rs_old / float(dot(p, ap))
        x = saxpy(alpha, p, x)
        r = saxpy(-alpha, ap, r)
        rs_new = float(dot(r, r))
        if verbose:
            print(f"[Iter {k + 1}] residual norm: {math.sqrt(rs_new):.2e}")
        if callback:
            callback(x, r, k + 1)
        if math.sqrt(rs_new) < max(tol * norm_r0, atol):
            break
        p = saxpy(rs_new / rs_old, p, r)
        rs_old = rs_new
    return x


def cgls_damped(matvec: Callable, matvec_T: Callable, dot: Callable,
                saxpy: Callable, b, x0, damp=0.0,
                dampmul: Callable | None = None, tol=1e-10, atol=0.0,
                max_iter=1000, restart_iter=5, callback=None, verbose=False,
                check_divergence=True):
    """Damped CGLS, host driver (reference conjugate_gradient.py:51-127).

    matvec(x) A·x (params → residuals); matvec_T(r) Aᵀ·r; dot(u, v,
    damp=1.0) in either space (damp per parameter group); saxpy(a, x, y)
    a·x + y; dampmul(x) D·x, by default scalar ``damp``·x."""
    if dampmul is None:
        assert not isinstance(damp, dict), "per-group damp needs dampmul"
        dampmul = lambda x: saxpy(damp - 1.0, x, x)  # noqa: E731
    x = x0
    iter_total = 0
    last_res = math.inf
    break_flag = False

    while iter_total < max_iter:
        if verbose:
            print(f"Restarting CG at iteration {iter_total + 1}...")
        r = saxpy(-1.0, matvec(x), b)               # r = b - A x
        s = saxpy(-1.0, dampmul(x), matvec_T(r))    # s = Aᵀ r - D x
        p = s
        gamma = float(dot(s, s))

        for _ in range(restart_iter):
            q = matvec(p)
            delta = float(dot(q, q)) + float(dot(p, p, damp))
            if delta < 1e-20:
                if verbose:
                    print("Early termination: delta too small.")
                break_flag = True
                break
            alpha = gamma / delta
            x = saxpy(alpha, p, x)
            r = saxpy(-alpha, q, r)
            s = saxpy(-1.0, dampmul(x), matvec_T(r))
            gamma_prev = gamma
            gamma = float(dot(s, s))
            p = saxpy(gamma / gamma_prev, p, s)

            if check_divergence:
                cur_r = saxpy(-1.0, matvec(x), b)
                res = float(dot(cur_r, cur_r)) + float(dot(x, x, damp))
                if verbose:
                    print(f"[Iter {iter_total + 1}] res: {res:.2e}")
                if res > last_res:
                    if verbose:
                        print("Warning: residual norm increased!")
                    break_flag = True
                    break
                last_res = res

            if gamma < max(tol * math.sqrt(gamma_prev), atol):
                break_flag = True
                break

            iter_total += 1
            if iter_total >= max_iter:
                break_flag = True
                break

        if break_flag:
            break
    return x


def _where(pred: torch.Tensor, new: dict, old: dict) -> dict:
    return {k: torch.where(pred, new[k], old[k]) for k in new}


def cgls_damped_unrolled(matvec, matvec_T, dot, saxpy, dampmul, b, x0, damp,
                         max_iter: int, restart_iter: int, tol=1e-10,
                         check_divergence: bool = True):
    """``cgls_damped``'s recurrence unrolled, scalars on the device, the
    iterate frozen by a ``done`` flag (a diverged step is kept, and stops
    further iterations, as the reference does). ``x0`` is a parameter-space
    dict."""
    x = x0
    dev = next(iter(x0.values())).device
    done = torch.zeros((), dtype=torch.bool, device=dev)
    last_res = torch.full((), math.inf, dtype=torch.float32, device=dev)

    iters_left = max_iter
    while iters_left > 0:
        block = min(restart_iter, iters_left)
        r = saxpy(-1.0, matvec(x), b)               # restart
        s = saxpy(-1.0, dampmul(x), matvec_T(r))
        p = s
        gamma = dot(s, s)

        for _ in range(block):
            q = matvec(p)
            delta = dot(q, q) + dot(p, p, damp)
            step_ok = ~done & (delta >= 1e-20)
            alpha = torch.where(step_ok,
                                gamma / torch.clamp(delta, min=1e-30), 0.0)
            x_new = saxpy(alpha, p, x)
            r = saxpy(-alpha, q, r)
            s = saxpy(-1.0, dampmul(x_new), matvec_T(r))
            gamma_prev = gamma
            gamma_new = dot(s, s)
            p = saxpy(torch.where(
                step_ok, gamma_new / torch.clamp(gamma_prev, min=1e-30), 0.0),
                p, s)

            if check_divergence:
                cur_r = saxpy(-1.0, matvec(x_new), b)
                res = dot(cur_r, cur_r) + dot(x_new, x_new, damp)
                diverged = res > last_res
                last_res = torch.where(step_ok & ~diverged, res, last_res)
                done = done | (step_ok & diverged)

            x = _where(step_ok, x_new, x)
            gamma = torch.where(step_ok, gamma_new, gamma)
            done = done | (delta < 1e-20) | (gamma < tol * torch.sqrt(
                torch.clamp(gamma_prev, min=0.0)))
            iters_left -= 1
            if iters_left == 0:
                break
    return x
