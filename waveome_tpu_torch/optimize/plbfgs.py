"""L-BFGS with a parallel fixed-grid line search, over an explicit
outcome-batch dimension (counterpart of ``waveome_tpu/optimize/plbfgs.py``).

The reference vmaps one ``while_loop`` per outcome; here every row of a
(B, d) batch carries its own state and an ``active`` flag. Each iteration
computes the step for all rows and keeps it only where the row was still
active, so a finished row never moves and each row's iteration count and
trajectory are the ones it would have alone. The host reads nothing back
inside ``plbfgs_fit``'s loop: a call runs a fixed number of iterations
(its segment), and the caller compacts finished rows between calls.

Per iteration: one batched evaluation of the four trial steps
[2, 1, 0.4, 0.08] × the previous step (T·B parameter sets at once) and one
gradient — the per-outcome gradients of one backward pass of ``loss.sum()``,
since the outcomes are independent.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

# the reference's trial grid relative to the previous accepted step
TRIALS = (2.0, 1.0, 0.4, 0.08)
HISTORY = 10  # curvature pairs kept
ARMIJO_C1 = 1e-4
PATIENCE = 8  # stalled iterations that stop a row


class PLBFGSState(NamedTuple):
    x: torch.Tensor  # (B, d) free entries
    f_val: torch.Tensor  # (B,)
    g: torch.Tensor  # (B, d)
    s_hist: torch.Tensor  # (B, m, d)
    y_hist: torch.Tensor  # (B, m, d)
    rho: torch.Tensor  # (B, m)
    count: torch.Tensor  # (B,) int64
    stepsize: torch.Tensor  # (B,)
    n_pairs: torch.Tensor  # (B,) int64
    stall: torch.Tensor  # (B,) int64: iterations without rel. gain > ftol
    it: torch.Tensor  # (B,) int64: iterations taken
    x0: torch.Tensor  # (B, d) the start point
    f0: torch.Tensor  # (B,) the loss at the start point

    def take(self, idx: torch.Tensor) -> "PLBFGSState":
        """The rows ``idx`` of every field (batch compaction)."""
        return PLBFGSState(*(t[idx] for t in self))


class PLBFGSResult(NamedTuple):
    params: dict
    loss: torch.Tensor
    num_iters: torch.Tensor
    converged: torch.Tensor


class FreeLayout:
    """Where the free entries of a parameter dict sit in the flat vector.

    Leaves are taken in sorted key order (``ravel_pytree``'s order for a
    dict), each flattened row-major; the free vector is the masked entries
    in that order, so it lines up entry for entry with the reference's."""

    def __init__(self, mask: dict):
        self.keys = sorted(mask)
        self.idx = {}
        self.shapes = {}
        self.offsets = {}
        off = 0
        for k in self.keys:
            m = np.asarray(mask[k], dtype=bool)
            self.shapes[k] = m.shape
            nz = np.nonzero(m.reshape(-1))[0]
            if nz.size:
                self.idx[k] = nz
                self.offsets[k] = (off, off + nz.size)
                off += nz.size
        self.size = off

    def gather(self, params: dict) -> torch.Tensor:
        """(B, d) free entries of batched params (leaves (B, *shape))."""
        parts = []
        for k in self.keys:
            if k in self.idx:
                leaf = params[k]
                flat = leaf.reshape(leaf.shape[0], -1)
                parts.append(flat[:, torch.as_tensor(self.idx[k],
                                                     device=leaf.device)])
        return torch.cat(parts, dim=-1)

    def merge(self, params0: dict, x: torch.Tensor) -> dict:
        """params0 (leaves (B, *shape)) with the free entries replaced by x
        (..., B, d); leaves without free entries pass through unchanged
        and broadcast against the others' leading dimensions."""
        out = dict(params0)
        lead = x.shape[:-1]
        for k, (lo, hi) in self.offsets.items():
            leaf0 = params0[k]
            flat = leaf0.reshape(leaf0.shape[0], -1).expand(
                lead + (int(np.prod(self.shapes[k], dtype=np.int64)),))
            flat = flat.clone()
            flat[..., torch.as_tensor(self.idx[k], device=x.device)] = (
                x[..., lo:hi])
            out[k] = flat.reshape(lead + self.shapes[k])
        return out


def _rows(t, idx):
    """t[b, idx[b]] for a (B, m, ...) tensor and (B,) indices."""
    return t[torch.arange(t.shape[0], device=t.device), idx]


def _two_loop(g, s_hist, y_hist, rho, n_pairs, count):
    """The L-BFGS two-loop recursion over each row's circular history."""
    m = s_hist.shape[1]
    q = g
    alphas = torch.zeros_like(rho)
    ar = torch.arange(g.shape[0], device=g.device)
    for i in range(m):
        idx = (count - 1 - i) % m
        valid = i < n_pairs
        alpha = _rows(rho, idx) * torch.sum(_rows(s_hist, idx) * q, dim=-1)
        alpha = torch.where(valid, alpha, 0.0)
        q = q - alpha[:, None] * _rows(y_hist, idx) * valid[:, None]
        alphas = alphas.index_put((ar, idx), alpha)
    newest = (count - 1) % m
    s_new, y_new = _rows(s_hist, newest), _rows(y_hist, newest)
    gamma = torch.where(
        n_pairs > 0,
        torch.sum(s_new * y_new, dim=-1)
        / torch.clamp(torch.sum(y_new * y_new, dim=-1), min=1e-30),
        1.0)
    r = gamma[:, None] * q
    for i in range(m):
        idx = (count - n_pairs + i) % m
        valid = i < n_pairs
        beta = _rows(rho, idx) * torch.sum(_rows(y_hist, idx) * r, dim=-1)
        r = r + ((_rows(alphas, idx) - beta)[:, None] * _rows(s_hist, idx)
                 * valid[:, None])
    return -r


def plbfgs_fit(
    loss_fn: Callable[[dict], torch.Tensor],
    params0: dict,
    mask: dict,
    max_iter: int,
    tol: float = 3e-5,
    carry: Optional[PLBFGSState] = None,
    ftol: float = 1e-6,
    trial_loss_fn: Optional[Callable[[dict], torch.Tensor]] = None,
    trial_sequential: bool = False,
):
    """Minimize ``loss_fn`` over the free entries of every row.

    ``params0``: dict of tensors with a leading batch dimension B (expanded
    views are fine). ``mask``: dict of numpy bool arrays of the per-row
    leaf shapes (the free entries). ``loss_fn(params)`` maps params whose
    free leaves have leading dimensions (..., B) to losses (..., B).

    ``max_iter`` bounds each row's cumulative iteration count, so a
    segmented caller passes the state back as ``carry`` with a larger
    bound. Returns ``(PLBFGSResult, PLBFGSState)``.

    Convergence per row: gradient norm < ``tol``, or no relative
    improvement > ``ftol`` for PATIENCE iterations. A row whose final loss
    is not finite returns its start parameters and start loss.

    ``trial_loss_fn``: evaluates the line-search trials instead of
    ``loss_fn`` (never differentiated); the gradient always comes from
    ``loss_fn``. ``trial_sequential``: evaluate the trials one at a time
    instead of as one (T, B) batch: the same values with a quarter of the
    trial batch's live memory.
    """
    layout = FreeLayout(mask)
    x_start = layout.gather(params0).detach()
    dtype, device = x_start.dtype, x_start.device
    big = torch.tensor(1e15, dtype=dtype, device=device)
    trials = torch.tensor(TRIALS, dtype=dtype, device=device)

    def make_f(fn):
        def f(x):
            v = fn(layout.merge(params0, x))
            return torch.where(torch.isfinite(v), v, big)
        return f

    f = make_f(loss_fn)
    f_trial = f if trial_loss_fn is None else make_f(trial_loss_fn)

    def value_and_grad(x):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            v = f(xg)
            (g,) = torch.autograd.grad(v.sum(), xg)
        return v.detach(), g

    if carry is None:
        B, d = x_start.shape
        f0, g0 = value_and_grad(x_start)
        zi = torch.zeros(B, dtype=torch.int64, device=device)
        state = PLBFGSState(
            x=x_start, f_val=f0, g=g0,
            s_hist=torch.zeros((B, HISTORY, d), dtype=dtype, device=device),
            y_hist=torch.zeros((B, HISTORY, d), dtype=dtype, device=device),
            rho=torch.zeros((B, HISTORY), dtype=dtype, device=device),
            count=zi, stepsize=torch.ones(B, dtype=dtype, device=device),
            n_pairs=zi, stall=zi, it=zi, x0=x_start, f0=f0,
        )
    else:
        state = carry

    def active_rows(st):
        gnorm = torch.linalg.vector_norm(st.g, dim=-1)
        return (st.it < max_iter) & (gnorm >= tol) & (st.stall < PATIENCE)

    def step(st):
        direction = _two_loop(st.g, st.s_hist, st.y_hist, st.rho,
                              st.n_pairs, st.count)
        # keep the first step conservative if the gradient is huge
        dir_norm = torch.linalg.vector_norm(direction, dim=-1)
        direction = direction * torch.clamp(
            1e3 / torch.clamp(dir_norm, min=1e-30), max=1.0)[:, None]
        slope = torch.sum(st.g * direction, dim=-1)

        steps = trials[:, None] * st.stepsize[None, :]  # (T, B)
        with torch.no_grad():
            xs = st.x[None] + steps[..., None] * direction[None]
            fs = (torch.stack([f_trial(x) for x in xs]) if trial_sequential
                  else f_trial(xs))
        armijo = fs <= st.f_val[None] + ARMIJO_C1 * steps * slope[None]
        any_ok = torch.any(armijo, dim=0)
        fs_sel = torch.where(any_ok[None], torch.where(armijo, fs, big), fs)
        j = torch.argmin(fs_sel, dim=0)[None]
        t = torch.gather(steps, 0, j)[0]
        f_new = torch.gather(fs, 0, j)[0]

        improved = f_new < st.f_val
        t = torch.where(improved, t, 0.0)
        f_new = torch.where(improved, f_new, st.f_val)
        x_new = st.x + t[:, None] * direction
        _, g_all = value_and_grad(x_new)
        g_new = torch.where(improved[:, None], g_all, st.g)

        s = x_new - st.x
        y = g_new - st.g
        sy = torch.sum(s * y, dim=-1)
        good = improved & (sy > 1e-12)
        slot = st.count % HISTORY
        put = good[:, None] & (torch.arange(HISTORY, device=device)[None]
                               == slot[:, None])
        s_hist = torch.where(put[..., None], s[:, None, :], st.s_hist)
        y_hist = torch.where(put[..., None], y[:, None, :], st.y_hist)
        rho = torch.where(put, (1.0 / torch.clamp(sy, min=1e-30))[:, None],
                          st.rho)
        n_pairs = torch.where(good, torch.clamp(st.n_pairs + 1, max=HISTORY),
                              st.n_pairs)
        count = torch.where(good, st.count + 1, st.count)

        # next base stepsize: the accepted step (shrink hard on failure)
        new_step = torch.where(improved, torch.clamp(t, min=1e-8),
                               st.stepsize * 0.1)
        new_step = torch.clamp(new_step, 1e-8, 1e4)
        rel_improve = (st.f_val - f_new) / torch.clamp(torch.abs(st.f_val),
                                                       min=1.0)
        stall = torch.where(rel_improve > ftol, 0, st.stall + 1)
        return st._replace(x=x_new, f_val=f_new, g=g_new, s_hist=s_hist,
                           y_hist=y_hist, rho=rho, count=count,
                           stepsize=new_step, n_pairs=n_pairs, stall=stall)

    # the one host read of the call: how many iterations this segment runs.
    # A row that is inactive now never moves again, so it adds none (a row
    # stopped by a non-finite gradient is neither converged nor running).
    left = torch.where(active_rows(state), max_iter - state.it, 0)
    n_steps = int(left.max()) if left.numel() else 0
    for _ in range(n_steps):
        active = active_rows(state)
        new = step(state)
        state = PLBFGSState(*(
            torch.where(active.reshape((-1,) + (1,) * (a.dim() - 1)), b, a)
            for a, b in zip(state, new)))
        state = state._replace(it=state.it + active.to(state.it.dtype))

    bad = ~torch.isfinite(state.f_val) | (state.f_val >= big)
    x_out = torch.where(bad[:, None], state.x0, state.x)
    converged = ((torch.linalg.vector_norm(state.g, dim=-1) < tol)
                 | (state.stall >= PATIENCE)) & ~bad
    with torch.no_grad():
        params = layout.merge(params0, x_out)
    result = PLBFGSResult(
        params=params,
        loss=torch.where(bad, state.f0, state.f_val),
        num_iters=state.it,
        converged=converged,
    )
    return result, state
