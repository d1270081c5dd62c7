"""Kernel K1, the fused sum-of-products gram, and its autograd wrapper
(counterpart of ``waveome_tpu/pallas_ops/gram_pallas.py``).

``gram_cuda`` launches ``csrc/gram.cu`` on a flat batch of constrained
parameter sets; ``gram_forward`` broadcasts the batch dimensions and picks
the device's implementation: K1 for CUDA tensors, the plain PyTorch
``kernels.gram.gram_plain`` for CPU tensors. ``GramFn`` pairs that forward
with ``gram_vjp_analytic``, the plain PyTorch port of the reference's
hand-derived backward (prefix/suffix leave-one-out products and the
softplus chain), extended with the analytic ∂/∂X1 and ∂/∂X2 that the
trainable inducing points need. The reference's Pallas backward has no X
cotangent; JAX gets it by differentiating ``gram_xla``.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from ..bijectors import softplus_grad
from ..kernels import ops
from ..kernels.gram import constrain, gram_plain
from ..kernels.spec import KernelSpec
from . import _lib

# Launches of K1 since the last reset; chip_smoke.py resets and reads it to
# show that the fit went through the kernel.
launch_count = 0


@functools.lru_cache(maxsize=64)
def _structure(spec: KernelSpec, device: torch.device):
    """The spec's (C, F) op/dim/degree/order arrays on ``device``, made
    once per spec so that launches issue no host-to-device copies."""
    coded = spec.coded_np()
    return (
        torch.as_tensor(coded["ops"], dtype=torch.int32, device=device),
        torch.as_tensor(coded["dims"], dtype=torch.int32, device=device),
        torch.as_tensor(coded["degrees"], dtype=torch.float32, device=device),
        torch.as_tensor(coded["orders"], dtype=torch.int32, device=device),
    )


def gram_cuda(spec: KernelSpec, params: torch.Tensor, X1: torch.Tensor,
              X2: torch.Tensor, component_mask: Optional[torch.Tensor] = None,
              factor_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K1: ``params`` (P, C, F, 4) constrained; ``X1`` (N, D) shared
    or (P, N, D); ``X2`` (M, D) or (P, M, D); ``component_mask`` (P, C);
    ``factor_mask`` (P, C, F). All float32, contiguous, on one CUDA device.
    Returns K of shape (P, N, M)."""
    global launch_count
    device = params.device
    if device.type != "cuda":
        raise ValueError(f"gram_cuda needs CUDA tensors, got {device}")
    named = (("params", params), ("X1", X1), ("X2", X2),
             ("component_mask", component_mask), ("factor_mask", factor_mask))
    for name, t in named:
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"gram_cuda: {name} is on {t.device}, "
                             f"params on {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"gram_cuda takes float32 only; {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"gram_cuda: {name} is not contiguous")
    spec_p = spec.padded()
    C, F = spec_p.num_components, spec_p.max_factors
    if params.dim() != 4 or tuple(params.shape[1:]) != (C, F,
                                                        ops.N_PARAM_SLOTS):
        raise ValueError(f"gram_cuda: params shape {tuple(params.shape)}, "
                         f"expected (P, {C}, {F}, {ops.N_PARAM_SLOTS})")
    P = params.shape[0]
    for name, X in (("X1", X1), ("X2", X2)):
        if X.dim() not in (2, 3) or (X.dim() == 3 and X.shape[0] != P):
            raise ValueError(f"gram_cuda: {name} shape {tuple(X.shape)}, "
                             f"expected (rows, D) or ({P}, rows, D)")
    N, D = X1.shape[-2:]
    M = X2.shape[-2]
    if X2.shape[-1] != D:
        raise ValueError("gram_cuda: X1 and X2 have different widths")
    dims_np = spec.coded_np()["dims"]
    if dims_np.size and int(dims_np.max()) >= D:
        raise ValueError(f"gram_cuda: the spec reads column "
                         f"{int(dims_np.max())} of a {D}-column design")
    if component_mask is not None and tuple(component_mask.shape) != (P, C):
        raise ValueError(f"gram_cuda: component_mask shape "
                         f"{tuple(component_mask.shape)}, expected ({P}, {C})")
    if factor_mask is not None and tuple(factor_mask.shape) != (P, C, F):
        raise ValueError(f"gram_cuda: factor_mask shape "
                         f"{tuple(factor_mask.shape)}, expected "
                         f"({P}, {C}, {F})")
    out = torch.empty((P, N, M), dtype=torch.float32, device=device)
    if P == 0 or N == 0 or M == 0:
        return out
    ops_t, dims_t, deg_t, ord_t = _structure(spec, device)
    lib = _lib.library()
    with torch.cuda.device(device):
        rc = lib.waveome_gram_forward(
            X1.data_ptr(), N * D if X1.dim() == 3 else 0,
            X2.data_ptr(), M * D if X2.dim() == 3 else 0,
            params.data_ptr(), ops_t.data_ptr(), dims_t.data_ptr(),
            deg_t.data_ptr(), ord_t.data_ptr(),
            None if component_mask is None else component_mask.data_ptr(),
            None if factor_mask is None else factor_mask.data_ptr(),
            out.data_ptr(), P, N, M, D, C, F,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _lib.check(rc, "waveome_gram_forward")
    launch_count += 1
    return out


def _flat(t: Optional[torch.Tensor], batch, tail, P):
    if t is None:
        return None
    return t.expand(tuple(batch) + tuple(tail)).reshape(
        (P,) + tuple(tail)).contiguous()


def gram_forward(spec: KernelSpec, raw: torch.Tensor, X1: torch.Tensor,
                 X2: torch.Tensor, component_mask=None, factor_mask=None):
    """K(X1, X2) with broadcasting leading dimensions (see
    ``kernels.gram``): K1 for CUDA tensors, ``gram_plain`` for CPU ones."""
    if raw.device.type == "cpu":
        return gram_plain(spec, raw, X1, X2, component_mask, factor_mask)
    shapes = [raw.shape[:-3], X1.shape[:-2], X2.shape[:-2]]
    if component_mask is not None:
        component_mask = component_mask.to(raw.dtype)
        shapes.append(component_mask.shape[:-1])
    if factor_mask is not None:
        factor_mask = factor_mask.to(raw.dtype)
        shapes.append(factor_mask.shape[:-2])
    batch = torch.broadcast_shapes(*shapes)
    P = math.prod(batch)
    cfp = raw.shape[-3:]
    params = _flat(constrain(raw), batch, cfp, P)
    x1 = X1.contiguous() if X1.dim() == 2 else _flat(X1, batch,
                                                      X1.shape[-2:], P)
    x2 = X2.contiguous() if X2.dim() == 2 else _flat(X2, batch,
                                                      X2.shape[-2:], P)
    K = gram_cuda(spec, params, x1, x2,
                  _flat(component_mask, batch, cfp[:1], P),
                  _flat(factor_mask, batch, cfp[:2], P))
    return K.reshape(tuple(batch) + K.shape[-2:])


# ---------------------------------------------------------------------------
# analytic backward: hand-derived ∂⟨cot, K⟩/∂raw, /∂component_mask, /∂X
# ---------------------------------------------------------------------------

def _factor_tile_grads(prim, p, x1, x2):
    """(tile, {slot: ∂tile/∂p[slot]}) for one primitive, tiles (..., N, M);
    the formulas mirror kernels/ops.py with the same floor and clip. The
    arccosine has no hand-derived form in the reference; its slot
    gradients come from autograd on its tile (``None`` here)."""
    op = prim.op
    v = p[..., 0, None, None]
    if op == "arccosine":
        return ops.k_arccosine(p, x1, x2, order=prim.order), None
    if op in ("constant", "categorical", "linear", "polynomial"):
        if op == "constant":
            one = torch.ones_like(v * (x1[..., :, None] - x2[..., None, :]))
            return v * one, {0: one}
        if op == "categorical":
            eq = (torch.round(x1)[..., :, None]
                  == torch.round(x2)[..., None, :]).to(x1.dtype)
            return v * eq, {0: eq * torch.ones_like(v)}
        xx = x1[..., :, None] * x2[..., None, :]
        if op == "linear":
            return v * xx, {0: xx * torch.ones_like(v)}
        base = v * xx + p[..., 2, None, None]
        d = prim.degree
        dbase = d * base ** (d - 1)
        return base ** d, {0: dbase * xx, 2: dbase}
    d = x1[..., :, None] - x2[..., None, :]
    ls = torch.clamp(p[..., 1, None, None], min=1e-10)
    if op == "squared_exponential":
        u = torch.clamp(0.5 * (d * d) / (ls * ls), max=80.0)
        E = torch.exp(-u)
        t = v * E
        return t, {0: E, 1: torch.where(u < 80.0, t * (d * d) / ls ** 3, 0.0)}
    if op == "matern12":
        r = torch.clamp(torch.abs(d) / ls, max=80.0)
        E = torch.exp(-r)
        t = v * E
        return t, {0: E, 1: torch.where(r < 80.0, t * r / ls, 0.0)}
    if op == "matern32":
        r = math.sqrt(3.0) * torch.abs(d) / ls
        E = torch.exp(-torch.clamp(r, max=80.0))
        t = v * (1.0 + r) * E
        return t, {0: (1.0 + r) * E,
                   1: torch.where(r < 80.0, v * r * r * E / ls, 0.0)}
    if op == "matern52":
        r = math.sqrt(5.0) * torch.abs(d) / ls
        E = torch.exp(-torch.clamp(r, max=80.0))
        f = 1.0 + r + r * r / 3.0
        t = v * f * E
        dls = torch.where(r < 80.0, v * r * r * (1.0 + r) / (3.0 * ls) * E,
                          0.0)
        return t, {0: f * E, 1: dls}
    if op == "periodic":
        per = torch.clamp(p[..., 2, None, None], min=1e-10)
        ang = math.pi * d / per
        s = torch.sin(ang) / ls
        u = torch.clamp(2.0 * s * s, max=80.0)
        E = torch.exp(-u)
        t = v * E
        live = u < 80.0
        dls = torch.where(live, t * 4.0 * s * s / ls, 0.0)
        dper = torch.where(
            live, t * 4.0 * s * torch.cos(ang) * math.pi * d / (per * per * ls),
            0.0)
        return t, {0: E, 1: dls, 2: dper}
    if op == "rational_quadratic":
        a = p[..., 2, None, None]
        u = 1.0 + (d * d) / (2.0 * a * ls * ls)
        t = v * u ** (-a)
        dls = v * u ** (-a - 1.0) * (d * d) / ls ** 3
        da = t * (-torch.log(u)) + v * u ** (-a - 1.0) * (d * d) / (
            2.0 * a * ls * ls)
        return t, {0: u ** (-a), 1: dls, 2: da}
    raise NotImplementedError(f"analytic gram backward: op {op}")


def _factor_x_grads(prim, p, x1, x2, t):
    """(∂tile/∂x1, ∂tile/∂x2) of one primitive's tile ``t`` (..., N, M),
    elementwise; ``None`` for an op whose tile does not move with x
    (constant, and categorical, whose ``round`` has zero derivative as in
    JAX), and ∂/∂x2 ``None`` where it is −∂/∂x1 (the stationary ops, which
    depend on x1 − x2 only). Same floor and clip as kernels/ops.py: a
    clipped exponent has zero derivative."""
    op = prim.op
    if op in ("constant", "categorical"):
        return None, None
    v = p[..., 0, None, None]
    if op in ("linear", "polynomial"):
        scale = v
        if op == "polynomial":
            d = prim.degree
            scale = d * (v * x1[..., :, None] * x2[..., None, :]
                         + p[..., 2, None, None]) ** (d - 1) * v
        return scale * x2[..., None, :], scale * x1[..., :, None]
    d = x1[..., :, None] - x2[..., None, :]
    ls = torch.clamp(p[..., 1, None, None], min=1e-10)
    if op == "squared_exponential":
        live = 0.5 * (d * d) / (ls * ls) < 80.0
        return torch.where(live, -t * d / (ls * ls), 0.0), None
    if op == "matern12":
        live = torch.abs(d) / ls < 80.0
        return torch.where(live, -t * torch.sign(d) / ls, 0.0), None
    if op in ("matern32", "matern52"):
        c = math.sqrt(3.0) if op == "matern32" else math.sqrt(5.0)
        r = c * torch.abs(d) / ls
        E = torch.exp(-torch.clamp(r, max=80.0))
        live = (r < 80.0).to(d.dtype)
        if op == "matern32":  # t = v (1 + r) E
            dt_dr = v * E * (1.0 - (1.0 + r) * live)
        else:  # t = v (1 + r + r²/3) E
            dt_dr = v * E * (1.0 + 2.0 * r / 3.0
                             - (1.0 + r + r * r / 3.0) * live)
        return dt_dr * c * torch.sign(d) / ls, None
    if op == "periodic":
        per = torch.clamp(p[..., 2, None, None], min=1e-10)
        ang = math.pi * d / per
        s = torch.sin(ang) / ls
        live = 2.0 * s * s < 80.0
        return torch.where(
            live, -t * 4.0 * s * torch.cos(ang) * math.pi / (per * ls),
            0.0), None
    if op == "rational_quadratic":
        a = p[..., 2, None, None]
        u = 1.0 + (d * d) / (2.0 * a * ls * ls)
        return -v * u ** (-a - 1.0) * d / (ls * ls), None
    raise NotImplementedError(f"analytic gram backward: op {op}")


def gram_vjp_analytic(spec: KernelSpec, raw, X1, X2, component_mask,
                      factor_mask, cot, need_x: bool = False):
    """(∂⟨cot, K⟩/∂raw, ∂⟨cot, K⟩/∂component_mask or None, ∂/∂X1, ∂/∂X2),
    all over the batch shape of ``cot``; callers reduce broadcast
    dimensions. The X cotangents are None unless ``need_x``."""
    batch = cot.shape[:-2]
    params = constrain(raw).expand(tuple(batch) + raw.shape[-3:])
    active = spec.active_factor_mask()
    kw = dict(dtype=raw.dtype, device=raw.device)
    draw = torch.zeros(tuple(batch) + raw.shape[-3:], **kw)
    dmask = [] if component_mask is not None else None
    dX1 = dX2 = None
    if need_x:
        dX1 = torch.zeros(tuple(batch) + X1.shape[-2:], **kw)
        dX2 = torch.zeros(tuple(batch) + X2.shape[-2:], **kw)
    for i, comp in enumerate(spec.padded().components):
        tiles, grads, idxs = [], [], []
        keep = {}
        for j, prim in enumerate(comp):
            if prim.op == "empty":
                continue
            x1, x2 = X1[..., prim.dim], X2[..., prim.dim]
            t, dt = _factor_tile_grads(prim, params[..., i, j, :], x1, x2)
            if factor_mask is not None:
                keep[j] = factor_mask[..., i, j, None, None] > 0
                t = torch.where(keep[j], t, 1.0)
                if dt is not None:
                    dt = {s: torch.where(keep[j], g, 0.0)
                          for s, g in dt.items()}
            tiles.append(t)
            grads.append(dt)
            idxs.append(j)
        if not tiles:
            if dmask is not None:
                dmask.append(torch.zeros(batch, **kw))
            continue
        F = len(tiles)
        prefix, suffix = [None] * F, [None] * F
        acc = None
        for f in range(F):
            prefix[f] = acc
            acc = tiles[f] if acc is None else acc * tiles[f]
        full = acc
        acc = None
        for f in range(F - 1, -1, -1):
            suffix[f] = acc
            acc = tiles[f] if acc is None else tiles[f] * acc
        scale = None
        if component_mask is not None:
            scale = component_mask[..., i, None, None].to(raw.dtype)
        fscale = None
        if factor_mask is not None:
            fscale = torch.amax(
                factor_mask[..., i, :] * torch.as_tensor(
                    active[i], **kw), dim=-1)[..., None, None]
            scale = fscale if scale is None else scale * fscale
        Gm = cot if scale is None else cot * scale
        for f in range(F):
            loo = prefix[f]
            if suffix[f] is not None:
                loo = suffix[f] if loo is None else loo * suffix[f]
            w = Gm if loo is None else Gm * loo
            j = idxs[f]
            prim = comp[j]
            if grads[f] is None:  # arccosine: autograd on its own tile
                with torch.enable_grad():
                    pp = params[..., i, j, :].detach().requires_grad_(True)
                    xs = [X[..., prim.dim].expand(
                        tuple(batch) + X.shape[-2:-1]).detach()
                        .requires_grad_(need_x) for X in (X1, X2)]
                    tt = ops.k_arccosine(pp, *xs, order=prim.order)
                    if factor_mask is not None:
                        tt = torch.where(keep[j], tt, 1.0)
                    wrt = [pp, *xs] if need_x else [pp]
                    g = torch.autograd.grad((w * tt).sum(), wrt)
                draw[..., i, j, :] = g[0]
                if need_x:
                    dX1[..., prim.dim] += g[1]
                    dX2[..., prim.dim] += g[2]
                continue
            for slot, dt in grads[f].items():
                draw[..., i, j, slot] = torch.sum(w * dt, dim=(-2, -1))
            if not need_x:
                continue
            g1, g2 = _factor_x_grads(prim, params[..., i, j, :],
                                     X1[..., prim.dim], X2[..., prim.dim],
                                     tiles[f])
            if g1 is None:
                continue
            if factor_mask is not None:
                g1 = torch.where(keep[j], g1, 0.0)
                g2 = None if g2 is None else torch.where(keep[j], g2, 0.0)
            wg1 = w * g1
            dX1[..., prim.dim] += wg1.sum(-1)
            dX2[..., prim.dim] += (-wg1.sum(-2) if g2 is None
                                   else (w * g2).sum(-2))
        if dmask is not None:
            full_scaled = full if fscale is None else full * fscale
            dmask.append(torch.sum(cot * full_scaled, dim=(-2, -1)))
    draw = draw * softplus_grad(raw)
    if dmask is not None:
        dmask = torch.stack(dmask, dim=-1)
    return draw, dmask, dX1, dX2


class GramFn(torch.autograd.Function):
    """Differentiable gram: forward ``gram_forward`` (K1 on CUDA), backward
    ``gram_vjp_analytic`` (plain torch). Gradients flow to ``raw``,
    ``component_mask``, ``X1`` and ``X2`` (the inducing points Z train
    through Kuu = K(Z, Z) and Kuf = K(Z, X)); ``factor_mask`` must not
    require gradients."""

    @staticmethod
    def forward(ctx, spec, raw, X1, X2, component_mask, factor_mask):
        if ctx.needs_input_grad[5]:
            raise ValueError("GramFn computes no gradient for factor_mask")
        ctx.spec = spec
        ctx.save_for_backward(raw, X1, X2, component_mask, factor_mask)
        return gram_forward(spec, raw, X1, X2, component_mask, factor_mask)

    @staticmethod
    def backward(ctx, cot):
        raw, X1, X2, cm, fm = ctx.saved_tensors
        need = ctx.needs_input_grad
        draw, dmask, dX1, dX2 = gram_vjp_analytic(
            ctx.spec, raw, X1, X2, cm, fm, cot, need_x=need[2] or need[3])
        draw = draw.sum_to_size(raw.shape) if need[1] else None
        dmask = dmask.sum_to_size(cm.shape) if need[4] else None
        dX1 = dX1.sum_to_size(X1.shape) if need[2] else None
        dX2 = dX2.sum_to_size(X2.shape) if need[3] else None
        return None, draw, dX1, dX2, dmask, None
