"""``wkv6`` on the model's (B, S, H, hd) tensors — the port of
``repro.kernels.rwkv6.ops``.

On the card K11 reads the model's layout through its strides (no folding
transposes) and writes y in it; on the CPU ``wkv6_plain`` folds the inputs
to (B·H, S, hd) for the plain version, as JAX's wrapper folds them.

Under autograd on the card (rwkv6 backprop in chunk mode) ``ChunkedWKV``
keeps the forward on K11 and takes the gradient of the plain chunk form,
recomputed: JAX's chunk mode is a jnp graph that JAX differentiates, and
JAX has no backward kernel for K11."""
from __future__ import annotations

import functools

import torch

from repro_torch.analysis import costs
from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6 import kernel as _k


class ChunkedWKV(torch.autograd.Function):
    """K11 under autograd: ``apply(fwd, plain, r, k, v, lw, u, s0)``.

    The forward is ``fwd`` — K11's launch, counted under its route as any
    launch.  The backward is the vector–Jacobian product of ``plain``, the
    same function in plain torch, recomputed from the saved inputs under
    ``torch.enable_grad()``: ``torch.autograd.grad`` of (y, s_final) with
    (dy, ds_final), either of which may be None.  It returns dr, dk, dv,
    dlw, du and ds0 in the inputs' dtypes (a u shared by the batch gets its
    gradient summed over it, as autograd sums an expand) and is recorded
    as ``wkv6_chunked_backward``, apart from K11's launches."""

    @staticmethod
    def forward(ctx, fwd, plain, r, k, v, lw, u, s0):
        ctx.set_materialize_grads(False)
        ctx.plain = plain
        ctx.save_for_backward(r, k, v, lw, u, s0)
        return fwd(r, k, v, lw, u, s0)

    @staticmethod
    def backward(ctx, dy, ds_final):
        _build.record("wkv6_chunked_backward")
        saved = ctx.saved_tensors
        want = ctx.needs_input_grad[2:]
        cots = [(i, g) for i, g in enumerate((dy, ds_final)) if g is not None]
        grads = [None] * len(saved)
        if cots and any(want):
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(w)
                       for t, w in zip(saved, want)]
                outs = ctx.plain(*ins)
                wrt = [i for i, w in enumerate(want) if w]
                got = torch.autograd.grad(
                    [outs[i] for i, _ in cots], [ins[i] for i in wrt],
                    [g for _, g in cots], allow_unused=True)
            for i, g in zip(wrt, got):
                grads[i] = (torch.zeros_like(saved[i]) if g is None
                            else g.to(saved[i].dtype))
        return (None, None, *grads)


def _launch(r, k, v, lw, u, s0, *, chunk: int):
    f32 = torch.float32
    u = u.to(f32)
    return _k.launch(*(t.to(f32) for t in (r, k, v, lw)), u, (0, u.stride(0)),
                     s0.to(f32).contiguous(), chunk)


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
               chunk: int = 16):
    """The plain K11 on the model's layout (any device), f32."""
    B, S, H, hd = r.shape

    def fold(x):
        return x.transpose(1, 2).reshape(B * H, S, hd).to(torch.float32)

    u_b = u[None].expand(B, H, hd).reshape(B * H, 1, hd).to(torch.float32)
    y, s_final = _k.wkv6_chunked_plain(
        fold(r), fold(k), fold(v), fold(lw), u_b,
        s0.reshape(B * H, hd, hd).to(torch.float32), chunk=chunk)
    return (y.reshape(B, H, S, hd).transpose(1, 2),
            s_final.reshape(B, H, hd, hd))


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lw: torch.Tensor,
         u: torch.Tensor, s0: torch.Tensor, *, chunk: int = 16):
    """r/k/v/lw (B,S,H,hd); u (H,hd); s0 (B,H,hd,hd)
    -> (y (B,S,H,hd), s_final (B,H,hd,hd)), f32.  On the card K11, through
    ``ChunkedWKV`` (differentiable); on ``meta`` tensors the shape rule."""
    if costs.active():
        costs.charge("wkv6_chunked", costs.wkv6_chunked(
            *_build.local(r).shape, chunk))
    if _build.on_meta(r):
        B, S, H, hd = r.shape
        return (r.new_empty((B, S, H, hd), dtype=torch.float32),
                s0.new_empty((B, H, hd, hd), dtype=torch.float32))
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, lw, u, s0, chunk=chunk)
    if r.device.type != "cuda":
        raise RuntimeError(f"wkv6: no kernel for device {r.device}")
    return wkv6_on_card(r, k, v, lw, u, s0, chunk=chunk)


def wkv6_on_card(r, k, v, lw, u, s0, *, chunk: int = 16):
    """What ``wkv6`` runs for CUDA tensors: K11 (``kernel.launch``) inside
    ``ChunkedWKV``, whose backward is the VJP of ``wkv6_plain``."""
    return ChunkedWKV.apply(functools.partial(_launch, chunk=chunk),
                            functools.partial(wkv6_plain, chunk=chunk),
                            r, k, v, lw, u, s0)
