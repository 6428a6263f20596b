"""K4: the fused 2D stencil apply of one block.

Counterpart of ``fluidgym_tpu/ops/stencil_pallas.py`` (TPU kernel
``_kernel_2d``, entry ``stencil_apply_pallas``):

    y = diag*x + off[0]*nbr(-x) + off[1]*nbr(+x) + off[2]*nbr(-y) + off[3]*nbr(+y)

where ``nbr_f`` shifts ``x`` inside the block and takes the halo layer on
the boundary (``solver/stencil.py domain_apply`` gathers the halos).

* ``set_stencil_kernel(enabled)`` / ``stencil_kernel_enabled()``: the
  switch ``domain_apply`` reads, off by default as in the JAX package
  (``set_pallas_stencil``, ``_MODE = False``).
* ``stencil_apply(diag, off, x, halos)`` is the wrapper, a
  ``torch.autograd.Function``: for CUDA tensors it launches the CUDA kernel
  (``csrc/stencil.cu`` ``fg_stencil2d_apply``) and adds one to
  ``stencil_apply.launches``; for CPU tensors it runs
  ``stencil_apply_plain``; any other device raises.  Its backward is the
  plain formula of the JAX package's custom VJP (``_bwd``), which is plain
  XLA there too.
* ``stencil_apply_plain`` is the plain PyTorch version, the concatenate
  formulation of ``_kernel_2d``, with a ``.calls`` counter.

``x`` is ``(ny, nx)`` or ``(k, ny, nx)``; the halos are ``(..., ny, 1)``
(-x, +x) and ``(..., 1, nx)`` (-y, +y) with the same leading ``k``;
``diag (ny, nx)`` and ``off (4, ny, nx)`` are shared by the ``k`` columns
(the written-out form of the JAX package's vmap over deflation columns).

The probe ``pallas_stencil_available`` is not a compute kernel; its
counterpart is ``device.resolve_device``.  Bound on the H100 and what the
design does about it: see the note at the top of ``csrc/stencil.cu``.
"""

from __future__ import annotations

import torch

from fluidgym_tpu_torch.ops import _build

__all__ = ["set_stencil_kernel", "stencil_kernel_enabled", "stencil_apply",
           "stencil_apply_plain"]

_ENABLED = False


def set_stencil_kernel(enabled: bool) -> None:
    """Route ``domain_apply``'s eligible 2D applies through K4 (True) or
    the roll formulation (False, the default)."""
    global _ENABLED
    _ENABLED = bool(enabled)


def stencil_kernel_enabled() -> bool:
    return _ENABLED


def _neighbours(x, halos):
    """The four face neighbours of ``x`` with the halos on the boundary."""
    hxm, hxp, hym, hyp = halos
    return (torch.cat([hxm, x[..., :, :-1]], dim=-1),
            torch.cat([x[..., :, 1:], hxp], dim=-1),
            torch.cat([hym, x[..., :-1, :]], dim=-2),
            torch.cat([x[..., 1:, :], hyp], dim=-2))


def stencil_apply_plain(diag, off, x, halos):
    """Plain PyTorch K4 (the concatenate formulation of ``_kernel_2d``)."""
    stencil_apply_plain.calls += 1
    nxm, nxp, nym, nyp = _neighbours(x, halos)
    return (diag * x + off[0] * nxm + off[1] * nxp + off[2] * nym
            + off[3] * nyp)


stencil_apply_plain.calls = 0


def _launch(diag, off, x, halos):
    ny, nx = x.shape[-2:]
    k = x.shape[0] if x.dim() == 3 else 1
    expect = ((ny, 1), (ny, 1), (1, nx), (1, nx))
    lead = tuple(x.shape[:-2])
    if (x.dim() not in (2, 3) or tuple(diag.shape) != (ny, nx)
            or tuple(off.shape) != (4, ny, nx)
            or any(tuple(h.shape) != lead + e for h, e in zip(halos, expect))):
        raise ValueError(
            "K4 takes diag (ny, nx), off (4, ny, nx), x ([k,] ny, nx) and "
            "halos ([k,] ny, 1) x2, ([k,] 1, nx) x2")
    for t in (diag, off, *halos):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"K4 operands must be float32 on {x.device}")
    if x.dtype != torch.float32:
        raise ValueError("K4 takes float32 tensors")
    diag, off, x = diag.contiguous(), off.contiguous(), x.contiguous()
    halos = tuple(h.contiguous() for h in halos)
    y = torch.empty_like(x)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.fg_stencil2d_apply(
            diag.data_ptr(), off.data_ptr(), x.data_ptr(),
            *[h.data_ptr() for h in halos], y.data_ptr(), k, ny, nx, stream)
    _build.check(status, "stencil_apply")
    return y


class _StencilApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, diag, off, x, hxm, hxp, hym, hyp):
        halos = (hxm, hxp, hym, hyp)
        ctx.save_for_backward(diag, off, x, *halos)
        if x.is_cuda:
            y = _launch(diag, off, x, halos)
            stencil_apply.launches += 1
            return y
        if x.device.type == "cpu":
            return stencil_apply_plain(diag, off, x, halos)
        raise ValueError(f"stencil_apply runs on CUDA or CPU tensors, not {x.device}")

    @staticmethod
    def backward(ctx, g):
        # cotangents of the bilinear map y = diag*x + sum_f off[f] * nbr_f
        # (the JAX package's _bwd), summed over the columns that share the
        # coefficients
        diag, off, x, *halos = ctx.saved_tensors
        nbrs = _neighbours(x, halos)
        col = tuple(range(x.dim() - 2))
        d_diag = (g * x).sum(dim=col) if col else g * x
        d_off = torch.stack([(g * nb).sum(dim=col) if col else g * nb
                             for nb in nbrs])
        t0, t1, t2, t3 = (off[f] * g for f in range(4))
        d_x = diag * g
        d_x[..., :, :-1] += t0[..., :, 1:]
        d_x[..., :, 1:] += t1[..., :, :-1]
        d_x[..., :-1, :] += t2[..., 1:, :]
        d_x[..., 1:, :] += t3[..., :-1, :]
        return (d_diag, d_off, d_x, t0[..., :, :1], t1[..., :, -1:],
                t2[..., :1, :], t3[..., -1:, :])


def stencil_apply(diag, off, x, halos):
    """K4: fused 2D stencil apply; ``halos = (h_xm, h_xp, h_ym, h_yp)``."""
    return _StencilApply.apply(diag, off, x, *halos)


stencil_apply.launches = 0
