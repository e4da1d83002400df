"""Soft-silhouette coverage: the CUDA kernels K2 (forward) and K3 (its VJP),
their plain versions, and the autograd Function that pairs them.

Counterpart of ``chore_tpu/ops/pallas/silhouette.py``. For each pixel
centre p and face f, with 1/sigma-scaled coefficients from
:func:`edge_coeffs`:

  d_e(p) = A_e px + B_e py + C_e          (e = 0, 1, 2: the three edges)
  d_box(p) = min(pxs - xmin, xmax - pxs, pys - ymin, ymax - pys)
  dmin = min(d_0, d_1, d_2, d_box)
  coverage(p) = sum_f [dmin > -COVERAGE_CUTOFF] sigmoid(dmin)

and the VJP routes ds = [dmin > -CUTOFF] g s (1 - s) to the first
minimizing edge (edges win a tie against the box): dA += ds px,
dB += ds py, dC += ds; else to the box term that attains the box min,
with signs (-, +, -, +) on rows 3..6 of block 0. Invalid faces
(degenerate, behind the camera) carry C = -1e9, A = B = 0: zero coverage
and zero gradient.

``coverage_sums`` launches ``csrc/silhouette.cu`` for CUDA tensors (or
raises) and runs the plain versions for CPU tensors only. The batch is a
dimension of the kernels' grid (the JAX package ``vmap``s over it).
"""
from __future__ import annotations

import ctypes

import torch

# Coverage support cutoff in sigma units: a face contributes exactly zero
# coverage to pixels farther than CUTOFF * sigma outside it, so far-field
# sigmoid tails do not accumulate over thousands of faces.
COVERAGE_CUTOFF = 16.0
INVALID_C = -1e9
# faces per step of the plain versions: bounds their (B, P, tile) buffers
FACE_TILE = 512

# kernel launches, counted where a kernel is launched and nowhere else
launches = {"coverage_fwd": 0, "coverage_bwd": 0}


def edge_coeffs(verts_ndc, faces, sigma):
    """Differentiable per-face coefficients.

    verts_ndc: (B, V, 3) projected vertices; faces: (F, 3) integer tensor.
    Returns (B, 3, 8, F): rows 0..2 of each edge block are A, B, C of
    d_e(p) = A px + B py + C, scaled by 1/sigma and orientation-normalized;
    block 0 rows 3..6 hold the face's AABB [xmin, xmax, ymin, ymax] / sigma.
    Degenerate or behind-camera faces carry C = -1e9, A = B = 0.
    ``amin``/``amax`` split the box gradient evenly between tied vertices,
    as ``jnp.min``/``jnp.max`` do.
    """
    tri = verts_ndc[:, faces.long()]  # (B, F, 3, 3)
    xy = tri[..., :2]
    a, b, c = xy[:, :, 0], xy[:, :, 1], xy[:, :, 2]  # (B, F, 2)

    area2 = ((b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1])
             - (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0]))
    sign = torch.where(area2 > 0, 1.0, -1.0).to(xy.dtype)
    ok = (area2.abs() >= 1e-12) & (tri[..., 2] > 0.0).all(-1)

    def edge(p0, p1):
        d = p1 - p0  # (B, F, 2)
        ln = torch.sqrt((d * d).sum(-1) + 1e-12)
        s = sign / (ln * sigma)
        A = -d[..., 1] * s
        B = d[..., 0] * s
        C = (d[..., 1] * p0[..., 0] - d[..., 0] * p0[..., 1]) * s
        C = torch.where(ok, C, INVALID_C)
        A = torch.where(ok, A, 0.0)
        B = torch.where(ok, B, 0.0)
        return torch.stack([A, B, C], dim=1)  # (B, 3, F)

    inv_sigma = 1.0 / sigma
    box = torch.stack([
        xy[..., 0].amin(-1), xy[..., 0].amax(-1),
        xy[..., 1].amin(-1), xy[..., 1].amax(-1),
    ], dim=1) * inv_sigma  # (B, 4, F)
    zero = torch.zeros_like(box[:, :1])
    blocks = [torch.cat([edge(a, b), box, zero], dim=1),
              torch.cat([edge(b, c), zero.expand(-1, 5, -1)], dim=1),
              torch.cat([edge(c, a), zero.expand(-1, 5, -1)], dim=1)]
    return torch.stack(blocks, dim=1)  # (B, 3, 8, F)


# --------------------------------------------------------------------- #
# plain versions
def pixel_coords(image_size, inv_sigma, device):
    """f32 (px, py, px/sigma, py/sigma), each (P,), of the row-major NDC
    pixel centres (2i+1)/S - 1: computed in float64 and rounded once, as
    the kernels and the TPU kernel's pixel table compute them."""
    c = ((2.0 * torch.arange(image_size, dtype=torch.float64, device=device)
          + 1.0) / image_size - 1.0)
    gy, gx = torch.meshgrid(c, c, indexing="ij")
    gx, gy = gx.reshape(-1), gy.reshape(-1)
    return (gx.float(), gy.float(), (gx * inv_sigma).float(),
            (gy * inv_sigma).float())


def _wmin(a, b):
    """Elementwise min whose tie goes to ``a`` (first-minimizer routing)."""
    return torch.where(a <= b, a, b)


def _tile_terms(e, pix, sl):
    """(B, P, T) edge distances d0, d1, d2 and box terms t0..t3 of the face
    slice ``sl``; each d_e as px*A + py*B + C rounded op by op, the order
    the kernels keep."""
    px, py, pxs, pys = (v[None, :, None] for v in pix)
    d = [px * e[:, k, 0, None, sl] + py * e[:, k, 1, None, sl]
         + e[:, k, 2, None, sl] for k in range(3)]
    t = [pxs - e[:, 0, 3, None, sl], e[:, 0, 4, None, sl] - pxs,
         pys - e[:, 0, 5, None, sl], e[:, 0, 6, None, sl] - pys]
    return d, t


def _dmin(d, t):
    dedge = _wmin(_wmin(d[0], d[1]), d[2])
    dbox = _wmin(_wmin(t[0], t[1]), _wmin(t[2], t[3]))
    return dedge, dbox, torch.where(dbox < dedge, dbox, dedge)


def coverage_sums_plain(e, image_size, inv_sigma):
    """Plain PyTorch version of K2: e (B, 3, 8, F) -> (B, P) raw coverage
    sums, faces in tiles of ``FACE_TILE``. Differentiable: its autograd
    routes the gradient as K3 does."""
    B, F = e.shape[0], e.shape[-1]
    pix = pixel_coords(image_size, inv_sigma, e.device)
    out = torch.zeros((B, image_size * image_size), dtype=e.dtype,
                      device=e.device)
    for f0 in range(0, F, FACE_TILE):
        d, t = _tile_terms(e, pix, slice(f0, f0 + FACE_TILE))
        dmin = _dmin(d, t)[2]
        cov = torch.where(dmin > -COVERAGE_CUTOFF, torch.sigmoid(dmin), 0.0)
        out = out + cov.sum(-1)
    return out


def coverage_sums_bwd_plain(e, g, image_size, inv_sigma):
    """Plain PyTorch version of K3: e (B, 3, 8, F), g (B, P) upstream
    gradient -> (B, 3, 8, F) coefficient gradient, faces in tiles."""
    pix = pixel_coords(image_size, inv_sigma, e.device)
    px, py = pix[0][None, :, None], pix[1][None, :, None]
    gg = g[:, :, None]
    de = torch.zeros_like(e)
    for f0 in range(0, e.shape[-1], FACE_TILE):
        sl = slice(f0, f0 + FACE_TILE)
        d, t = _tile_terms(e, pix, sl)
        dedge, dbox, dmin = _dmin(d, t)
        s = torch.sigmoid(dmin)
        ds = torch.where(dmin > -COVERAGE_CUTOFF, gg * s * (1.0 - s), 0.0)
        mbox = dbox < dedge
        m0 = ~mbox & (d[0] <= d[1]) & (d[0] <= d[2])
        m1 = ~mbox & ~m0 & (d[1] <= d[2])
        m2 = ~mbox & ~(m0 | m1)
        for k, m in enumerate((m0, m1, m2)):
            w = torch.where(m, ds, 0.0)
            de[:, k, 0, sl] = (w * px).sum(1)
            de[:, k, 1, sl] = (w * py).sum(1)
            de[:, k, 2, sl] = w.sum(1)
        n0 = (t[0] <= t[1]) & (t[0] <= t[2]) & (t[0] <= t[3])
        n1 = ~n0 & (t[1] <= t[2]) & (t[1] <= t[3])
        n2 = ~(n0 | n1) & (t[2] <= t[3])
        n3 = ~(n0 | n1 | n2)
        for row, n, sgn in ((3, n0, -1.0), (4, n1, 1.0), (5, n2, -1.0),
                            (6, n3, 1.0)):
            de[:, 0, row, sl] = sgn * torch.where(mbox & n, ds, 0.0).sum(1)
    return de


# --------------------------------------------------------------------- #
# the kernels
def _lib():
    """The kernels' library (built at first use), entry points typed once."""
    from chore_tpu_torch.ops.cuda_build import load

    lib = load("silhouette")
    if lib.coverage_fwd_launch.argtypes is None:  # untyped: 32-bit ints
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.coverage_fwd_launch.argtypes = [ptr, ptr, i32, i32, i32,
                                            ctypes.c_double, ptr]
        lib.coverage_fwd_launch.restype = i32
        lib.coverage_bwd_launch.argtypes = [ptr, ptr, ptr, i32, i32, i32,
                                            ctypes.c_double, ptr]
        lib.coverage_bwd_launch.restype = i32
    return lib


def _check(name, t, shape):
    if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous f32 CUDA tensor, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")


def coverage_sums_cuda(e, image_size, inv_sigma):
    """Launch K2 on the current stream. Same contract as
    ``coverage_sums_plain``; bitwise repeatable."""
    B, F = e.shape[0], e.shape[-1]
    _check("coverage_fwd: e", e, (B, 3, 8, F))
    if e.data_ptr() % 16:  # the kernel stages e with 16-byte bulk copies
        e = e.clone()
    out = torch.empty((B, image_size * image_size), dtype=torch.float32,
                      device=e.device)
    lib = _lib()
    with torch.cuda.device(e.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.coverage_fwd_launch(e.data_ptr(), out.data_ptr(), B, F,
                                      image_size, float(inv_sigma), stream)
    if err != 0:
        raise RuntimeError(f"coverage_fwd kernel launch failed: CUDA error "
                           f"{err}")
    launches["coverage_fwd"] += 1
    return out


def coverage_sums_bwd_cuda(e, g, image_size, inv_sigma):
    """Launch K3 (one kernel, no scratch, no atomics) on the current
    stream. Same contract as ``coverage_sums_bwd_plain``; bitwise
    repeatable."""
    B, F = e.shape[0], e.shape[-1]
    _check("coverage_bwd: e", e, (B, 3, 8, F))
    _check("coverage_bwd: g", g, (B, image_size * image_size))
    if e.device != g.device:
        raise ValueError("coverage_bwd: inputs on different devices")
    de = torch.empty_like(e)
    if F == 0 or B == 0:
        return de
    lib = _lib()
    with torch.cuda.device(e.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.coverage_bwd_launch(e.data_ptr(), g.data_ptr(),
                                      de.data_ptr(), B, F, image_size,
                                      float(inv_sigma), stream)
    if err != 0:
        raise RuntimeError(f"coverage_bwd kernel launch failed: CUDA error "
                           f"{err}")
    launches["coverage_bwd"] += 1
    return de


class _Coverage(torch.autograd.Function):
    """K2 forward, K3 backward (plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, e, image_size, inv_sigma):
        ctx.save_for_backward(e)
        ctx.image_size, ctx.inv_sigma = image_size, inv_sigma
        if e.is_cuda:
            return coverage_sums_cuda(e, image_size, inv_sigma)
        return coverage_sums_plain(e, image_size, inv_sigma)

    @staticmethod
    def backward(ctx, g):
        (e,) = ctx.saved_tensors
        g = g.contiguous()
        if e.is_cuda:
            de = coverage_sums_bwd_cuda(e, g, ctx.image_size, ctx.inv_sigma)
        else:
            de = coverage_sums_bwd_plain(e, g, ctx.image_size, ctx.inv_sigma)
        return de, None, None


def coverage_sums(e, image_size, inv_sigma):
    """Raw per-pixel coverage sums (B, P) from coefficients e (B, 3, 8, F),
    differentiable in e: kernels for CUDA tensors, plain versions for CPU
    tensors."""
    return _Coverage.apply(e.contiguous(), int(image_size), float(inv_sigma))
