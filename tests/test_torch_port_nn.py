"""Kernel K1 (grouped 1-NN): the port's plain version against the TPU
kernel ``chore_tpu.ops.pallas.nn.nn_pallas`` in interpret mode (as
``tests/test_pallas_nn.py`` runs it on the CPU) and against the XLA path
``_nn_sqdist_xla``; the exact-gradient wrapper against
``nn_sqdist_exact_grad``. The CUDA kernel against the plain version on
the card is in ``test_torch_port_cuda.py`` (no JAX there).

Tolerances: distances 1e-5 absolute (f32 expansion |x|^2 - 2x.y + |y|^2 of
unit-scale points summed in other orders); indices exactly equal, the
inputs being random (no near-ties) or built with exact duplicates.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import chore_tpu.ops.pallas.nn as jnn
from test_torch_port_cuda import CASES, make_case as _case
from test_torch_port_util import n, t


@pytest.fixture()
def interpret(monkeypatch):
    orig = pl.pallas_call

    def interp(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)
    monkeypatch.setattr(jnn, "nn_pallas", jnn.nn_pallas.__wrapped__)


def _plain(x, y, ym, xg, yg):
    from chore_tpu_torch.ops.nn import group_rows, nn_sqdist_plain

    tx, ty = t(x)[None], t(y)[None]
    opt = lambda a, dt: None if a is None else t(a, dt)[None]  # noqa: E731
    qg, rg = group_rows(tx, ty, opt(ym, torch.bool), opt(xg, torch.int64),
                        opt(yg, torch.int64))
    d, i = nn_sqdist_plain(tx, ty, qg, rg)
    return n(d[0]), n(i[0])


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas_interpret(interpret, name):
    x, y, ym, xg, yg = _case(3, **CASES[name])
    dj, ij = jnn.nn_pallas(x, y, y_mask=ym, x_group=xg, y_group=yg)
    dt, it = _plain(x, y, ym, xg, yg)
    np.testing.assert_array_equal(it, np.asarray(ij))
    np.testing.assert_allclose(dt, np.asarray(dj), atol=1e-5)
    unmatched = np.asarray(dj) >= 1e9
    assert (dt[unmatched] == 1e10).all() and (it[unmatched] == 0).all()
    if name == "empty_groups":
        assert unmatched.any()


@pytest.mark.parametrize("name", ["groups", "groups_mask", "duplicates"])
def test_plain_matches_xla_path(name):
    from chore_tpu.ops.chamfer import _nn_sqdist_xla

    x, y, ym, xg, yg = _case(9, **CASES[name])
    opt = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    dj, ij = _nn_sqdist_xla(jnp.asarray(x), jnp.asarray(y), y_mask=opt(ym),
                            x_group=opt(xg), y_group=opt(yg), tile=128)
    dt, it = _plain(x, y, ym, xg, yg)
    np.testing.assert_array_equal(it, np.asarray(ij))
    np.testing.assert_allclose(dt, np.asarray(dj), atol=1e-5)


def test_all_masked_sentinel():
    x, y, _, _, _ = _case(4)
    dt, it = _plain(x, y, np.zeros(len(y), bool), None, None)
    assert (dt == 1e10).all() and (it == 0).all()


def test_exact_grad_wrapper(interpret):
    """ops.chamfer.nn_sqdist (batched) against nn_sqdist_exact_grad
    (vmapped, as the contact loss calls it): distances and gradients with
    respect to both clouds, 1e-5; the sentinel keeps zero gradient."""
    from chore_tpu_torch.ops.chamfer import nn_sqdist

    rng = np.random.RandomState(11)
    B = 3
    x = rng.randn(B, 70, 3).astype(np.float32)
    y = rng.randn(B, 40, 3).astype(np.float32)
    xg = rng.randint(0, 5, (B, 70)).astype(np.int32)
    yg = rng.randint(0, 4, (B, 40)).astype(np.int32)  # group 4: unmatched
    ym = rng.rand(B, 40) > 0.3

    def jloss(a, b):
        d, i = jax.vmap(lambda p, q, m, g1, g2: jnn.nn_sqdist_exact_grad(
            p, q, y_mask=m, x_group=g1, y_group=g2))(a, b, ym, xg, yg)
        return jnp.where(d < 1e9, d, 0.0).sum(), (d, i)

    (_, (dj, ij)), (gxj, gyj) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(y))
    tx, ty = t(x).requires_grad_(True), t(y).requires_grad_(True)
    dt, it = nn_sqdist(tx, ty, y_mask=t(ym, torch.bool),
                       x_group=t(xg, torch.int64), y_group=t(yg, torch.int64))
    torch.where(dt < 1e9, dt, torch.zeros_like(dt)).sum().backward()
    np.testing.assert_array_equal(n(it), np.asarray(ij))
    np.testing.assert_allclose(n(dt), np.asarray(dj), atol=1e-5)
    np.testing.assert_allclose(n(tx.grad), np.asarray(gxj), atol=1e-5)
    np.testing.assert_allclose(n(ty.grad), np.asarray(gyj), atol=1e-5)
    assert (n(dt)[xg == 4] == 1e10).all()


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper runs the plain version and counts no kernel
    launch."""
    from chore_tpu_torch.ops import nn as tnn
    from chore_tpu_torch.ops.chamfer import nn_sqdist

    before = tnn.launches["nn_grouped"]
    x = torch.randn(1, 20, 3, generator=torch.Generator().manual_seed(0))
    d, i = nn_sqdist(x, x.flip(1))
    assert tnn.launches["nn_grouped"] == before
    assert (i[0] == torch.arange(19, -1, -1)).all()
    assert float(d.abs().max()) == 0.0


def test_cuda_wrapper_rejects_bad_inputs():
    """The CUDA entry point raises on tensors it does not take (here: on
    the CPU) instead of falling back."""
    from chore_tpu_torch.ops.nn import nn_sqdist_cuda

    x = torch.zeros(1, 4, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        nn_sqdist_cuda(x, x, torch.zeros(1, 4), torch.zeros(1, 4))


def test_entry_point_is_typed(monkeypatch):
    """The kernel's C entry point gets its argument types before the first
    call: untyped, ctypes passes the pointers as 32-bit ints (a crash on
    the card). A libc function stands in for the built library."""
    import ctypes

    from chore_tpu_torch.ops import cuda_build
    from chore_tpu_torch.ops import nn as tnn

    class Lib:
        nn_multi_launch = ctypes.CDLL(None).labs

    monkeypatch.setattr(cuda_build, "load", lambda name: Lib)
    fn = tnn._entry_point()
    # (const NNProblem* problems, int n, void* stream): the table is an
    # array of structs of 8 pointers and 4 ints
    assert list(fn.argtypes) == [ctypes.POINTER(tnn.Problem), ctypes.c_int,
                                 ctypes.c_void_p]
    assert fn.restype is ctypes.c_int
    assert [f[1] for f in tnn.Problem._fields_] == (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4)
    assert ctypes.sizeof(tnn.Problem) == 80
