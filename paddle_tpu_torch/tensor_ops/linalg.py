"""Linear algebra. Counterpart of ``paddle_tpu/tensor_ops/linalg.py``;
also the ``paddle_tpu_torch.linalg`` submodule.

``norm`` keeps the JAX package's forms: with no axis the input is
flattened ("fro" and 2 are the 2-norm of the elements, 1 the sum of
magnitudes, inf their max, any other p the p-norm); with an axis (or
two) "fro" and 2 are the 2-norm of the elements along them, inf/-inf
the max/min magnitude, 0 the count of non-zeros. ``svd`` returns
``(U, S, VH)``, ``qr`` ``(Q, R)``, ``eigh`` ``(w, V)``, ``lu`` the packed
factors with 1-based pivots (LAPACK's, as ``lu_factor`` gives them), and
``lstsq`` numpy's four outputs.
"""
from __future__ import annotations

import math

import torch

from ._factory import floating, operands, stop, tensor
from .stat import corrcoef, cov

__all__ = [
    "cholesky", "cholesky_solve", "cond", "corrcoef", "cov", "det", "dist",
    "eig", "eigh", "eigvals", "eigvalsh", "householder_product", "inv",
    "inverse", "lstsq", "lu", "lu_unpack", "matrix_power", "matrix_rank",
    "matrix_transpose", "multi_dot", "norm", "pca_lowrank", "pinv", "qr",
    "slogdet", "solve", "svd", "triangular_solve",
]

_INF = ("inf", math.inf)
_NEG_INF = ("-inf", -math.inf)


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    a = floating(tensor(x))
    if axis is None:
        flat = a.reshape(-1)
        if p in ("fro", 2, 2.0):
            out = torch.sqrt(torch.sum(flat * flat))
        elif p == 1:
            out = torch.sum(torch.abs(flat))
        elif p in _INF:
            out = torch.amax(torch.abs(flat))
        else:
            out = torch.sum(torch.abs(flat) ** p) ** (1.0 / p)
        return out.reshape((1,) * a.dim()) if keepdim else out
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    if p in ("fro", 2):
        return torch.sqrt(torch.sum(a * a, ax, keepdim=keepdim))
    if p in _INF:
        return torch.amax(torch.abs(a), ax, keepdim=keepdim)
    if p in _NEG_INF:
        return torch.amin(torch.abs(a), ax, keepdim=keepdim)
    if p == 0:
        return torch.sum((a != 0).to(a.dtype), ax, keepdim=keepdim)
    return torch.sum(torch.abs(a) ** p, ax, keepdim=keepdim) ** (1.0 / p)


def dist(x, y, p=2, name=None):
    a, b = operands(x, y)
    d = floating(a - b).reshape(-1)
    if p == 0:
        return torch.sum((d != 0).to(d.dtype))
    if p == math.inf:
        return torch.amax(torch.abs(d))
    if p == -math.inf:
        return torch.amin(torch.abs(d))
    return torch.sum(torch.abs(d) ** p) ** (1.0 / p)


def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky(tensor(x), upper=upper)


def cholesky_solve(x, y, upper=False, name=None):
    """Solves ``A z = x`` given the Cholesky factor ``y`` of A."""
    b, f = operands(x, y)
    return torch.cholesky_solve(b, f, upper=upper)


def inverse(x, name=None):
    return torch.linalg.inv(tensor(x))


inv = inverse


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(tensor(x), rtol=rcond, hermitian=hermitian)


def det(x, name=None):
    return torch.linalg.det(tensor(x))


def slogdet(x, name=None):
    sign, logdet = torch.linalg.slogdet(tensor(x))
    return torch.stack([sign, logdet])


def svd(x, full_matrices=False, name=None):
    return tuple(torch.linalg.svd(tensor(x), full_matrices=full_matrices))


def qr(x, mode="reduced", name=None):
    return tuple(torch.linalg.qr(tensor(x), mode=mode))


def eig(x, name=None):
    return tuple(torch.linalg.eig(tensor(x)))


def eigh(x, UPLO="L", name=None):
    return tuple(torch.linalg.eigh(tensor(x), UPLO=UPLO))


def eigvals(x, name=None):
    return torch.linalg.eigvals(tensor(x))


def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(tensor(x), UPLO=UPLO)


def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(tensor(x), n)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    """Singular values above ``tol`` (absolute), or numpy's default
    relative threshold."""
    x = tensor(x)
    if tol is None:
        return stop(torch.linalg.matrix_rank(x, hermitian=hermitian))
    return stop(torch.linalg.matrix_rank(x, atol=tol, rtol=0.0,
                                         hermitian=hermitian))


def solve(x, y, name=None):
    return torch.linalg.solve(*operands(x, y))


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    a, b = operands(x, y)
    if transpose:
        a, upper = a.mT, not upper
    return torch.linalg.solve_triangular(a, b, upper=upper,
                                         unitriangular=unitriangular)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """(solution, residuals, rank, singular values), numpy's: the
    residuals are the squared 2-norms of the columns of ``a @ sol - b``
    when ``a`` is tall and of full rank, else empty."""
    a, b = operands(x, y)
    sol = torch.linalg.lstsq(a, b, rcond=rcond).solution
    sv = torch.linalg.svdvals(a)
    m, n = a.shape[-2], a.shape[-1]
    tol = (rcond if rcond is not None
           else torch.finfo(a.dtype).eps * max(m, n))
    rank = stop(torch.sum(sv > tol * sv.amax(-1, keepdim=True), -1))
    if m > n and bool((rank == n).all()):
        res = torch.sum((a @ sol - b) ** 2, dim=-2)
    else:
        res = a.new_zeros((0,))
    return sol, res, rank, sv



def lu(x, pivot=True, get_infos=False, name=None):
    """The packed LU factors and 1-based pivots (int32)."""
    lu_, piv = torch.linalg.lu_factor(tensor(x))
    if get_infos:
        return lu_, stop(piv), torch.zeros((), dtype=torch.int32,
                                           device=lu_.device)
    return lu_, stop(piv)


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """(P, L, U) with ``A = P @ L @ U`` from ``lu``'s factors."""
    p, l_, u = torch.lu_unpack(*operands(x, y))
    return (p if unpack_pivots else None,
            l_ if unpack_ludata else None,
            u if unpack_ludata else None)


def multi_dot(x, name=None):
    return torch.linalg.multi_dot(list(operands(*x)))


def matrix_transpose(x, name=None):
    return tensor(x).mT


def cond(x, p=None, name=None):
    return stop(torch.linalg.cond(tensor(x), p))


def householder_product(x, tau, name=None):
    return torch.linalg.householder_product(*operands(x, tau))


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """(U, S, V) of the (centred) input with ``x ~= U diag(S) V^T``, from
    an exact SVD, as the JAX package computes it."""
    a = floating(tensor(x))
    if center:
        a = a - a.mean(dim=-2, keepdim=True)
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    k = q or min(a.shape[-2], a.shape[-1])
    return u[..., :k], s[..., :k], vh.mT[..., :k]
