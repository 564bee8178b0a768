"""Quadrature rules (reference: include/mitsuba/core/quad.h; counterpart
of ``mitsuba2_tpu.core.quad``): Gauss-Legendre, Gauss-Lobatto, composite
Simpson and Simpson 3/8 nodes and weights on [-1, 1], computed on the
host in numpy (float64, cached per order) and returned as float32
tensors."""

from __future__ import annotations

import functools

import numpy as np
import torch


def _f32(x, w):
    return (torch.as_tensor(x, dtype=torch.float32),
            torch.as_tensor(w, dtype=torch.float32))


@functools.lru_cache(maxsize=None)
def _gauss_legendre_np(n: int):
    # numpy's leggauss: the Golub-Welsch eigenvalue method
    x, w = np.polynomial.legendre.leggauss(n)
    return x.astype(np.float64), w.astype(np.float64)


def gauss_legendre(n: int):
    """n nodes and weights on [-1, 1] (quad.h gauss_legendre)."""
    return _f32(*_gauss_legendre_np(n))


@functools.lru_cache(maxsize=None)
def _gauss_lobatto_np(n: int):
    if n < 2:
        raise ValueError("gauss_lobatto requires n >= 2")
    # the interior nodes are the roots of P'_{n-1}: the eigenvalues of the
    # Jacobi matrix of the Jacobi(1, 1) polynomials
    k_in = n - 2
    if k_in > 0:
        k = np.arange(1, k_in)
        b = np.sqrt(k * (k + 2) / ((2 * k + 1) * (2 * k + 3)))
        interior = np.linalg.eigvalsh(np.diag(b, 1) + np.diag(b, -1))
    else:
        interior = np.empty(0)
    x = np.concatenate([[-1.0], interior, [1.0]])
    # w_i = 2 / (n (n - 1) P_{n-1}(x_i)^2)
    Pn1 = np.polynomial.legendre.Legendre.basis(n - 1)(x)
    return x, 2.0 / (n * (n - 1) * Pn1 ** 2)


def gauss_lobatto(n: int):
    """n nodes and weights on [-1, 1], the end points included (quad.h
    gauss_lobatto)."""
    return _f32(*_gauss_lobatto_np(n))


def composite_simpson(n: int):
    """The composite Simpson rule on [-1, 1]; n odd (quad.h)."""
    if n % 2 != 1 or n < 3:
        raise ValueError("composite_simpson requires odd n >= 3")
    x = np.linspace(-1.0, 1.0, n)
    w = np.ones(n)
    w[1:-1:2] = 4.0
    w[2:-1:2] = 2.0
    w *= (2.0 / (n - 1)) / 3.0
    return _f32(x, w)


def composite_simpson_38(n: int):
    """The composite Simpson 3/8 rule on [-1, 1]; n = 3k + 1 (quad.h)."""
    if (n - 1) % 3 != 0 or n < 4:
        raise ValueError("composite_simpson_38 requires n = 3k+1 >= 4")
    x = np.linspace(-1.0, 1.0, n)
    w = np.full(n, 3.0)
    w[0] = w[-1] = 1.0
    w[3:-1:3] = 2.0
    w *= (2.0 / (n - 1)) * 3.0 / 8.0
    return _f32(x, w)
