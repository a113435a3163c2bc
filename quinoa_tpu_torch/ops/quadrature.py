"""Gauss quadrature rules on the reference tetrahedron and triangle.

Same rules as the reference (src/PDE/Integrate/Quadrature.cpp): tet rules
with 1/5/11/14 points (degrees 1/3/4/5), triangle rules with 1/3/4/6 points
(degrees 1/2/3/4).  Weights are normalized to sum to 1 (the reference
multiplies by element volume / face area, not by reference-domain measure).

NGvol/NGfa/NGinit follow Quadrature.hpp:25-60.

A copy of quinoa_tpu/ops/quadrature.py: that module is numpy-only, but
importing it runs quinoa_tpu/ops/__init__.py, which imports jax.
"""

from __future__ import annotations

import numpy as np

_SQ = {}


def _tet_rules():
    rules = {}
    rules[1] = (np.array([[0.25, 0.25, 0.25]]), np.array([1.0]))

    a1, a2 = 0.5854101966249685, 0.1381966011250105
    rules[4] = (
        np.array([[a2, a2, a2], [a1, a2, a2], [a2, a1, a2], [a2, a2, a1]]),
        np.array([0.25, 0.25, 0.25, 0.25]),
    )

    pts5 = np.array(
        [
            [0.25, 0.25, 0.25],
            [1 / 6, 1 / 6, 1 / 6],
            [0.5, 1 / 6, 1 / 6],
            [1 / 6, 0.5, 1 / 6],
            [1 / 6, 1 / 6, 0.5],
        ]
    )
    w5 = np.array([-12.0 / 15.0, 9 / 20, 9 / 20, 9 / 20, 9 / 20])
    rules[5] = (pts5, w5)

    c1, c2 = 0.3994035761667992, 0.1005964238332008
    c3, c4 = 343.0 / 7500.0, 56.0 / 375.0
    pts11 = np.array(
        [
            [0.25, 0.25, 0.25],
            [11 / 14, 1 / 14, 1 / 14],
            [1 / 14, 11 / 14, 1 / 14],
            [1 / 14, 1 / 14, 11 / 14],
            [1 / 14, 1 / 14, 1 / 14],
            [c1, c1, c2],
            [c1, c2, c1],
            [c1, c2, c2],
            [c2, c1, c1],
            [c2, c1, c2],
            [c2, c2, c1],
        ]
    )
    w11 = np.array([-148.0 / 1875.0] + [c3] * 4 + [c4] * 6)
    rules[11] = (pts11, w11)

    a, b = 0.0673422422100983, 0.3108859192633005
    c, d = 0.7217942490673264, 0.0927352503108912
    e, f = 0.4544962958743506, 0.0455037041256494
    p, q, r = 0.1126879257180162, 0.0734930431163619, 0.0425460207770812
    pts14 = np.array(
        [
            [a, b, b], [b, a, b], [b, b, a], [b, b, b],
            [c, d, d], [d, c, d], [d, d, c], [d, d, d],
            [e, e, f], [e, f, e], [e, f, f], [f, e, e], [f, e, f], [f, f, e],
        ]
    )
    w14 = np.array([p] * 4 + [q] * 4 + [r] * 6)
    rules[14] = (pts14, w14)
    return rules


def _tri_rules():
    rules = {}
    rules[1] = (np.array([[1 / 3, 1 / 3]]), np.array([1.0]))
    rules[3] = (
        np.array([[2 / 3, 1 / 6], [1 / 6, 2 / 3], [1 / 6, 1 / 6]]),
        np.array([1 / 3, 1 / 3, 1 / 3]),
    )
    rules[4] = (
        np.array([[1 / 3, 1 / 3], [1 / 5, 1 / 5], [3 / 5, 1 / 5], [1 / 5, 3 / 5]]),
        np.array([-27 / 48, 25 / 48, 25 / 48, 25 / 48]),
    )
    a, b = 0.816847572980459, 0.091576213509771
    c, d = 0.108103018168070, 0.445948490915965
    w1 = 0.054975870996713638 * 2.0
    w2 = 0.1116907969117165 * 2.0
    rules[6] = (
        np.array([[a, b], [b, b], [b, a], [c, d], [d, c], [d, d]]),
        np.array([w1, w1, w1, w2, w2, w2]),
    )
    return rules


TET_RULES = _tet_rules()
TRI_RULES = _tri_rules()


def gauss_tet(ng: int):
    """(points (ng,3), weights (ng,)); weights sum to 1."""
    return TET_RULES[ng]


def gauss_tri(ng: int):
    """(points (ng,2), weights (ng,)); weights sum to 1."""
    return TRI_RULES[ng]


def ng_vol(ndof: int) -> int:
    return {1: 1, 4: 5, 10: 11}[ndof]


def ng_face(ndof: int) -> int:
    return {1: 1, 4: 3, 10: 6}[ndof]


def ng_init(ndof: int) -> int:
    return {1: 1, 4: 14, 10: 14}[ndof]


def ng_diag(ndof: int) -> int:
    return {1: 1, 4: 4, 10: 14}[ndof]
