"""Statistical-moment estimation from particle ensembles.

The port's own copy of quinoa_tpu/statistics/stats.py (the reference's
Statistics engine, src/Statistics/Statistics.hpp:80-124): ordinary and
central moments of any order and any variable product, estimated from an
(npar, nprop) particle tensor on its device.

A moment request is a ``Term`` tuple ((var, comp), ...) -- e.g. <Y1 Y2>
is (("y", 0), ("y", 1)).  Ordinary moments are means of products;
central moments subtract the means first.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

#: one variable inside a product: (depvar, component)
Var = Tuple[str, int]
#: a product of variables (a moment request)
Term = Tuple[Var, ...]


def mean(depvar: str, comp: int) -> Term:
    return ((depvar, comp),)


def variance(depvar: str, comp: int) -> Term:
    return ((depvar, comp), (depvar, comp))


def block_mean(x, nshard: int = 1):
    """The mean of x over its particle axis 0.  With nshard > 1 the
    ensemble is nshard equal row blocks (walker --npes) and the blocks'
    sums are added in block order before the division, as the JAX
    walker's reduction over its sharded particle axis does."""
    if nshard == 1:
        return x.mean(dim=0)
    n = x.shape[0] // nshard
    acc = x[:n].sum(dim=0)
    for b in range(1, nshard):
        acc = acc + x[b * n:(b + 1) * n].sum(dim=0)
    return acc / x.shape[0]


def _column(particles, offsets: Dict[str, int], var: Var):
    depvar, comp = var
    return particles[:, offsets[depvar] + comp]


def ordinary_moment(particles, offsets, term: Term, nshard: int = 1):
    """< prod_i v_i > over the ensemble, a 0-d tensor (block_mean)."""
    prod = torch.ones(particles.shape[0], dtype=particles.dtype,
                      device=particles.device)
    for v in term:
        prod = prod * _column(particles, offsets, v)
    return block_mean(prod, nshard)


def central_moment(particles, offsets, term: Term, nshard: int = 1):
    """< prod_i (v_i - <v_i>) >, a 0-d tensor (block_mean)."""
    prod = torch.ones(particles.shape[0], dtype=particles.dtype,
                      device=particles.device)
    for v in term:
        col = _column(particles, offsets, v)
        prod = prod * (col - block_mean(col, nshard))
    return block_mean(prod, nshard)


def estimate_moments(
    particles,
    offsets: Dict[str, int],
    ordinary: Sequence[Term] = (),
    central: Sequence[Term] = (),
    nshard: int = 1,
):
    """Estimate a batch of moments; returns {term: 0-d tensor}.

    Ordinary terms are keyed as given; central terms are keyed
    ("C",) + term to distinguish <yy> from <YY> (the reference uses
    upper/lower case for ordinary/central).  nshard: block_mean's row
    blocks.
    """
    out = {}
    for t in ordinary:
        out[t] = ordinary_moment(particles, offsets, t, nshard)
    for t in central:
        out[("C",) + t] = central_moment(particles, offsets, t, nshard)
    return out


def moments_to_host(moments) -> Dict:
    """{term: float} from estimate_moments' tensors, in one device copy."""
    if not moments:
        return {}
    vals = torch.stack(list(moments.values())).tolist()
    return dict(zip(moments.keys(), vals))
