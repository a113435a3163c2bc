"""Geometric mesh partitioners (host-side, numpy).

The port's own copy of quinoa_tpu/parallel/partition.py, the counterpart
of the reference's Zoltan2 interop (src/LoadBalance/ZoltanInterOp.cpp:
29-133: RCB/RIB/HSFC/MJ over element centroids, and PHG).  The port
partitions once per (re)mesh on the host, with the JAX package's
algorithms in its operation order, so both packages cut a mesh into the
same parts:

- ``morton_partition``: sort by the Morton code of the quantized
  centroids and cut equal-count (or, with weights, equal-weight)
  contiguous chunks: the HSFC analog and the default;
- ``rcb_partition``, ``rib_partition``, ``mj_partition``: recursive
  coordinate and inertial bisection and multi-jagged sectioning;
- ``graph_partition``: greedy graph growing over face adjacency;
- ``partition_hierarchical``: slice-major two-level ids (--slices).

Each returns a per-element part id in [0, nparts).  The JAX package
computes the Morton codes with its native library where that loads; the
codes are the numpy ones here, which are the same integers.
"""

from __future__ import annotations

import numpy as np


def element_centroids(coords: np.ndarray, inpoel: np.ndarray) -> np.ndarray:
    return coords[inpoel].mean(axis=1)


def _morton_codes(pts: np.ndarray, bits: int = 21) -> np.ndarray:
    """Interleaved Morton codes of 3-D points quantized to `bits` per axis."""
    lo = pts.min(axis=0)
    span = pts.max(axis=0) - lo
    span[span == 0] = 1.0
    q = ((pts - lo) / span * ((1 << bits) - 1)).astype(np.uint64)

    def spread(x):
        # spread the low 21 bits of x so there are 2 zero bits between bits
        x &= np.uint64(0x1FFFFF)
        x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
        return x

    return spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
        spread(q[:, 2]) << np.uint64(2)
    )


def morton_partition(centroids: np.ndarray, nparts: int,
                     weights: np.ndarray | None = None) -> np.ndarray:
    """SFC partition: sort by Morton code, chunk contiguously.

    Equal COUNT without weights; equal WEIGHT (cut at weighted
    quantiles of the curve) with them — the dynamic-load-balancing
    splitter (Zoltan HSFC accepts the same per-object weights)."""
    n = centroids.shape[0]
    codes = _morton_codes(centroids)
    order = np.argsort(codes, kind="stable")
    part = np.empty(n, dtype=np.int32)
    if weights is None:
        # equal-count split (differ by at most 1)
        bounds = (np.arange(1, nparts) * n) // nparts
        part[order] = np.searchsorted(bounds, np.arange(n), side="right")
    else:
        w = np.asarray(weights, dtype=np.float64)[order]
        cw = np.cumsum(w)
        total = cw[-1] if len(cw) else 0.0
        cuts = total * np.arange(1, nparts) / nparts
        # element i (SFC order) goes to the part whose weight window
        # holds the MIDPOINT of its own weight span; expressed as cut
        # POSITIONS so parts can be repaired to be non-empty (a single
        # element heavier than a weight window would otherwise swallow
        # whole windows and leave devices with zero elements)
        mid = cw - 0.5 * w
        pos = np.searchsorted(mid, cuts, side="left")
        for k in range(len(pos)):  # nparts-1 iterations, tiny
            lo = (pos[k - 1] if k else 0) + 1
            pos[k] = min(max(pos[k], lo), n - (nparts - 1 - k))
        part[order] = np.searchsorted(pos, np.arange(n), side="right")
    return part


def rcb_partition(centroids: np.ndarray, nparts: int) -> np.ndarray:
    """Recursive coordinate bisection into `nparts` equal-count parts.

    Handles non-power-of-two counts by splitting proportionally.
    """
    n = centroids.shape[0]
    part = np.zeros(n, dtype=np.int32)

    def recurse(idx: np.ndarray, base: int, k: int):
        if k == 1:
            part[idx] = base
            return
        pts = centroids[idx]
        ax = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
        k_lo = k // 2
        # proportional split point so all parts end up equal-count
        cut = (len(idx) * k_lo) // k
        order = np.argsort(pts[:, ax], kind="stable")
        recurse(idx[order[:cut]], base, k_lo)
        recurse(idx[order[cut:]], base + k_lo, k - k_lo)

    recurse(np.arange(n, dtype=np.int64), 0, nparts)
    return part


def rib_partition(centroids: np.ndarray, nparts: int) -> np.ndarray:
    """Recursive inertial bisection: bisect along the principal axis of
    the point cloud's inertia (the direction of largest variance), the
    Zoltan RIB analog (ZoltanInterOp.cpp:29-133).  Better cuts than RCB
    on meshes whose long direction is not axis-aligned."""
    n = centroids.shape[0]
    part = np.zeros(n, dtype=np.int32)

    def recurse(idx: np.ndarray, base: int, k: int):
        if k == 1:
            part[idx] = base
            return
        pts = centroids[idx]
        c = pts - pts.mean(axis=0)
        # principal direction of inertia = leading eigenvector of the
        # 3x3 covariance (tiny, exact)
        cov = c.T @ c
        w, v = np.linalg.eigh(cov)
        proj = c @ v[:, -1]
        k_lo = k // 2
        cut = (len(idx) * k_lo) // k
        order = np.argsort(proj, kind="stable")
        recurse(idx[order[:cut]], base, k_lo)
        recurse(idx[order[cut:]], base + k_lo, k - k_lo)

    recurse(np.arange(n, dtype=np.int64), 0, nparts)
    return part


def mj_partition(centroids: np.ndarray, nparts: int) -> np.ndarray:
    """Multi-jagged: multi-way (not binary) recursive sectioning along
    coordinate axes — the Zoltan2 MJ analog.  Factor nparts into up to
    three per-axis counts ordered by the cloud's extents, then cut each
    axis into equal-count slabs recursively."""
    # factor nparts into <=3 factors, largest first
    def factors3(p):
        fs = []
        for prime in range(2, p + 1):
            while p % prime == 0:
                fs.append(prime)
                p //= prime
            if p == 1:
                break
        out = [1, 1, 1]
        for f in sorted(fs, reverse=True):
            out[int(np.argmin(out))] *= f
        return sorted(out, reverse=True)

    n = centroids.shape[0]
    part = np.zeros(n, dtype=np.int32)
    ext_order = np.argsort(
        -(centroids.max(axis=0) - centroids.min(axis=0)))
    counts = factors3(nparts)

    def recurse(idx: np.ndarray, base: int, depth: int, stride: int):
        k = counts[depth] if depth < 3 else 1
        if k == 1 or depth >= 3:
            part[idx] = base
            return
        ax = int(ext_order[depth])
        order = np.argsort(centroids[idx, ax], kind="stable")
        sub_stride = stride // k
        m = len(idx)
        for j in range(k):
            lo, hi = (m * j) // k, (m * (j + 1)) // k
            recurse(idx[order[lo:hi]], base + j * sub_stride,
                    depth + 1, sub_stride)

    recurse(np.arange(n, dtype=np.int64), 0, 0, nparts)
    return part


def graph_partition(centroids: np.ndarray, nparts: int,
                    inpoel: np.ndarray | None = None) -> np.ndarray:
    """Greedy graph-growing over face adjacency seeded by SFC order —
    the PHG (hypergraph) analog.  Grows each part by
    BFS over element face-neighbors to the exact target count, seeding
    each part at the first unassigned element in SFC order, which keeps
    parts connected and cuts near-minimal without an iterative
    hypergraph solve."""
    if inpoel is None:
        # no connectivity available: SFC fallback
        return morton_partition(centroids, nparts)
    from ..mesh.derived import gen_esuel

    import heapq

    n = inpoel.shape[0]
    nnode = int(inpoel.max()) + 1
    esuel = gen_esuel(inpoel, nnode).T  # (4, nelem), -1 bnd
    codes = _morton_codes(centroids)
    rank = np.empty(n, dtype=np.int64)
    rank[np.argsort(codes, kind="stable")] = np.arange(n)
    codes_order = np.argsort(codes, kind="stable")
    part = np.full(n, -1, dtype=np.int32)
    pos = 0  # cursor into codes_order for seeds

    for p in range(nparts):
        target = ((p + 1) * n) // nparts - (p * n) // nparts
        while pos < n and part[codes_order[pos]] >= 0:
            pos += 1
        if pos >= n:
            break
        # GGGP: grow by max gain (= assigned face-neighbors, so the
        # front stays compact), SFC rank as tie-break
        heap = [(-1, rank[codes_order[pos]], codes_order[pos])]
        grown = 0
        while grown < target:
            if not heap:
                while pos < n and part[codes_order[pos]] >= 0:
                    pos += 1
                if pos >= n:
                    break
                heapq.heappush(
                    heap, (-1, rank[codes_order[pos]], codes_order[pos]))
            _, _, e = heapq.heappop(heap)
            if part[e] >= 0:
                continue
            part[e] = p
            grown += 1
            for i in range(4):
                nb = esuel[i, e]
                if nb >= 0 and part[nb] < 0:
                    gain = sum(
                        1 for j in range(4)
                        if esuel[j, nb] >= 0 and part[esuel[j, nb]] == p)
                    heapq.heappush(heap, (-gain, rank[nb], nb))
    part[part < 0] = nparts - 1
    return part


_ALGOS = {
    "sfc": morton_partition,
    "hsfc": morton_partition,
    "rcb": rcb_partition,
    "rib": rib_partition,
    "mj": mj_partition,
    "phg": graph_partition,
}


def partition_elements(
    coords: np.ndarray, inpoel: np.ndarray, nparts: int,
    algorithm: str = "sfc", weights: np.ndarray | None = None,
) -> np.ndarray:
    """Partition elements by centroid into `nparts` shards.

    With per-element `weights` (dynamic load balancing: e.g. active
    dofs under p-adaptivity) the split is the weighted SFC cut
    regardless of `algorithm` — mirroring the reference's Zoltan
    migration, which rebalances by object weight along its HSFC."""
    if nparts < 1:
        raise ValueError("nparts must be >= 1")
    if nparts == 1:
        return np.zeros(inpoel.shape[0], dtype=np.int32)
    if weights is not None:
        return morton_partition(element_centroids(coords, inpoel),
                                nparts, weights=weights)
    try:
        algo = _ALGOS[algorithm]
    except KeyError:
        raise ValueError(f"unknown partitioning algorithm {algorithm!r}") from None
    if algo is graph_partition:
        return algo(element_centroids(coords, inpoel), nparts, inpoel=inpoel)
    return algo(element_centroids(coords, inpoel), nparts)


def partition_hierarchical(
    coords: np.ndarray,
    inpoel: np.ndarray,
    nslice: int,
    chips_per_slice: int,
    algorithm: str = "sfc",
) -> np.ndarray:
    """Two-level (multi-slice) element partition: slice-major ids.

    Where devices form a bandwidth hierarchy (devices of one node or
    slice joined by a fast link, nodes by a slower one), the chatty
    traffic of a domain decomposition is the halo exchange, so the
    partition itself is hierarchical: first cut the domain into
    `nslice` contiguous regions, then cut each region into
    `chips_per_slice` shards.  Shard id = slice * chips_per_slice +
    local chip, so a slice-major list of devices keeps every
    intra-region halo pair inside one slice.

    The reference's analog is Charm++ topology-aware mapping over its
    Zoltan partitions (the reference relies on the RTS; here the
    locality is built into the partition ids).
    """
    parts1 = partition_elements(coords, inpoel, nslice, algorithm)
    out = np.empty(inpoel.shape[0], dtype=np.int32)
    for s in range(nslice):
        idx = np.nonzero(parts1 == s)[0]
        sub = partition_elements(
            coords, inpoel[idx], chips_per_slice, algorithm)
        out[idx] = s * chips_per_slice + sub
    return out


def partition_for(coords, inpoel, nshard, algorithm="sfc",
                  hierarchy=None):
    """Shard-builder entry: flat or hierarchical (multi-slice) ids.

    hierarchy=(nslice, chips_per_slice) must multiply to nshard.
    """
    if hierarchy is not None:
        ns, cps = hierarchy
        if ns * cps != nshard:
            raise ValueError(
                f"hierarchy {ns}x{cps} != nshard {nshard}")
        return partition_hierarchical(coords, inpoel, ns, cps, algorithm)
    return partition_elements(coords, inpoel, nshard, algorithm)
