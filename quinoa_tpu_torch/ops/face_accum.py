"""Face-state gathers and face -> element accumulation of the face
Gauss-point DG path.

Port of quinoa_tpu/ops/face_accum.py gather_left_states and
accumulate_faces.  The TPU versions run one-hot window matmuls over el-
and er-sorted face tiles because a TPU core cannot gather or scatter in
HBM; here each is one kernel that gathers directly:

- K5 face_gather (csrc/face_gather.cu), one thread per face: U[:, idx]
  for idx = el (the TPU kernel's job) and for idx = er;
- K6 face_accum (csrc/face_accum.cu), one thread per element: the sum of
  its four faces' rows through fose/fsideR, in slot order, on top of a
  base (the volume term).

On a CPU tensor each runs its plain torch version; on a CUDA tensor it
launches the kernel.
"""

from __future__ import annotations

import torch

from .. import kernels


def face_gather_plain(U, idx):
    """K5's plain version: U[:, idx], (R, F)."""
    return U[:, idx.long()]


def face_gather(U, idx):
    """U (R, E) -> (R, F): the rows of element idx[f] for every face."""
    if U.device.type == "cpu":
        return face_gather_plain(U, idx)
    return kernels.face_gather(U, idx)


def accumulate_faces_plain(geom, contribL, contribR, base=None):
    """K6's plain version: each element gathers its four faces in slot
    order (quinoa_tpu/pde/dg.py:446-449) on top of base."""
    r = contribL.new_zeros((contribL.shape[0], geom.nelem)) if base is None \
        else base
    for i in range(4):
        f = geom.fose[i].long()
        r = r + torch.where(geom.fsideR[i] > 0, contribR[:, f],
                            contribL[:, f])
    return r


def accumulate_faces(geom, contribL, contribR, base=None):
    """contribL/R (R, F) -> (R, E) accumulated element contributions (el
    takes every face's left row, er an interior face's right row), on
    top of base (R, E) when given."""
    if contribL.device.type == "cpu":
        return accumulate_faces_plain(geom, contribL, contribR, base)
    return kernels.face_accum(contribL, contribR, geom.fose, geom.fsideR,
                              base)
