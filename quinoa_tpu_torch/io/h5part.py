"""H5Part particle-trajectory writer (src/IO/H5PartWriter.cpp analog).

The port's own copy of quinoa_tpu/io/h5part.py, writing the same layout:
one group per output step named ``Step#<i>`` with a float64 ``TimeValue``
attribute and equally-sized float64 1-D datasets x, y, z (and any extra
per-particle fields).  h5py is imported when a writer is made, not when
this module is.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class H5PartWriter:
    def __init__(self, path: str):
        import h5py

        self._f = h5py.File(path, "w")
        self._step = 0

    def write(self, xyz: np.ndarray,
              fields: Optional[Dict[str, np.ndarray]] = None,
              time: Optional[float] = None):
        """xyz: (npar, 3) positions; fields: extra per-particle arrays."""
        g = self._f.create_group(f"Step#{self._step}")
        if time is not None:
            g.attrs["TimeValue"] = float(time)
        g.create_dataset("x", data=np.asarray(xyz[:, 0], dtype=np.float64))
        g.create_dataset("y", data=np.asarray(xyz[:, 1], dtype=np.float64))
        g.create_dataset("z", data=np.asarray(xyz[:, 2], dtype=np.float64))
        for k, v in (fields or {}).items():
            g.create_dataset(k, data=np.asarray(v, dtype=np.float64))
        self._step += 1

    def close(self):
        self._f.close()
