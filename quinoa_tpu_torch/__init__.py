"""quinoa_tpu_torch: the PyTorch + CUDA port of quinoa_tpu for one H100.

Module paths and public names mirror ``quinoa_tpu/`` so each function has a
findable counterpart.  The package imports torch, numpy and ctypes, and
nothing of jax or of ``quinoa_tpu``: its host mesh passes are its own
numpy copies (``mesh``).

The port covers single-device DG (``inciter.dg.DGSolver``): the DG(P1)
compressible-Euler step with the HLLC flux and the Superbee limiter, its
p-adaptive variant, the face Gauss-point path of scalar transport and
Dirichlet/inlet faces, and unlimited DG(P0) and DG(P2) (with a
manufactured source where the problem has one); multi-material DG(P0)
and DG(P1) (``pde.multimat.MultiMatSolver``, AUSM+up); and single-device
ALECG (``inciter.alecg``) and DiagCG + FCT
(``inciter.diagcg``) for scalar transport and compressible Euler.  The
TPU kernels of these paths are hand-written CUDA kernels under
``csrc/``, built with nvcc at first use (``kernels``); on CPU tensors
every kernel wrapper runs its plain torch version instead.  The builders
put their tensors on the card unless given another device (``device``).

``python -m quinoa_tpu_torch inciter -c deck.q -i mesh`` (``cli``) runs a
control deck as quinoa_tpu's inciter command does, through the port's
own deck parser and config (``control``), mesh and diagnostics I/O
(``io``), field output and checkpoints (``inciter.fieldout``,
``inciter.checkpoint``).

The parallel layer (``parallel``: partitioners, shards, the sharded DG,
multimat, DiagCG and ALECG solvers, overdecomposition) runs those
solvers over S shards from one controller, shard s on a list of devices'
entry s % n (on one card, all of them), for the command's ``--npes``,
``-u``, ``--slices``, ``--pieces`` and ``--lbfreq``.

The walker (``walker``, ``python -m quinoa_tpu_torch walker -c deck.q``)
integrates SDE ensembles (``diffeq``) with moments and PDFs
(``statistics``) in eager torch, drawing jax.random's Threefry streams
bit for bit (``rng``), on one tensor or split over shards (``--npes``).
"""

__version__ = "0.1.0"
