"""quinoa_tpu_torch: the PyTorch + CUDA port of quinoa_tpu for one H100.

Module paths and public names mirror ``quinoa_tpu/`` so each function has a
findable counterpart.  The package imports torch, numpy and ctypes, never
jax; from ``quinoa_tpu`` it imports only the jax-free host modules
(``quinoa_tpu.mesh.{unsmesh,boxmesh,derived}`` and ``quinoa_tpu.native``).

The ported slice is the single-device DG(P1) compressible-Euler step with
the HLLC flux and the Superbee limiter (``inciter.dg.DGSolver``).  Its two
TPU kernel groups are hand-written CUDA kernels under ``csrc/``, built with
nvcc at first use (``kernels``); on CPU tensors every kernel wrapper runs
its plain torch version instead.
"""

__version__ = "0.1.0"
