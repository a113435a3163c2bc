"""DG operators, the compressible-Euler system, EoS, problems, limiter."""
