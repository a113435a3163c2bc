"""The plain reference of the benchmark's configurations: DG(P1) with
Superbee limiting and SSP-RK3 in ordinary torch operations, on geometry
derived here from the raw mesh.  It imports nothing of the program under
test and takes nothing the program made."""
