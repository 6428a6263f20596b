"""Solver: matrix-free stencils, Krylov solvers, PISO time integration."""
