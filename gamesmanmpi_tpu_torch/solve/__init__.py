"""Solvers of the torch port (so far: the dense Connect-4 engine)."""
