"""Tensor ops of the torch port: the negamax combine, the window gather
and the dense engine's level steps."""
