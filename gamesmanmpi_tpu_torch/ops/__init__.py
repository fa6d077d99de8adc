"""Tensor ops of the torch port: the negamax combine and the window gather."""
