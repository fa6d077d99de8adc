"""Host utilities of the torch port: env-knob reads and device choice."""
