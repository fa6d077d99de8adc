"""Value algebra and bit primitives of the torch port."""
