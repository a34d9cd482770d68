"""The plain reference: scoring in each stated precision, the comparison
that decides `correct`, and the lower-precision control. It imports torch
and numpy only: nothing of the port, of JAX or of the JAX package."""
