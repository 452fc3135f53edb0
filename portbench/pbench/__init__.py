"""The benchmark of ``veneur_tpu_torch``: traffic plans and their
encoders, the cell drivers, the trace reduction and the result line.

Nothing here imports ``jax`` or the JAX package; the program under test
(``veneur_tpu_torch``) is imported only by the cell drivers, never by
the traffic generators or the plain reference."""
