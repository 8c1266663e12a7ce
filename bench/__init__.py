"""The benchmark of ``repro_torch``, the port on the H100: the harness, the
traffic generator, the plain references, the per-layer metric readers and
the yardstick's arithmetic.  ``bench/run.py`` runs one cell once; nothing
here imports JAX or the JAX package."""
