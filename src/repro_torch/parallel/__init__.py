"""Gradient accumulation and int8 error-feedback compression
(``gradsync``).  The reference's ``parallel/sharding.py`` is not ported:
the port has no mesh."""
