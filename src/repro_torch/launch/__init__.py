"""Launchers: ``serve.py``, the serving entry point.

Import-light: no submodule is imported eagerly.  The JAX package's mesh,
dry-run and training launchers come with their slices (ROADMAP.md,
Queue 1).
"""
