"""Launchers: ``serve.py`` and ``train.py``, the serving and training
entry points.

Import-light: no submodule is imported eagerly.  The JAX package's mesh
and dry-run launchers come with the DTensor slice (ROADMAP.md, Queue 1).
"""
