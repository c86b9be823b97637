"""Launchers: ``serve.py`` and ``train.py`` (the serving and training
entry points), ``mesh.py`` (device meshes) and ``dryrun.py`` (the
fake-world dry-run and its roofline).

Import-light: no submodule is imported eagerly.
"""
