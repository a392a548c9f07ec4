"""Hasher backends behind the ``Hasher`` seam."""
