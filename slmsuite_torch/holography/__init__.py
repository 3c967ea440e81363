"""Computational holography on the port: the hologram classes."""
