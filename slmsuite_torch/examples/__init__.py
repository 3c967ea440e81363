"""The example scripts, written against the port (each runs as a script or
through its ``main``)."""
