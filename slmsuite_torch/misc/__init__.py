"""Miscellaneous helpers of the port."""
