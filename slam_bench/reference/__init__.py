"""Frozen plain-PyTorch copies of the port's code: the reference of ``check.py``."""
