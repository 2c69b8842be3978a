"""Mamba-1 selective scan: Hopper kernel, plain version and autograd op."""
