"""Flash attention forward: Hopper kernel, plain version and autograd op."""
