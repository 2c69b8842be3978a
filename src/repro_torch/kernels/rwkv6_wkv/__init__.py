"""RWKV-6 WKV: Hopper kernel, plain version and autograd op."""
