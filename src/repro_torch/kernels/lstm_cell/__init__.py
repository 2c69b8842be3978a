"""Fused LSTM cell: Hopper kernel, plain version and autograd op."""
