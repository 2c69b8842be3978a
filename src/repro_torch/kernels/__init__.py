"""Hand-written Hopper kernels. Each kernel follows the JAX package's layout:
``<name>/kernel.py`` (launch) with its CUDA source under ``<name>/csrc/``,
``ops.py`` (the differentiable op) and ``ref.py`` (the plain version)."""
import torch


def plain_vjp(fn, inputs, gy, gs=None):
    """The VJP of a plain version ``fn(*inputs) -> (y, final state)``: the
    gradients of ``inputs`` (None for a None input) for the cotangent
    ``gy`` of y and ``gs`` of the final state (None: zeros). The backward
    kernels' yardstick and the CPU route of their ops."""
    inputs = [None if t is None else t.detach().requires_grad_()
              for t in inputs]
    with torch.enable_grad():
        y, st = fn(*inputs)
    live = [t for t in inputs if t is not None]
    outs, cots = [y], [gy]
    if gs is not None:
        outs.append(st)
        cots.append(gs)
    # allow_unused: at S = 1 with no state cotangent, y does not depend on
    # the last step's decay
    grads = iter(torch.autograd.grad(outs, live, cots, allow_unused=True,
                                     materialize_grads=True))
    return tuple(None if t is None else next(grads) for t in inputs)
