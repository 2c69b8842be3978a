"""repro_torch — the SeqPoint reproduction ported to PyTorch and CUDA.

Mirrors ``src/repro`` module by module (the JAX package stays the
reference). Entry points take ``device=`` and run on ``"cuda"`` unless the
caller asks for ``"cpu"``; see ``repro_torch.device``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
