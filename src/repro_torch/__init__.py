"""PyTorch/CUDA port of the JAX package ``repro``.

The layout follows the JAX package (``configs``, ``models``, ``kernels``,
``runtime``, ``launch``) so that every module's counterpart is easy to find.
The port imports ``torch`` and numpy and nothing of the JAX package.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
