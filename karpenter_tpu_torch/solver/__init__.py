"""The solver: host encode → FFD scan + result pack on the card → decode.

`TorchSolver` (solve.py) is the entry point; `ffd` holds the kernel
wrappers and their plain PyTorch versions, `_cuda` builds and binds the
CUDA sources under `karpenter_tpu_torch/csrc/`.  Exports resolve lazily so
that importing the jax-free vocabulary modules never imports torch.
"""

__all__ = ["TorchSolver", "UnsupportedPods"]


def __getattr__(name):
    if name in __all__:
        from karpenter_tpu_torch.solver import solve as _solve
        return getattr(_solve, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
