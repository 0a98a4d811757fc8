"""karpenter_tpu_torch — the node-provisioning solver on PyTorch and CUDA.

A port of `karpenter_tpu` (JAX) to an NVIDIA H100.  The cold provisioning
solve runs end to end here, topology spread included: host encode (numpy)
→ the FFD scan (light, or with the heavy per-domain step) and the explain
pack as hand-written CUDA kernels (`csrc/`) → host repair and decode, with
the host oracle for inexpressible groups and stranded pods.
The package imports `torch` and `numpy`, never `jax` or `karpenter_tpu`;
it keeps its own copies of the model, catalog and encoding modules.

Package layout (mirrors `karpenter_tpu`):
  models/      resources, label requirements, taints, Pod/Node/NodePool/...
  providers/   the generated instance-type catalog
  scheduling/  shared scheduling types, topology tracker, spot-risk model,
               the CPU oracle scheduler
  solver/      encode → ffd (kernels + plain PyTorch versions) → TorchSolver
  csrc/        CUDA C++ sources of the kernels, built with nvcc at first use
"""

__version__ = "0.1.0"
