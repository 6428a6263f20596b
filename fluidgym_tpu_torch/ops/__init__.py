"""Hand-written CUDA kernels for the H100 (sm_90a), one module per kernel:

* ``cg_cuda``: K1, the whole-solve Jacobi-PCG on one block (counterpart of
  ``fluidgym_tpu/ops/cg_pallas.py``);
* ``cg_cuda_mb``: over the merged super-block frame (counterpart of
  ``fluidgym_tpu/ops/cg_pallas_mb.py``): K2, the whole-solve right-Jacobi
  BiCGStab (single super-block, and merged multi-super-block "K2-mb"), and
  K3, the whole-solve Jacobi-PCG of multi-block pressure systems, with its
  strip-coarse two-level form K3-coarse;
* ``stencil_cuda``: K4, the fused 2D stencil apply of one block (counterpart
  of ``fluidgym_tpu/ops/stencil_pallas.py``), behind a default-off switch.

Each module holds the kernel's wrapper (which launches the kernel for CUDA
tensors and runs the plain PyTorch version for CPU tensors), the plain
version itself, and a launch counter on the wrapper.  The Krylov wrappers
take any number of lanes (one launch of a grid of lockstep chunks) and fold
a ``torch.func.vmap`` batch onto them (``cg_cuda.LaneFold``).  ``_build`` compiles
``csrc/`` with ``nvcc`` at first use; importing this package builds nothing.
"""
