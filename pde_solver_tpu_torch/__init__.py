"""pde_solver_tpu_torch — the PyTorch/CUDA port of ``pde_solver_tpu``.

Same discretisation, solvers and precision scheme as the JAX package, with
plain tensor code in eager PyTorch and the hot stencil SpMV as a CUDA kernel
written for Hopper (``csrc/flat_stencil_spmv.cu``, bound in
``ops.stencil_kernels``).  The package never imports JAX.

The device comes from ``SolverConfig.device`` (default ``"cuda"``); nothing
moves to the CPU on its own when CUDA is missing.

TF32 is switched off for float32 matrix products and convolutions: the MG
coarsest solve ``Ainv @ r`` must run in full float32, because an inexact
coarse solve makes the V-cycle preconditioner indefinite.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
