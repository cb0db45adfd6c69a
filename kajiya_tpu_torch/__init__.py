"""kajiya_tpu_torch: the PyTorch/CUDA port of the kajiya-tpu renderer.

Mirrors the JAX package `kajiya_tpu/` module for module (`core/`, `scene/`,
`ops/`, `rt/`, `brdf/`, `sky/`, `renderers/`, `world.py`, `frame.py`). Plain
tensor code is PyTorch; the Pallas TPU kernels on the ported path, and the
BVH walk of scenes above 262,144 triangles, are CUDA C++ kernels for Hopper
under `csrc/`, built with nvcc at first use (`ops/_native.py`); the host BVH
builder there (`csrc/bvh_builder.cpp`) is built with g++ (`rt/bvh.py`).

Float32 products stay full precision: the Woop intersector and the one-hot
selection math open cracks along shared triangle edges under TF32-rounded
products (docs/architecture.md, "Matmul precision"), so both TF32 switches
are turned off when the package is imported.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
