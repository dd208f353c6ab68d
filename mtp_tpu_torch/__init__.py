"""mtp_tpu_torch — the PyTorch + CUDA port of `mtp_tpu` for NVIDIA Hopper.

The JAX package `mtp_tpu` is the reference; this package recomputes the same
functions in PyTorch, with every Pallas kernel of the ported paths replaced by
a CUDA C++ kernel written for `sm_90a` (sources in `csrc/`, built on first use
into `_build/` by `kernels/_build.py`).

Dispatch is by device, with no switch: a kernel wrapper given CPU tensors
runs its plain PyTorch version, given CUDA tensors it launches the kernel or
raises.  Public functions keep the JAX package's layouts (NHWC images and
features, `(W, nH, N, D)` / `(BH, N, D)` attention tensors) and the modules
use the reference torch parameter names, so `mtp_tpu.ckpt` converters read a
port `state_dict()` unchanged.

Ported so far: semantic segmentation with UperNet on ViT-B/L+RVSA or
InternImage (DCNv3), sliding-window inference and the finetune step.
Nothing here imports jax or flax.
"""

__version__ = "0.1.0"
