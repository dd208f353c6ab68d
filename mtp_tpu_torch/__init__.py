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

Ported: semantic segmentation with UperNet on ViT-B/L+RVSA (patch 16 or 8)
or InternImage (DCNv3), sliding-window inference and the finetune step;
scene classification and Siamese change detection (UNet); Faster, Oriented
and Mask R-CNN (with CARAFE's upsample) and RetinaNet; multitask
pretraining; checkpoints, released-style `.pth` or JAX `.npz` encoders
loaded at another grid; the recipe registry, the CLI and the disk data
path; data parallel over processes (`parallel.mesh`, under torchrun) and
tensor parallelism over the model axis (`parallel.tensor`); the serving
artifact (`cli.export` traces a recipe's predict by `torch.export`, the
forward kernels registered ops in `kernels/ops.py`; `serving.load_artifact`
serves it without model code).  Nothing here imports jax or flax.
"""

__version__ = "0.1.0"
