"""The port's operators.  Importing any of them registers the forward
kernels' ops, `torch.ops.mtp.*` (`kernels/ops.py`), which the wrappers of
`fused_attn`, `dcnv3_sample`, `nms` and `rotated_boxes` call: `kernels/ops.py`
imports those four modules, none of which imports it back."""

from mtp_tpu_torch.kernels import ops as _registered  # noqa: F401
