"""Semantic-segmentation task, inference half (port of the `predict_fn` of
`mtp_tpu/tasks/segmentation.py`): the segmentor on each crop, logits
resized to the crop, averaged over the slide grid, arg-maxed per pixel."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from mtp_tpu_torch.config import SlideConfig
from mtp_tpu_torch.eval.slide import slide_inference
from mtp_tpu_torch.models.segmentor import Segmentor


class SegmentationTask:
    """`slide` is the recipe's default geometry (None: whole images)."""

    def __init__(self, model: Segmentor, num_classes: int,
                 slide: Optional[SlideConfig] = None):
        self.model = model
        self.num_classes = num_classes
        self.slide = slide

    @torch.no_grad()
    def slide_logits(self, images: torch.Tensor,
                     slide: Optional[SlideConfig] = None) -> torch.Tensor:
        """(B, H, W, 3) → fp32 logits (B, H, W, num_classes), eval mode."""
        slide = slide or self.slide
        self.model.eval()
        if slide is None:
            return self.model.predict(images).float()
        return slide_inference(self.model.predict, images, self.num_classes,
                               slide)

    def predict_fn(self, slide: Optional[SlideConfig] = None
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
        """images (B, H, W, 3) → per-pixel class ids (B, H, W)."""
        return lambda images: self.slide_logits(images, slide).argmax(-1)
