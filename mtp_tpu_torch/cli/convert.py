"""Checkpoint converter CLI: released PyTorch MTP weights → the port's
encoder file (the port's copy of `mtp_tpu/cli/convert.py`).

`python -m mtp_tpu_torch.cli.convert <ckpt.pth> <out.pth> --backbone
 vit_l_rvsa --img-size 512`

Applies the reference loaders' rules (prefix surgery, cls-token strip,
bicubic pos-embed / rel-pos interpolation: `ckpt/torch_convert.py`
`backbone_state_dict`) at the backbone and image size given, and writes the
state dict that `--pretrained` / `cli.test --ckpt` load.  A checkpoint
without the ViT's simple-FPN weights (an MAE encoder) is converted without
them.  `--scan` is accepted for the JAX CLI's sake and has no effect (the
port has one layout).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("ckpt")
    p.add_argument("out")
    p.add_argument("--backbone", default="vit_b_rvsa",
                   choices=["vit_b_rvsa", "vit_l_rvsa", "internimage_xl",
                            "internimage_t"])
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--scan", action="store_true",
                   help="accepted for the JAX CLI's sake; no effect")
    args = p.parse_args(argv)

    from mtp_tpu_torch import config as C
    from mtp_tpu_torch.ckpt.store import save_state_dict
    from mtp_tpu_torch.ckpt.torch_convert import (backbone_state_dict,
                                                  load_torch_checkpoint,
                                                  strip_prefixes)

    sd = load_torch_checkpoint(args.ckpt)
    if args.backbone.startswith("internimage"):
        cfg = C.internimage_backbone_config(args.backbone, args.img_size)
        params = backbone_state_dict(sd, cfg)
        desc = args.backbone
    else:
        cfg = getattr(C, args.backbone)(args.img_size)
        features_only = not any(k.startswith("fpn") for k in strip_prefixes(sd))
        params = backbone_state_dict(sd, cfg, features_only=features_only)
        desc = (f"{args.backbone} grid {args.img_size // cfg.patch_size}²"
                f"{' without the FPN' if features_only else ''}")
    save_state_dict(args.out, params)
    n = sum(v.numel() for v in params.values())
    print(f"wrote {args.out}: {n/1e6:.1f}M params ({desc})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
