"""CLI for the checkpoint conversion kit — see the package docstring.

The JAX package's subcommands and flags. ``onnx-flax``, ``inception``,
``lpips-backbone`` and ``hf-flax`` write the formats both packages read.

Examples::

    python -m torchmetrics_tpu_torch.convert inception pt_inception-2015-12-05-6726825d.pth \
        -o weights/inception.npz
    python -m torchmetrics_tpu_torch.convert lpips-backbone vgg16-397923af.pth --net vgg -o weights/vgg.npz
    python -m torchmetrics_tpu_torch.convert onnx-flax DNSMOS/model_v8.onnx -o weights/dnsmos/model_v8
    python -m torchmetrics_tpu_torch.convert hf-flax /data/hf/roberta-large -o weights/roberta-large
    python -m torchmetrics_tpu_torch.convert hf-flax /data/hf/clip-vit-base-patch16 \
        --model-class FlaxCLIPModel -o weights/clip-vit-base-patch16
"""

from __future__ import annotations

import argparse
import os
import sys

from torchmetrics_tpu_torch.convert import convert_hf_flax, convert_inception, convert_lpips_backbone


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m torchmetrics_tpu_torch.convert",
        description="Convert locally provided checkpoints to the port's artifacts.",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p_inc = sub.add_parser("inception", help="torch-fidelity FID Inception-v3 .pth -> .npz")
    p_inc.add_argument("checkpoint", help="path to pt_inception-2015-12-05-*.pth")
    p_inc.add_argument("-o", "--out", default="inception.npz", help="output npz path")

    p_lpips = sub.add_parser("lpips-backbone", help="torchvision backbone .pth -> .npz")
    p_lpips.add_argument("checkpoint", help="torchvision alexnet/vgg16/squeezenet1_1 .pth")
    p_lpips.add_argument("--net", required=True, choices=("alex", "vgg", "squeeze"))
    p_lpips.add_argument("-o", "--out", default=None, help="output npz path (default {net}.npz)")

    p_hf = sub.add_parser("hf-flax", help="local HF snapshot (torch weights) -> flax directory")
    p_hf.add_argument("model_path", help="local HF model directory")
    p_hf.add_argument("-o", "--out", required=True, help="output directory")
    p_hf.add_argument(
        "--model-class",
        default=None,
        help="transformers Flax class name (e.g. FlaxCLIPModel); default FlaxAutoModel",
    )

    p_onnx = sub.add_parser(
        "onnx-flax", help="ONNX inference graph (e.g. DNSMOS model_v8/sig_bak_ovr) -> converted graph dir"
    )
    p_onnx.add_argument("onnx_path", help="path to the .onnx file")
    p_onnx.add_argument("-o", "--out", required=True, help="output directory")

    args = parser.parse_args(argv)
    if args.command == "inception":
        out = convert_inception(args.checkpoint, args.out)
        manifest_anchor = os.path.dirname(os.path.abspath(out))
    elif args.command == "lpips-backbone":
        out = convert_lpips_backbone(args.checkpoint, args.net, args.out or f"{args.net}.npz")
        manifest_anchor = os.path.dirname(os.path.abspath(out))
    elif args.command == "onnx-flax":
        from torchmetrics_tpu_torch.convert.onnx_torch import convert_onnx_flax

        out = convert_onnx_flax(args.onnx_path, args.out)
        manifest_anchor = os.path.abspath(out)
    else:
        out = convert_hf_flax(args.model_path, args.out, model_class=args.model_class)
        manifest_anchor = os.path.abspath(out)
    print(f"wrote {out} (manifest: {os.path.join(manifest_anchor, 'MANIFEST.json')})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
