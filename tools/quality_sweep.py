"""Q-sweep quality table for QUALITY.md — the reference's Table 4.1
analog (report p.30; BASELINE.json config "quality sweep Q10-Q95"),
extended with the color path the reference lacks.

Encodes lena.bmp (the reference's canonical test image) at a quality
ladder in grayscale and 4:2:0 color, decodes with PIL (libjpeg), and
prints a markdown table of PSNR / file size / CR / BPP per rung.

Usage: python tools/quality_sweep.py [image.bmp] [--full-corpus]
"""
import io
import os
import sys

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from jpegtpu import color_pipeline, compile_cache, pipeline
from jpegtpu.analysis import psnr
from jpegtpu.config import EncodeConfig

QS = (10, 25, 50, 75, 90)


def sweep(path: str):
    name = os.path.basename(path)
    rgb = np.asarray(Image.open(path).convert("RGB"))
    gray = np.asarray(Image.open(path).convert("L"))
    h, w = gray.shape
    raw_bits_gray = h * w * 8
    raw_bits_rgb = h * w * 24

    print(f"\n### {name} ({w}x{h})\n")
    print("| Q | gray PSNR [dB] | gray bytes | gray CR | gray BPP |"
          " color PSNR [dB] | color bytes | color CR | color BPP |")
    print("|---:|---:|---:|---:|---:|---:|---:|---:|---:|")
    for q in QS:
        g = pipeline.encode_grayscale(gray, EncodeConfig(quality=q))
        dg = np.asarray(Image.open(io.BytesIO(g)).convert("L"), float)
        pg = psnr(gray.astype(float), dg)
        crg = raw_bits_gray / (8 * len(g))
        bppg = 8 * len(g) / (h * w)

        c = color_pipeline.encode_color(
            rgb, EncodeConfig(quality=q, subsampling="420")
        )
        dc = np.asarray(Image.open(io.BytesIO(c)).convert("RGB"), float)
        pc = np.mean(
            [psnr(rgb[..., k].astype(float), dc[..., k]) for k in range(3)]
        )
        crc = raw_bits_rgb / (8 * len(c))
        bppc = 8 * len(c) / (h * w)
        print(
            f"| {q} | {pg:.2f} | {len(g)} | {crg:.1f}:1 | {bppg:.3f} "
            f"| {pc:.2f} | {len(c)} | {crc:.1f}:1 | {bppc:.3f} |"
        )


def main():
    compile_cache.enable()
    args = [a for a in sys.argv[1:] if not a.startswith("-")]
    paths = args or ["/root/reference/assets/input/lena.bmp"]
    if "--full-corpus" in sys.argv:
        d = "/root/reference/assets/input"
        paths = sorted(
            os.path.join(d, f) for f in os.listdir(d) if f.endswith(".bmp")
        )
    for p in paths:
        sweep(p)


if __name__ == "__main__":
    main()
