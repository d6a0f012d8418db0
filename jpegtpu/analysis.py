"""Quality analysis: MSE / PSNR / SSIM / compression ratio / bits-per-pixel.

The counterpart of the reference's analysis layer
(analyze_results.py:17-140 + run_analysis.sh): same metrics, same
gray-conversion convention (PIL 'L'), same 3-panel difference figure.
SSIM is computed with the standard Gaussian-window formulation
(Wang et al. 2004, the algorithm scikit-image implements) via scipy,
since scikit-image is not available in this environment.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np


@dataclasses.dataclass
class AnalysisResult:
    original: str
    compressed: str
    width: int
    height: int
    mse: float
    psnr_db: float
    ssim: float
    original_bytes: int
    compressed_bytes: int
    compression_ratio: float
    bits_per_pixel: float


def mse(a: np.ndarray, b: np.ndarray) -> float:
    """Mean squared error (analyze_results.py:17-24)."""
    return float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    """Peak signal-to-noise ratio in dB (analyze_results.py:26-32)."""
    m = mse(a, b)
    return float("inf") if m == 0 else 10.0 * np.log10(peak * peak / m)


def ssim(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    """Structural similarity with scikit-image's DEFAULT settings (7x7
    uniform window, sample covariance, border crop) — the exact call the
    reference makes (analyze_results.py:84), reimplemented on scipy since
    scikit-image is absent here. Verified against the reference report's
    Table 4.1 SSIM column."""
    from scipy.ndimage import uniform_filter

    a = a.astype(np.float64)
    b = b.astype(np.float64)
    win = 7
    nper = win * win
    cov_norm = nper / (nper - 1)  # sample covariance
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    ux = uniform_filter(a, win)
    uy = uniform_filter(b, win)
    uxx = uniform_filter(a * a, win)
    uyy = uniform_filter(b * b, win)
    uxy = uniform_filter(a * b, win)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux**2 + uy**2 + c1) * (vx + vy + c2)
    )
    pad = (win - 1) // 2
    return float(s[pad:-pad, pad:-pad].mean())


def analyze_pair(
    original_path: str, compressed_path: str, diff_path: Optional[str] = None
) -> AnalysisResult:
    """Compare an original image file against its compressed JPEG
    (analyze_results.py:44-98): both converted to gray 'L', original
    resized if dims differ, metrics computed, optional 3-panel figure."""
    from PIL import Image

    orig_img = Image.open(original_path).convert("L")
    comp_img = Image.open(compressed_path).convert("L")
    if orig_img.size != comp_img.size:
        orig_img = orig_img.resize(comp_img.size)
    a = np.asarray(orig_img)
    b = np.asarray(comp_img)

    osize = os.path.getsize(original_path)
    csize = os.path.getsize(compressed_path)
    w, h = comp_img.size
    result = AnalysisResult(
        original=original_path,
        compressed=compressed_path,
        width=w,
        height=h,
        mse=mse(a, b),
        psnr_db=psnr(a, b),
        ssim=ssim(a, b),
        original_bytes=osize,
        compressed_bytes=csize,
        compression_ratio=osize / csize,
        bits_per_pixel=8.0 * csize / (w * h),
    )
    if diff_path:
        save_difference_figure(a, b, result, diff_path)
    return result


def save_difference_figure(
    a: np.ndarray, b: np.ndarray, result: AnalysisResult, path: str
) -> None:
    """3-panel figure: original / compressed / |difference| with a metrics
    strip (analyze_results.py:100-140)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    fig, axes = plt.subplots(1, 3, figsize=(15, 6))
    for ax, img, title, kw in (
        (axes[0], a, "Original", {"cmap": "gray", "vmin": 0, "vmax": 255}),
        (axes[1], b, "Compressed", {"cmap": "gray", "vmin": 0, "vmax": 255}),
        (axes[2], diff, "Absolute difference", {"cmap": "jet"}),
    ):
        im = ax.imshow(img, **kw)
        ax.set_title(title)
        ax.axis("off")
    fig.colorbar(im, ax=axes[2], fraction=0.046)
    fig.suptitle(
        f"MSE {result.mse:.2f} | PSNR {result.psnr_db:.2f} dB | "
        f"SSIM {result.ssim:.4f} | CR {result.compression_ratio:.1f}:1 | "
        f"BPP {result.bits_per_pixel:.3f}"
    )
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def format_report(r: AnalysisResult) -> str:
    return (
        f"{r.original} vs {r.compressed} ({r.width}x{r.height})\n"
        f"  MSE:  {r.mse:.2f}\n"
        f"  PSNR: {r.psnr_db:.2f} dB\n"
        f"  SSIM: {r.ssim:.4f}\n"
        f"  CR:   {r.compression_ratio:.1f}:1\n"
        f"  BPP:  {r.bits_per_pixel:.3f}"
    )
