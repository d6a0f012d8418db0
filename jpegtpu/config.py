"""Encoder configuration.

The reference has no config system at all (SURVEY.md §5.6): quality, tables
and layout are compile-time constants. This framework makes them first-class.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from . import tables


@dataclasses.dataclass(frozen=True)
class EncodeConfig:
    """Configuration for one encode.

    Attributes:
      quality: IJG quality factor in [1, 100]. 50 = Annex-K base tables,
        the reference's fixed operating point (jpeg_tables.c:3-12).
      subsampling: "gray" (1 component, parity with the reference),
        "420", "422" or "444" for color.
      restart_interval: MCUs between RSTn markers. 0 = none (single
        DC-predictor chain over the whole image, reference semantics,
        rle.c:59-70). Multi-chip sharding sets this per shard.
      pad_ones: pad the final partial byte with 1s (T.81 spec / the DSP
        build, dsp huffman.c:179-187) or 0s (natural_c huffman.c:65-81).
      bitexact: use the reference's 6-decimal DCT basis literals so the
        quantized coefficients bit-match natural_c (tables.dct_basis_reference);
        otherwise use the true orthonormal basis.
      dct_dtype: accumulation dtype for the DCT matmuls.
      entropy: "device" runs RLE+Huffman+bit packing on the device (entropy.device)
        so only compressed bytes cross the host boundary; "host" uses the
        vectorized numpy coder (entropy.host).
      optimize_huffman: 2-pass optimal Huffman tables (the libjpeg
        optimize_coding capability, which the reference's hardwired
        Annex-K tables forgo): pass 1 gathers per-class symbol
        histograms, package-merge builds length-limited optimal specs,
        and the scan + DHT segments use them. With entropy="device" both
        passes run on device (on-device histograms, then the same encode
        program with the tables as runtime data — two dispatches, ~2 KB
        host traffic); entropy="host" runs both passes on the host.
      capacity_words_per_block: static per-block output capacity (uint32
        words) for the device packer. The default (8 words = 4 bpp) covers
        photographic content with wide margin; overflow is detected and the
        encode transparently retried at the worst-case bound.
    """

    quality: int = 50
    subsampling: str = "gray"
    restart_interval: int = 0
    pad_ones: bool = True
    bitexact: bool = True
    dct_dtype: str = "float32"
    entropy: str = "device"
    capacity_words_per_block: int = 8
    stuff: str = "host"
    optimize_huffman: bool = False

    def __post_init__(self):
        if not 1 <= self.quality <= 100:
            raise ValueError(f"quality must be in [1, 100], got {self.quality}")
        if not 0 <= self.restart_interval <= 0xFFFF:
            # DRI's interval payload is a 16-bit field (T.81 B.2.4.4).
            raise ValueError(
                f"restart_interval must be in [0, 65535], got {self.restart_interval}"
            )
        if self.subsampling not in ("gray", "420", "422", "444"):
            raise ValueError(f"unknown subsampling {self.subsampling!r}")
        if self.entropy not in ("device", "host"):
            raise ValueError(f"unknown entropy backend {self.entropy!r}")
        if self.stuff not in ("host", "device"):
            raise ValueError(f"unknown stuffing mode {self.stuff!r}")

    @property
    def luma_quant(self) -> np.ndarray:
        return tables.quality_scaled_table(tables.STD_LUMINANCE_QUANT, self.quality)

    @property
    def chroma_quant(self) -> np.ndarray:
        return tables.quality_scaled_table(tables.STD_CHROMINANCE_QUANT, self.quality)

    @property
    def n_components(self) -> int:
        return 1 if self.subsampling == "gray" else 3

    def dct_basis(self) -> np.ndarray:
        dt = np.dtype(self.dct_dtype)
        if self.bitexact:
            return tables.dct_basis_reference(dt)
        return tables.dct_basis(dt)
