"""An image's four Huffman tables on the host: built from a two-dispatch
first half's histograms (HuffmanTables) or decoded from the device table
build's spec (tables_from_spec). One image's four histograms travel as one
row of HIST_WIDTH counts, cut at HIST_SPLITS (split_histograms)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np
import torch

from ..bitstream.device_pack import exact_scan_bits
from ..utils.profiling import span
from .canonical import flat_code_arrays
from .spec import SymbolCodeLength, code_lengths_from_histogram

if TYPE_CHECKING:
    from ..pipeline import DeviceEncodeResult

# one image's histograms side by side: luma DC 16, luma AC 256, chroma DC
# 16, chroma AC 256
HIST_SPLITS = (16, 272, 288)
HIST_WIDTH = 544


def split_histograms(row) -> tuple:
    """[..., 544] -> (luma DC, luma AC, chroma DC, chroma AC)."""
    return tuple(row[..., a:b] for a, b in zip((0, *HIST_SPLITS), (*HIST_SPLITS, HIST_WIDTH)))


@dataclass
class HuffmanTables:
    """The four per-image code-length lists (descending length order),
    the OutputImage fields of the reference (src/image/writer/jpeg.rs:77-88)."""

    luma_dc: list[SymbolCodeLength]
    luma_ac: list[SymbolCodeLength]
    chroma_dc: list[SymbolCodeLength]
    chroma_ac: list[SymbolCodeLength]
    # the exact scan length these tables give the histograms they were built
    # from (from_host_histograms; None for tables decoded from a device spec)
    scan_bits: int | None = field(default=None, init=False, compare=False)
    _flat: tuple | None = field(default=None, init=False, repr=False, compare=False)

    @classmethod
    def from_histograms(cls, result: DeviceEncodeResult) -> "HuffmanTables":
        """Tables from a first half's histograms: the wait for the first half
        and the histograms' one copy (dmmt.hist_wait), then
        from_host_histograms (dmmt.host_tables)."""
        with span("dmmt.hist_wait"):
            _materialize_histograms(result)
        with span("dmmt.host_tables"):
            return cls.from_host_histograms(result.luma_dc_hist, result.luma_ac_hist,
                                            result.chroma_dc_hist, result.chroma_ac_hist)

    @classmethod
    def from_host_histograms(cls, luma_dc, luma_ac, chroma_dc, chroma_ac) -> "HuffmanTables":
        """Package-merge tables from four host (numpy) histograms, with their
        canonical codes (flat) and the exact scan length they give."""
        hists = (luma_dc, luma_ac, chroma_dc, chroma_ac)
        tables = cls(*(code_lengths_from_histogram(h) for h in hists))
        tables.scan_bits = exact_scan_bits(hists, *tables.flat())
        return tables

    def flat(self) -> tuple:
        """(codes[256], lens[256]) arrays of the four tables
        (flat_code_arrays), luma DC first; made once."""
        if self._flat is None:
            self._flat = tuple(flat_code_arrays(t) for t in (self.luma_dc, self.luma_ac,
                                                             self.chroma_dc, self.chroma_ac))
        return self._flat


def _materialize_histograms(result: DeviceEncodeResult) -> None:
    """Fetch all four histograms in ONE device->host copy (four fetches
    would each wait for the device) and keep them as numpy on the result."""
    if isinstance(result.luma_dc_hist, np.ndarray):
        return
    hists = (result.luma_dc_hist, result.luma_ac_hist, result.chroma_dc_hist,
             result.chroma_ac_hist)
    host = torch.cat([h.reshape(-1) for h in hists]).cpu().numpy()
    (result.luma_dc_hist, result.luma_ac_hist, result.chroma_dc_hist,
     result.chroma_ac_hist) = np.split(host, HIST_SPLITS)


def tables_from_spec(spec_syms, spec_lens, spec_ns) -> HuffmanTables:
    """Decode the device table spec (leaf-order symbols/lengths + present
    counts, [4, 256] / [4]) into host HuffmanTables."""
    lists = [
        [SymbolCodeLength(int(spec_syms[t, i]), int(spec_lens[t, i])) for i in range(int(spec_ns[t]))]
        for t in range(4)
    ]
    return HuffmanTables(
        luma_dc=lists[0], luma_ac=lists[1], chroma_dc=lists[2], chroma_ac=lists[3]
    )
