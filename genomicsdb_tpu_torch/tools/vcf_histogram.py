"""Column histogram over raw VCFs -> balanced column partitions.

The reference's vcf_histogram tool (tools/src/vcf_histogram.cc +
include/utils/histogram.h:119 UniformHistogram): counts cells per
uniform column bin straight from the input VCFs (no array needed) and
equi-partitions the flattened genome axis so each loader rank gets the
same expected cell count.  Output is a loader-JSON-ready
"column_partitions" list.

Usage:
  python -m genomicsdb_tpu_torch.tools.vcf_histogram <loader.json> \
      [--bin-size N] [--num-partitions K] [--workspace WS] [--array A]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

import numpy as np

from ..core.config import ImportParams
from ..core.vid import VidMapper
from ..vcf.reader import open_text


class UniformHistogram:
    """Fixed-width bin counts over [0, max_column) (histogram.h:119)."""

    def __init__(self, max_column: int, bin_size: int):
        self.bin_size = max(int(bin_size), 1)
        self.num_bins = (max_column + self.bin_size - 1) // self.bin_size
        self.counts = np.zeros(max(self.num_bins, 1), dtype=np.int64)

    def add(self, column: int, count: int = 1) -> None:
        b = min(column // self.bin_size, len(self.counts) - 1)
        self.counts[b] += count

    def equi_partition(self, k: int) -> List[int]:
        """Begin columns of k partitions with ~equal cell counts."""
        total = int(self.counts.sum())
        if total == 0 or k <= 1:
            return [0]
        target = total / k
        cum = np.cumsum(self.counts)
        begins = [0]
        for i in range(1, k):
            b = int(np.searchsorted(cum, target * i, side="left"))
            col = min(b, len(self.counts) - 1) * self.bin_size
            if col > begins[-1]:
                begins.append(col)
        return begins


def histogram_from_files(paths: List[str], vid: VidMapper,
                         bin_size: int) -> UniformHistogram:
    max_col = max((c.offset + c.length
                   for c in vid.contigs.values()), default=1)
    h = UniformHistogram(max_col, bin_size)
    for path in paths:
        f = open_text(path)
        try:
            for line in f:
                if line.startswith("#"):
                    continue
                cols = line.split("\t", 2)
                try:
                    col = vid.contig_offset(cols[0]) + int(cols[1]) - 1
                except (KeyError, ValueError):
                    continue
                h.add(col)
        finally:
            f.close()
    return h


def main(argv=None):
    p = argparse.ArgumentParser(prog="vcf_histogram")
    p.add_argument("loader_json")
    p.add_argument("--bin-size", type=int, default=1_000_000)
    p.add_argument("--num-partitions", type=int, default=0,
                   help="also print an equi-partitioned "
                        "column_partitions JSON")
    p.add_argument("--workspace", default="/tmp/ws")
    p.add_argument("--array", default="array")
    args = p.parse_args(argv)
    ip = ImportParams.from_file(args.loader_json, 0)
    vid = VidMapper.from_files(ip.resolve(ip.vid_mapping_file),
                               ip.resolve(ip.callset_mapping_file))
    from ..store.import_pipeline import _resolve_input
    files = sorted({cs.filename for cs in vid.callsets.values()})
    paths = [_resolve_input(f, ip.base_dir, vid) for f in files]
    h = histogram_from_files(paths, vid, args.bin_size)
    nz = np.nonzero(h.counts)[0]
    for b in nz:
        sys.stdout.write(
            f"{int(b) * h.bin_size}\t{int(h.counts[b])}\n")
    if args.num_partitions > 1:
        begins = h.equi_partition(args.num_partitions)
        parts = [{"begin": int(b), "workspace": args.workspace,
                  "array_name": f"{args.array}_{i}"}
                 for i, b in enumerate(begins)]
        sys.stdout.write(json.dumps({"column_partitions": parts}) + "\n")


if __name__ == "__main__":
    main()
