"""Reference-genome base lookup (faidx equivalent).

The combine operator needs single reference bases to replace the "N"
placeholder REF for mid-interval records (reference
broad_combined_gvcf.cc:824-830 via VCFAdapter::get_reference_base_at_position
-> faidx).  Test fastas are small (10MB), so we load each contig once and
cache it.
"""

from __future__ import annotations

import gzip
from typing import Dict


class ReferenceGenome:
    def __init__(self, path: str):
        self.path = path
        self._contigs: Dict[str, str] = {}
        self._loaded = False

    def _load(self):
        if self._loaded:
            return
        opener = gzip.open if self.path.endswith(".gz") else open
        name = None
        chunks = []
        with opener(self.path, "rt") as f:
            for line in f:
                line = line.rstrip("\n")
                if line.startswith(">"):
                    if name is not None:
                        self._contigs[name] = "".join(chunks)
                    name = line[1:].split()[0]
                    chunks = []
                else:
                    chunks.append(line)
        if name is not None:
            self._contigs[name] = "".join(chunks)
        self._loaded = True

    def base_at(self, contig: str, pos_0based: int) -> str:
        """Uppercase base at 0-based position; 'N' when unavailable."""
        self._load()
        seq = self._contigs.get(contig)
        if seq is None or pos_0based < 0 or pos_0based >= len(seq):
            return "N"
        return seq[pos_0based].upper()
