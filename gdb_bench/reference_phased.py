"""The plain reference of `reference.py` for cohorts whose vid stores
GT's phase (GT `length` "PP"): each call's GT renders as GenomicsDB's
`encode_GT_vector` renders it without `produce_GT_field`, every allele
`.` and every separator as the input call wrote it.  A haploid call is
`.`, an unphased diploid call `./.` and a phased one `.|.`, a call
remapped at a spanning deletion too.  Where the vid stores no phase
(length "P"), every separator is `/`, as in `reference.Cohort`, so on
unphased cohorts the two render the same bytes.

NumPy and Python only; nothing of the program.
"""

from __future__ import annotations

import json
import re
from typing import Sequence

from .reference import MISSING, Cohort as _Cohort

_SEPARATOR = re.compile(r"([/|])")


def gt_text(gt: str, phased: bool) -> str:
    """A call's input GT with every allele written `.`: its separators
    as written where the phase is stored, else each `/`."""
    parts = _SEPARATOR.split(gt)
    return "".join("." if i % 2 == 0 else (sep if phased else "/")
                   for i, sep in enumerate(parts))


class Cohort(_Cohort):
    """`reference.Cohort` with each call's GT phase separators."""

    def __init__(self, vcf_paths: Sequence[str], vid_path: str):
        super().__init__(vcf_paths, vid_path)
        with open(vid_path) as f:
            gt = json.load(f)["fields"].get("GT", {})
        self.phased = gt.get("length") == "PP"

    def _block(self, g: int, r: int, remaps, out_fmt) -> str:
        """The tab-joined sample columns of file g's calls (record r);
        `reference.Cohort._block` but for GT's separators."""
        rkey = tuple(m.key for m in remaps)
        key = (g, r, rkey, out_fmt)
        got = self._blocks.get(key)
        if got is not None:
            return got
        f = self.files[g]
        fmt = f.fmt[r]
        at = fmt.index("GT") if "GT" in fmt else None
        cells = self._rendered.setdefault((fmt, rkey, out_fmt), {})
        out = []
        for text in f.cells(r):
            c = cells.get(text)
            if c is None:
                ploidy, vals = self._parse(fmt, text)
                for m in remaps:
                    vals = m.apply(ploidy, vals)
                if at is None:
                    parts = [""]
                else:
                    fields = text.split(":")
                    parts = [gt_text(fields[at] if at < len(fields)
                                     else ".", self.phased)]
                for name in out_fmt[1:]:
                    v = vals.get(name)
                    parts.append("." if v is None else ",".join(
                        "." if x == MISSING else str(x) for x in v))
                c = cells[text] = ":".join(parts)
            out.append(c)
        got = self._blocks[key] = "\t".join(out)
        return got
