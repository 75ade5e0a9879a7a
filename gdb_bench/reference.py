"""The plain reference of the combined gVCF, worked out from the gVCF
files themselves (numpy and Python only; nothing of the program).

It follows GenomicsDB's `--produce-Broad-GVCF` (CombineGVCFs)
semantics as they apply to multi-sample gVCF input whose FORMAT is
HaplotypeCaller's `GT:AD:DP:GQ:MIN_DP:PL` and whose INFO carries END,
DP, BaseQRankSum (median), MQ0 (median) and RAW_MQ (ordered float32
sum), imported with deletions treated as intervals and queried without
a reference genome and without `produce_GT_field`:

- The sweep.  Every sample of one file shares that file's records, so
  the sweep runs over files: a record is live from its column to its
  END (a deletion to the end of its REF); a new output record starts
  wherever a record starts or the previous one ends, and while any live
  record holds a deletion every position is a record of its own.  A
  query interval clips the first and last record.
- Spanning deletions.  A deletion record that began before the output
  position becomes `N` / `*,<NON_REF>` there, its AD and PL remapped
  into that reduced allele space, and its INFO combine fields dropped.
- The merge.  REF is the longest REF of the records that start at the
  position (`N` if none does); each other REF's ALT alleles are
  extended by the missing suffix; ALT alleles are deduplicated in file
  order with `<NON_REF>` last; AD (one per allele) and PL (one per
  genotype, in VCF order, at the call's ploidy) are remapped through
  each file's allele map, absent alleles taking the call's
  `<NON_REF>` value.
- The import.  INFO fields that are summed (RAW_MQ, DP) are divided
  among the samples of their file as GenomicsDB's import divides them:
  an int v as v // n, plus one for the first v % n samples; a float32
  as v / n in float32.
- The record.  END on records longer than one position; the INFO
  median / sum of the calls' first values; `DP=` the sum over calls of
  INFO DP, else MIN_DP, else FORMAT DP, on records that are not
  reference blocks alone; FORMAT GT (alleles written `.`), AD, GQ,
  MIN_DP, PL and DP last, each where some call has a value.

`precision="low"` computes the same records with the float fields in
bfloat16 and the DP sum in int16: the control that the comparison has
to fail.

Every sample's output cell is a function of its input cell's text, its
file's allele maps and the record's FORMAT keys, so cells are rendered
once per distinct (text, maps, keys) and looked up after that.
"""

from __future__ import annotations

import bisect
import json
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

MISSING = -(2 ** 31)
NON_REF = "<NON_REF>"
MEDIAN_FIELDS = ("BaseQRankSum", "MQ0")
FLOAT_FIELDS = ("BaseQRankSum", "RAW_MQ")
INFO_ORDER = ("BaseQRankSum", "MQ0", "RAW_MQ")      # the vid's order
FORMAT_ORDER = ("AD", "GQ", "MIN_DP", "PL")         # after GT, before DP


def _symbolic(allele: str) -> bool:
    return (allele == "*" or (allele[:1] == "<" and allele[-1:] == ">")
            or "[" in allele or "]" in allele)


def _is_deletion(ref: str, alt: str) -> bool:
    return len(ref) > 1 and (alt == "*" or (not _symbolic(alt)
                                            and len(alt) < len(ref)))


def genotypes(n_alleles: int, ploidy: int) -> List[Tuple[int, ...]]:
    """Every genotype of `ploidy` over `n_alleles`, ascending allele
    tuples in VCF order (the highest allele varies slowest)."""
    if ploidy == 1:
        return [(a,) for a in range(n_alleles)]
    out = []
    for top in range(n_alleles):
        out.extend(g + (top,) for g in genotypes(top + 1, ploidy - 1))
    return out


def genotype_index(alleles: Sequence[int]) -> int:
    """Position of a genotype (any allele order) in VCF order:
    sum over the sorted alleles a_k (k from 0) of C(a_k + k, k + 1)."""
    return sum(math.comb(a + k, k + 1)
               for k, a in enumerate(sorted(alleles)))


def format_float(x) -> str:
    """htslib's rendering of a float32 VCF value: six significant
    digits in fixed point, trailing zeros cut to one decimal; %g outside
    [1e-4, 999999]."""
    d = float(np.float32(x))
    if d == 0:
        return "-0" if math.copysign(1.0, d) < 0 else "0"
    sign, d = ("-", -d) if d < 0 else ("", d)
    if d < 1e-4 or d > 999999:
        return sign + "%g" % d
    decimals = max(6 - (math.floor(math.log10(d)) + 1), 0)
    s = "%.*f" % (decimals, d)
    if "." in s:
        s = s.rstrip("0")
        if s.endswith("."):
            s += "0"
    else:
        s += ".0"
    return sign + s


def _bf16(x) -> np.float32:
    """float32 rounded to bfloat16 (nearest, ties to even)."""
    b = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return np.asarray(b.astype(np.uint32)).view(np.float32)[()]


def float_bits(x) -> str:
    """A float32 value as its bits (8 hex digits): the form in which a
    lookup's BCF2 answer, which carries float32 words, is compared."""
    return "%08x" % int(np.float32(x).view(np.uint32))


class GvcfFile:
    """One multi-sample gVCF: its records' site columns, and each
    record's sample columns split on first use."""

    def __init__(self, path: str, contig_offsets: Dict[str, int]):
        self.samples: List[str] = []
        lines = []
        with open(path) as f:
            for line in f:
                if line.startswith("##"):
                    continue
                if line.startswith("#"):
                    self.samples = line.rstrip("\n").split("\t")[9:]
                    continue
                lines.append(line.rstrip("\n"))
        n = len(lines)
        self.col = np.empty(n, np.int64)
        self.end = np.empty(n, np.int64)
        self.ref: List[str] = []
        self.alts: List[List[str]] = []
        self.info: List[Dict[str, str]] = []
        self.fmt: List[Tuple[str, ...]] = []
        self._rest: List[str] = []
        for i, line in enumerate(lines):
            (chrom, pos, _id, ref, alt, _q, _f, info, fmt,
             rest) = line.split("\t", 9)
            kv = dict(t.split("=", 1) for t in info.split(";") if "=" in t)
            col = contig_offsets[chrom] + int(pos) - 1
            self.col[i] = col
            self.end[i] = (contig_offsets[chrom] + int(kv["END"]) - 1
                           if "END" in kv else col + len(ref) - 1)
            self.ref.append(ref)
            self.alts.append(alt.split(","))
            self.info.append(kv)
            self.fmt.append(tuple(fmt.split(":")))
            self._rest.append(rest)
        if np.any(self.col[1:] <= self.end[:-1]):
            raise ValueError(f"{path}: overlapping records")
        self._cells: Dict[int, List[str]] = {}

    def record_at(self, col: int) -> int:
        i = int(np.searchsorted(self.col, col, side="right")) - 1
        return i if i >= 0 and self.end[i] >= col else -1

    def cells(self, r: int) -> List[str]:
        got = self._cells.get(r)
        if got is None:
            got = self._cells[r] = self._rest[r].split("\t")
        return got


def _parse_cell(fmt: Tuple[str, ...], text: str):
    """(ploidy, {FORMAT key: tuple of ints (MISSING for '.') or None
    where the whole value is missing})."""
    parts = text.split(":")
    ploidy, vals = 0, {}
    for k, name in enumerate(fmt):
        t = parts[k] if k < len(parts) else "."
        if name == "GT":
            ploidy = len(t.replace("|", "/").split("/"))
            continue
        v = tuple(MISSING if x == "." else int(x) for x in t.split(","))
        vals[name] = None if all(x == MISSING for x in v) else v
    return ploidy, vals


class _Remap:
    """One file's allele map into a record's merged alleles: for AD the
    input allele of each merged allele, for PL (per ploidy) the input
    genotype of each merged genotype; -1 where the value is missing."""

    def __init__(self, lut: Sequence[int], n_merged: int, has_nr: bool):
        inv = [-1] * n_merged
        for i, m in enumerate(lut):
            if 0 <= m < n_merged:
                inv[m] = i
        nr = inv[n_merged - 1] if has_nr else -1
        self.src = [i if i >= 0 else nr for i in inv]
        self.n_merged = n_merged
        self._pl: Dict[int, List[int]] = {}
        self.key = (tuple(lut), n_merged, has_nr)

    def pl_index(self, ploidy: int) -> List[int]:
        got = self._pl.get(ploidy)
        if got is None:
            got = []
            for gt in genotypes(self.n_merged, ploidy):
                al = [self.src[a] for a in gt]
                got.append(-1 if min(al) < 0 else genotype_index(al))
            self._pl[ploidy] = got
        return got

    def apply(self, ploidy: int, vals: Dict) -> Dict:
        out = dict(vals)
        for name, idx in (("AD", self.src), ("PL", None)):
            v = vals.get(name)
            if v is None:
                continue
            if idx is None:
                idx = self.pl_index(ploidy)
            out[name] = tuple(v[i] if 0 <= i < len(v) else MISSING
                              for i in idx)
        return out


class Cohort:
    """The gVCF files of one cohort, in the callset order (files in row
    order, as the generator and the import lay them out)."""

    def __init__(self, vcf_paths: Sequence[str], vid_path: str):
        with open(vid_path) as f:
            vid = json.load(f)
        offsets = {c: int(v["tiledb_column_offset"])
                   for c, v in vid["contigs"].items()}
        self._contig_at = sorted((o, c) for c, o in offsets.items())
        self.files = [GvcfFile(p, offsets) for p in vcf_paths]
        self.n_samples = sum(len(f.samples) for f in self.files)
        self._parsed: Dict[Tuple, Tuple] = {}
        self._records: Dict[Tuple, Tuple] = {}
        self._rendered: Dict[Tuple, Dict[str, str]] = {}
        self._blocks: Dict[Tuple, str] = {}

    def contig_pos(self, col: int) -> Tuple[str, int]:
        i = bisect.bisect_right([o for o, _ in self._contig_at], col) - 1
        off, name = self._contig_at[i]
        return name, col - off + 1

    def sweep(self, lo: int, hi: int) -> List[Tuple[int, int, Tuple]]:
        """The output records of the query interval [lo, hi] (columns,
        inclusive): (start, end, live record index per file or -1)."""
        n = len(self.files)
        live = [-1] * n
        end = [0] * n
        dele = [False] * n
        out = []
        cur = -1

        def push(g, r):
            f = self.files[g]
            live[g], end[g] = r, int(f.end[r])
            dele[g] = any(_is_deletion(f.ref[r], a) for a in f.alts[r])

        def ranges(next_start, last):
            nonlocal cur
            while True:
                ends = [end[g] for g in range(n) if live[g] >= 0]
                if not ends or not (cur < next_start or last):
                    return
                top = min(ends)
                stop = top if (last or top < next_start - 1) \
                    else next_start - 1
                if any(dele[g] for g in range(n) if live[g] >= 0):
                    stop = cur
                out.append((cur, stop, tuple(live)))
                for g in range(n):
                    if live[g] >= 0 and end[g] == stop:
                        live[g] = -1
                cur = stop + 1

        for g, f in enumerate(self.files):
            r = f.record_at(lo)
            if r >= 0:
                push(g, r)
        if any(r >= 0 for r in live):
            cur = lo
        events = []
        for g, f in enumerate(self.files):
            a = int(np.searchsorted(f.col, lo + 1))
            b = int(np.searchsorted(f.col, hi, side="right"))
            events.extend((int(f.col[r]), g, r) for r in range(a, b))
        events.sort()
        for col, g, r in events:
            if cur < 0:
                cur = col
            if col != cur:
                ranges(col, False)
                cur = col
            push(g, r)
        ranges(hi + 1, False)
        return out

    # ---------------- one output record ----------------

    def _parse(self, fmt, text):
        key = (fmt, text)
        got = self._parsed.get(key)
        if got is None:
            got = self._parsed[key] = _parse_cell(fmt, text)
        return got

    def _record(self, g: int, r: int):
        """(FORMAT keys present in some call, sum over the calls of
        MIN_DP, else FORMAT DP) of record r of file g."""
        key = (g, r)
        got = self._records.get(key)
        if got is None:
            f = self.files[g]
            fmt, have, dp = f.fmt[r], set(), 0
            for t in f.cells(r):
                vals = self._parse(fmt, t)[1]
                have.update(k for k, v in vals.items() if v is not None)
                d = vals.get("MIN_DP") or vals.get("DP")
                if d is not None:
                    dp += d[0]
            got = self._records[key] = (have, dp)
        return got

    def _block(self, g: int, r: int, remaps, out_fmt) -> str:
        """The tab-joined sample columns of file g's calls (record r)."""
        rkey = tuple(m.key for m in remaps)
        key = (g, r, rkey, out_fmt)
        got = self._blocks.get(key)
        if got is not None:
            return got
        f = self.files[g]
        fmt = f.fmt[r]
        cells = self._rendered.setdefault((fmt, rkey, out_fmt), {})
        out = []
        for text in f.cells(r):
            c = cells.get(text)
            if c is None:
                ploidy, vals = self._parse(fmt, text)
                for m in remaps:
                    vals = m.apply(ploidy, vals)
                parts = ["/".join("." * ploidy)]
                for name in out_fmt[1:]:
                    v = vals.get(name)
                    parts.append("." if v is None else ",".join(
                        "." if x == MISSING else str(x) for x in v))
                c = cells[text] = ":".join(parts)
            out.append(c)
        got = self._blocks[key] = "\t".join(out)
        return got

    def render(self, start: int, end: int, recs: Sequence[int],
               precision: str = "exact", floats=format_float) -> str:
        """The text of the output record [start, end] over the live
        records `recs` (one per file, -1 for none); `floats` renders a
        float32 field (htslib's text, or `float_bits`)."""
        low = precision == "low"
        calls = []
        for g, r in enumerate(recs):
            if r < 0:
                continue
            f = self.files[g]
            ref, alts = f.ref[r], f.alts[r]
            info = {k: f.info[r].get(k) for k in ("DP",) + INFO_ORDER}
            remaps = []
            if f.col[r] < start and any(_is_deletion(ref, a) for a in alts):
                dels = [i + 1 for i, a in enumerate(alts)
                        if _is_deletion(ref, a)]
                if len(dels) != 1:
                    raise NotImplementedError(
                        "a deletion record with more than one deletion "
                        "allele (the PL decides per call)")
                has_nr = NON_REF in alts
                lut = [0] + [1 if i + 1 == dels[0] else
                             (2 if a == NON_REF else -1)
                             for i, a in enumerate(alts)]
                alts = ["*", NON_REF] if has_nr else ["*"]
                ref = "N"
                remaps.append(_Remap(lut, len(alts) + 1, has_nr))
                for k in INFO_ORDER:
                    info[k] = None
            calls.append([g, r, ref, alts, info, remaps, f.col[r] >= start])
        merged_ref = "N"
        for _, _, ref, _, _, _, starts_here in calls:
            if not starts_here:
                continue
            if len(ref) > len(merged_ref):
                merged_ref = ref if merged_ref == "N" \
                    else merged_ref + ref[len(merged_ref):]
            elif merged_ref == "N" and ref != "N":
                merged_ref = ref
        merged: List[str] = []
        luts = []
        has_nr = False
        for _, _, ref, alts, *_ in calls:
            suffix = merged_ref[len(ref):] if len(ref) < len(merged_ref) \
                else ""
            lut = [0]
            for a in alts:
                if a == NON_REF:
                    lut.append(None)
                    has_nr = True
                    continue
                if suffix and not _symbolic(a):
                    a = a + suffix
                if a not in merged:
                    merged.append(a)
                lut.append(merged.index(a) + 1)
            luts.append(lut)
        if has_nr:
            merged.append(NON_REF)
        n_merged = len(merged) + 1
        ref_only = len(merged_ref) == 1 and merged == [NON_REF]
        if not ref_only:
            for call, lut in zip(calls, luts):
                call[5] = call[5] + [_Remap(
                    [n_merged - 1 if x is None else x for x in lut],
                    n_merged, has_nr)]
        chrom, pos = self.contig_pos(start)
        info_txt = []
        if end > start:
            info_txt.append(f"END={self.contig_pos(end)[1]}")
        for k in INFO_ORDER:
            xs, ns = [], []
            for g, r, _, _, info, _, _ in calls:
                v = info[k]
                if v is None or v == ".":
                    continue
                n = len(self.files[g].samples)
                x = np.float32(v) if k in FLOAT_FIELDS else int(v)
                if low and k in FLOAT_FIELDS:
                    x = _bf16(x)
                if k not in MEDIAN_FIELDS:           # divided at import
                    x = _bf16(x / np.float32(n)) if low \
                        else np.float32(x / np.float32(n))
                xs.append(x)
                ns.append(n)
            if not xs:
                continue
            if k in MEDIAN_FIELDS:
                order = sorted(range(len(xs)), key=lambda i: float(xs[i]))
                rank = sum(ns) // 2
                for i in order:
                    if rank < ns[i]:
                        res = xs[i]
                        break
                    rank -= ns[i]
            elif low:
                res = None
                for x, n in zip(xs, ns):
                    for _ in range(n):
                        res = x if res is None else _bf16(res + x)
            else:
                vals = np.repeat(np.asarray(xs, np.float32), ns)
                res = np.add.accumulate(vals, dtype=np.float32)[-1]
            info_txt.append(f"{k}=" + (floats(res) if k in FLOAT_FIELDS
                                       else str(int(res))))
        # FORMAT keys: GT, then each field some call has, DP last
        have = set()
        dp_sum = 0
        for g, r, _, _, info, _, _ in calls:
            have_r, dp_r = self._record(g, r)
            have |= have_r
            dp_info = info["DP"]
            # the import's parts of INFO DP sum to it
            dp_sum += int(dp_info) if dp_info not in (None, ".") else dp_r
        if low:
            dp_sum = int(np.int64(dp_sum).astype(np.int16))
        out_fmt = ("GT",) + tuple(k for k in FORMAT_ORDER if k in have) \
            + (("DP",) if "DP" in have else ())
        cols = []
        by_file = {c[0]: c for c in calls}
        for g, f in enumerate(self.files):
            c = by_file.get(g)
            if c is None:
                cols.append("\t".join(
                    [":".join("." * len(out_fmt))] * len(f.samples)))
            else:
                cols.append(self._block(g, c[1], c[5], out_fmt))
        if dp_sum > 0 and not ref_only:
            info_txt.append(f"DP={dp_sum}")
        alt_txt = ",".join(merged) if merged else "."
        return "\t".join([chrom, str(pos), ".", merged_ref, alt_txt, ".",
                          ".", ";".join(info_txt) if info_txt else ".",
                          ":".join(out_fmt)] + cols)


def reference_lines(cohort: Cohort, lo: int, hi: int,
                    precision: str = "exact",
                    floats=format_float) -> List[str]:
    """Every output record of the query interval [lo, hi]."""
    return [cohort.render(s, e, recs, precision, floats)
            for s, e, recs in cohort.sweep(lo, hi)]
