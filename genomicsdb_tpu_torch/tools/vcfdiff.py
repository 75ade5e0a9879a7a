"""Semantic VCF comparator (tools/src/vcfdiff.cc equivalent).

Order/encoding-insensitive comparison of a test VCF against a gold VCF:
sample/contig/field identity by NAME (not column order), allele-order
remapping of R/A/G-length fields via per-record allele LUTs, float
comparison with tolerance, missing-value-aware.

Usage: python -m genomicsdb_tpu_torch.tools.vcfdiff <gold.vcf> <test.vcf>
Exit 0 if semantically equal; diagnostics on stderr otherwise.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

from ..vcf.reader import VCFFile

FLOAT_TOL = 1e-3


def _num(x: str):
    try:
        return int(x)
    except ValueError:
        try:
            return float(x)
        except ValueError:
            return x


def _values_equal(a, b) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        try:
            return abs(float(a) - float(b)) <= FLOAT_TOL * max(
                1.0, abs(float(a)))
        except (TypeError, ValueError):
            return False
    return a == b


def _split_vals(raw: Optional[str]) -> List:
    if raw is None:
        return [True]  # flag
    return [_num(t) for t in raw.split(",")]


def _genotype_index(alleles: List[int]) -> int:
    from ..ops.merge import genotype_index
    return genotype_index(alleles)


class RecordDiff:
    def __init__(self, gold, test, sample_map: Dict[str, int],
                 gold_samples: List[str], test_samples: List[str]):
        self.gold = gold
        self.test = test
        self.gold_samples = gold_samples
        self.test_samples = test_samples
        self.errors: List[str] = []
        # allele LUT: gold allele idx -> test allele idx
        g_alleles = [gold.ref] + gold.alts
        t_alleles = [test.ref] + test.alts
        self.lut: Dict[int, int] = {}
        for i, a in enumerate(g_alleles):
            if a in t_alleles:
                self.lut[i] = t_alleles.index(a)
        self.n_gold = len(g_alleles)
        self.n_test = len(t_alleles)

    def _remap_length(self, number: str, vals: List, ploidy: int) -> List:
        """Reorder gold-side R/A/G values into test allele order."""
        if number == "R" and len(vals) == self.n_gold:
            out = ["."] * self.n_test
            for gi, ti in self.lut.items():
                out[ti] = vals[gi]
            return out
        if number == "A" and len(vals) == self.n_gold - 1:
            out = ["."] * (self.n_test - 1)
            for gi, ti in self.lut.items():
                if gi >= 1 and ti >= 1:
                    out[ti - 1] = vals[gi - 1]
            return out
        if number == "G":
            from ..ops.merge import genotype_combinations
            combos_t = genotype_combinations(self.n_test, ploidy)
            out = ["."] * len(combos_t)
            inv = {v: k for k, v in self.lut.items()}
            for ti, combo in enumerate(combos_t):
                try:
                    gcombo = [inv[a] for a in combo]
                except KeyError:
                    continue
                gi = _genotype_index(gcombo)
                if gi < len(vals):
                    out[ti] = vals[gi]
            return out
        return vals

    def compare(self, header_numbers: Dict[str, str]):
        g, t = self.gold, self.test
        if (g.chrom, g.pos, g.ref) != (t.chrom, t.pos, t.ref):
            self.errors.append(
                f"position/REF mismatch: {g.chrom}:{g.pos}:{g.ref} vs "
                f"{t.chrom}:{t.pos}:{t.ref}")
            return
        if set(g.alts) != set(t.alts):
            self.errors.append(
                f"{g.chrom}:{g.pos} ALT set mismatch: {g.alts} vs {t.alts}")
        if not _values_equal(g.qual if g.qual is not None else ".",
                             t.qual if t.qual is not None else "."):
            self.errors.append(f"{g.chrom}:{g.pos} QUAL {g.qual}!={t.qual}")
        if set(g.filters) != set(t.filters):
            self.errors.append(
                f"{g.chrom}:{g.pos} FILTER {g.filters}!={t.filters}")
        # INFO by key
        for k, v in g.info.items():
            tv = t.info.get(k, "__absent__")
            if tv == "__absent__":
                self.errors.append(f"{g.chrom}:{g.pos} INFO {k} missing")
                continue
            if v == tv:
                continue
            gl = self._remap_length(header_numbers.get(k, "1"),
                                    _split_vals(v), 2)
            tl = _split_vals(tv)
            if len(gl) != len(tl) or not all(
                    _values_equal(a, b) for a, b in zip(gl, tl)
                    if a != "." and b != "."):
                self.errors.append(
                    f"{g.chrom}:{g.pos} INFO {k}: {v} != {tv}")
        # per-sample FORMAT by name
        for sname in self.gold_samples:
            if sname not in self.test_samples:
                self.errors.append(f"sample {sname} missing in test")
                continue
            gi = self.gold_samples.index(sname)
            ti = self.test_samples.index(sname)
            gvals = dict(zip(g.fmt, g.sample_values[gi]))
            tvals = dict(zip(t.fmt, t.sample_values[ti]))
            gt_g = gvals.get("GT")
            gt_t = tvals.get("GT")
            ploidy = 2
            if gt_g is not None:
                galleles = self._gt_alleles(gt_g)
                ploidy = max(1, len(galleles))
                talleles = self._gt_alleles(gt_t) if gt_t else []
                mapped = sorted(self.lut.get(a, -9) if a >= 0 else a
                                for a in galleles)
                if sorted(talleles) != mapped and not (
                        all(a < 0 for a in galleles)
                        and all(a < 0 for a in talleles)):
                    self.errors.append(
                        f"{g.chrom}:{g.pos} {sname} GT {gt_g}!={gt_t}")
            for k, v in gvals.items():
                if k == "GT":
                    continue
                tv = tvals.get(k)
                if tv is None:
                    if v != ".":
                        self.errors.append(
                            f"{g.chrom}:{g.pos} {sname} {k} missing")
                    continue
                if v == tv:
                    continue
                gl = self._remap_length(header_numbers.get(k, "1"),
                                        _split_vals(v), ploidy)
                tl = _split_vals(tv)
                ok = len(gl) == len(tl) and all(
                    _values_equal(a, b) for a, b in zip(gl, tl)
                    if a != "." and b != ".")
                if not ok:
                    self.errors.append(
                        f"{g.chrom}:{g.pos} {sname} {k}: {v} != {tv}")

    @staticmethod
    def _gt_alleles(gt: str) -> List[int]:
        out = []
        for tok in gt.replace("|", "/").split("/"):
            out.append(-1 if tok in (".", "") else int(tok))
        return out


def vcfdiff(gold_path: str, test_path: str) -> List[str]:
    gold = VCFFile(gold_path)
    test = VCFFile(test_path)
    numbers = {}
    for d in (gold.header.infos, gold.header.formats):
        for k, hf in d.items():
            numbers[k] = hf.number
    errors: List[str] = []
    grecs = {(r.chrom, r.pos): r for r in gold}
    trecs = {(r.chrom, r.pos): r for r in test}
    for key, g in grecs.items():
        t = trecs.get(key)
        if t is None:
            errors.append(f"record {key} missing in test")
            continue
        rd = RecordDiff(g, t, {}, gold.header.samples, test.header.samples)
        rd.compare(numbers)
        errors.extend(rd.errors)
    for key in trecs:
        if key not in grecs:
            errors.append(f"extra record {key} in test")
    return errors


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if argv[:1] in (["-h"], ["--help"]):
        print(__doc__)
        return 0
    if len(argv) != 2:
        sys.stderr.write("usage: vcfdiff <gold.vcf> <test.vcf>\n")
        return 2
    errors = vcfdiff(argv[0], argv[1])
    for e in errors:
        sys.stderr.write(e + "\n")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
