"""The benchmark's cohort generator: a frozen copy of
`genomicsdb_tpu_torch.testing.write_cohort` (numpy only).

The benchmark makes its data from `--seed` with this copy, so that a
change to the program's own test generator never changes what the cells
measure; `tests/test_gdb_bench_generator.py` pins the bytes it writes.

`write_cohort(out_dir, n_samples, n_records, seed)` writes a cohort of
`n_samples` samples split over a few multi-sample gVCF files ("groups";
samples of one group share its record layout, as in a joint-called
batch), and the vid, callset-mapping, loader and query JSON that import
it with `vcf2gdb` and query it with `gdb_query`.

The drawn genome is written beside the cohort as a FASTA (contig `1`).

Each group's records tile the same region: reference blocks (`END=`) of
group-specific lengths around variant sites drawn from one shared pool,
so groups that carry the same site with different ALT alleles merge
into multi-allelic records.  Sites are bi-allelic SNVs, tri-allelic
SNVs and multi-base deletions (spanning-deletion records in the
combine).  Variant records carry INFO BaseQRankSum (float median), MQ0
(int median), RAW_MQ (ordered float sum) and DP.

Keyword-only options of `write_cohort` add the data of cohorts beyond
diploid bi-allelic calls (haploid stretches, triploid samples, phased
calls, hotspots past 16 merged alleles, PL past int16, one polyploid
ploidy throughout).
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import List

import numpy as np

BASES = np.array(list("ACGT"))
_HEADER = [
    "##fileformat=VCFv4.1",
    '##ALT=<ID=NON_REF,Description="Represents any possible alternative '
    'allele at this location">',
    '##FILTER=<ID=PASS,Description="All filters passed">',
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
    '##FORMAT=<ID=AD,Number=.,Type=Integer,Description="Allelic depths">',
    '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth">',
    '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">',
    '##FORMAT=<ID=MIN_DP,Number=1,Type=Integer,Description="Min depth">',
    '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Likelihoods">',
    '##INFO=<ID=END,Number=1,Type=Integer,Description="Block end">',
    '##INFO=<ID=DP,Number=1,Type=Integer,Description="Depth">',
    '##INFO=<ID=BaseQRankSum,Number=1,Type=Float,Description="BQ rank">',
    '##INFO=<ID=MQ0,Number=1,Type=Integer,Description="MAPQ0 reads">',
    '##INFO=<ID=RAW_MQ,Number=1,Type=Float,Description="Raw MQ">',
    "##contig=<ID=1,length=249250621>",
]
_VID = {
    "fields": {
        "PASS": {"vcf_field_class": ["FILTER"], "type": "int"},
        "GT": {"vcf_field_class": ["FORMAT"], "type": "int",
               "length": "P"},
        "AD": {"vcf_field_class": ["FORMAT"], "type": "int",
               "length": "R"},
        "DP": {"vcf_field_class": ["FORMAT", "INFO"], "type": "int"},
        "GQ": {"vcf_field_class": ["FORMAT"], "type": "int"},
        "MIN_DP": {"vcf_field_class": ["FORMAT"], "type": "int"},
        "PL": {"vcf_field_class": ["FORMAT"], "type": "int",
               "length": "G"},
        "END": {"vcf_field_class": ["INFO"], "type": "int"},
        "BaseQRankSum": {"vcf_field_class": ["INFO"], "type": "float"},
        "MQ0": {"vcf_field_class": ["INFO"], "type": "int"},
        "RAW_MQ": {"vcf_field_class": ["INFO"], "type": "float"},
    },
    "contigs": {"1": {"length": 249250621, "tiledb_column_offset": 0}},
}


@dataclass
class Cohort:
    """Paths of a written cohort.  `region` is the last column any
    record covers (0-based, inclusive); `head_interval` the column range
    that holds the first ~300 record starts of the combined cohort
    (queried by `query_head`); `fasta` the cohort's reference genome."""
    dir: str
    vcfs: List[str]
    vid: str
    callsets: str
    loader: str
    query: str
    query_head: str
    workspace: str
    array: str
    n_samples: int
    region: int
    head_interval: tuple
    fasta: str


def _cell_pool(rng, n: int, n_alleles: int, ref_block: bool,
               ploidy: int = 2) -> np.ndarray:
    """n distinct sample-column strings for records of `n_alleles`
    alleles (NON_REF included) at `ploidy`: GT:AD:DP:GQ:MIN_DP:PL, PL
    with C(n_alleles + ploidy - 1, ploidy) values."""
    g = math.comb(n_alleles + ploidy - 1, ploidy)
    dp = rng.integers(1, 99, n)
    gq = rng.integers(0, 99, n)
    pl = rng.integers(0, 999, (n, g))
    cells = []
    for i in range(n):
        if ref_block:
            pl_i = [0] + pl[i, 1:].tolist()
            cells.append(f"{'/'.join('0' * ploidy)}:.:{dp[i]}:{gq[i]}:"
                         f"{max(dp[i] - 3, 0)}:" + ",".join(map(str, pl_i)))
            continue
        if ploidy == 2:
            a1 = int(rng.integers(0, n_alleles - 1))
            a2 = int(rng.integers(a1, n_alleles - 1))
            alleles = (a1, a2)
        else:
            alleles = sorted(rng.integers(0, n_alleles - 1, ploidy).tolist())
        ad = rng.integers(0, 60, n_alleles).tolist()
        ad[-1] = 0
        cells.append(f"{'/'.join(map(str, alleles))}:"
                     f"{','.join(map(str, ad))}:{dp[i]}:"
                     f"{gq[i]}:.:{','.join(map(str, pl[i]))}")
    return np.array(cells, dtype=object)


def _phase_pool(rng, pool: np.ndarray, share: float) -> np.ndarray:
    """A copy of a diploid variant pool with a share of its calls
    written phased (`a1|a2`)."""
    pool = pool.copy()
    for i in np.nonzero(rng.random(len(pool)) < share)[0]:
        pool[i] = pool[i].replace("/", "|", 1)
    return pool


def _high_pl_pool(rng, pool: np.ndarray, share: float) -> np.ndarray:
    """A copy of a variant pool with a share of its calls given PL
    values in 32,768-60,000 (past the int16 range)."""
    pool = pool.copy()
    for i in np.nonzero(rng.random(len(pool)) < share)[0]:
        head, pl = pool[i].rsplit(":", 1)
        n = pl.count(",") + 1
        pool[i] = head + ":" + ",".join(
            map(str, rng.integers(32768, 60001, n)))
    return pool


_FORMAT = "GT:AD:DP:GQ:MIN_DP:PL"


def _ref_prefix(genome: str, pos: int, end: int) -> str:
    return (f"1\t{pos}\t.\t{genome[pos - 1]}\t<NON_REF>\t.\t.\t"
            f"END={end}\t{_FORMAT}\t")


def _group_lines(rng, genome: str, sites, group_samples: int,
                 n_records: int, pools) -> tuple:
    """Records of one group: variant sites (a random half of the shared
    pool) with reference blocks tiling the gaps.  Each record is
    [pos, end (reference blocks; None for variants), pool key, line
    prefix up to the sample columns, the samples' pool picks]; returns
    (records, last covered position)."""
    recs = []
    pos = 1                                  # 1-based, next uncovered
    keep = rng.random(len(sites)) < 0.5
    for site, kind in sites[keep]:
        if len(recs) >= n_records:
            break
        # reference blocks up to the site
        while pos < site and len(recs) < n_records:
            end = min(site - 1, pos + int(rng.integers(4, 60)))
            pick = rng.integers(0, len(pools["ref"]), group_samples)
            recs.append([pos, end, "ref", _ref_prefix(genome, pos, end),
                         pick])
            pos = end + 1
        if len(recs) >= n_records:
            break
        ref = genome[site - 1]
        others = [b for b in "ACGT" if b != ref]
        if kind == 2:                        # multi-base deletion
            ref = genome[site - 1:site + 2]
            alt = f"{genome[site - 1]},<NON_REF>"
            key = 3
            span = 3
        elif kind == 1:                      # tri-allelic SNV
            a, b = rng.choice(others, 2, replace=False)
            alt = f"{a},{b},<NON_REF>"
            key = 4
            span = 1
        else:                                # bi-allelic SNV
            alt = f"{rng.choice(others)},<NON_REF>"
            key = 3
            span = 1
        info = _info(rng)
        pick = rng.integers(0, len(pools[key]), group_samples)
        recs.append([int(site), None, key,
                     f"1\t{site}\t.\t{ref}\t{alt}\t.\t.\t{info}\t"
                     f"{_FORMAT}\t", pick])
        pos = site + span
    return recs, pos - 1


def _info(rng) -> str:
    return (f"BaseQRankSum={rng.normal():.3f};"
            f"DP={int(rng.integers(10, 9999))};"
            f"MQ0={int(rng.integers(0, 9))};"
            f"RAW_MQ={rng.random() * 1e5:.2f}")


def _hotspot_sites(group_recs, lo: int, hi: int, k: int, xrng) -> list:
    """k positions in [lo, hi] (1-based) that lie inside a reference
    block past its first position in every group."""
    ok = np.ones(hi - lo + 1, dtype=bool)
    for recs in group_recs:
        cover = np.zeros_like(ok)
        for pos, end, *_ in recs:
            if end is not None and end >= lo and pos < hi:
                a, b = max(pos + 1, lo), min(end, hi)
                cover[a - lo:b - lo + 1] = True
        ok &= cover
    cand = lo + np.nonzero(ok)[0]
    return sorted(int(s) for s in
                  xrng.choice(cand, min(k, len(cand)), replace=False))


def _hotspot_alleles(n_groups: int, n_pool: int, xrng) -> list:
    """The pool insertions each group file calls at one hotspot: the
    site's set of 15-17 of them, spread so that the files together call
    all of it, topped up to 5-8 per file (with three files or more).
    The merged record then has 17-19 alleles with REF and <NON_REF>:
    past the kernel's 16, and within the 19 that the block's PL-tensor
    budget (`ops/store_block.merged_cap`) allows at 1,000 samples."""
    site = xrng.choice(n_pool, int(xrng.integers(15, 18)), replace=False)
    per = [[int(a) for a in site[g::n_groups]] for g in range(n_groups)]
    for alts in per:
        rest = [int(a) for a in site if a not in alts]
        more = max(int(xrng.integers(5, 9)) - len(alts), 0)
        alts += [rest[i] for i in xrng.choice(len(rest), more,
                                              replace=False)]
    return per


def _insert_hotspots(recs, genome: str, hot: dict, insertions,
                     group_samples: int, xrng, pools) -> list:
    """`recs` with each hotspot site cut out of the reference block that
    covers it and given its own record: `hot[site]` holds the indices of
    its alternate alleles in `insertions`, each the REF base followed by
    that insertion (cells from pool ("hot", n_alleles))."""
    out = []
    todo = sorted(hot)
    for rec in recs:
        pos, end = rec[0], rec[1]
        inside = [s for s in todo if end is not None and pos < s <= end]
        if not inside:
            out.append(rec)
            continue
        for s in inside:
            if pos <= s - 1:
                out.append([pos, s - 1, "ref",
                            _ref_prefix(genome, pos, s - 1), rec[4]])
            ref = genome[s - 1]
            alts = [ref + insertions[i] for i in hot[s]]
            key = ("hot", len(alts) + 2)
            pick = xrng.integers(0, len(pools[key]), group_samples)
            out.append([s, None, key,
                        f"1\t{s}\t.\t{ref}\t{','.join(alts)},<NON_REF>"
                        f"\t.\t.\t{_info(xrng)}\t{_FORMAT}\t", pick])
            pos = s + 1
        if pos <= end:
            out.append([pos, end, "ref", _ref_prefix(genome, pos, end),
                        rec[4]])
        todo = [s for s in todo if s not in inside]
    return out


def write_cohort(out_dir: str, n_samples: int, n_records: int,
                 seed: int = 0, n_groups: int = 0,
                 deletions: bool = True, *,
                 haploid_stretch: bool = False, triploid_every: int = 0,
                 phased_share: float = 0.0, hotspots: int = 0,
                 high_pl: float = 0.0, ploidy: int = 2) -> Cohort:
    """Write the cohort and its JSON configuration under `out_dir`.
    `n_records` is the record count of each group's file; `n_groups`
    (default: about one group per 125 samples, at least 2) sets how
    many files the samples are spread over; `deletions=False` turns the
    deletion sites into bi-allelic SNVs (a cohort without spanning
    deletions).

    The keyword-only options write the data of cohorts beyond diploid
    bi-allelic calls (with all of them at their defaults the files are
    those of a cohort without them, byte for byte); thirds are of the
    region's columns:
      haploid_stretch  in the middle third, samples of odd index write
                       haploid calls (GT `0` / `1`, PL of n_alleles
                       values; reference blocks GT `0` with 2 PL
                       values), as on chrX outside the PAR
      triploid_every   every N-th sample (S{N-1}, S{2N-1}, ...) is
                       triploid throughout: PL of C(n + 2, 3) values
      phased_share     that share of diploid variant calls is written
                       phased (`a1|a2`), and the vid stores GT's phase
                       (length "PP")
      hotspots         that many sites in the last third carry 5-8
                       alternate alleles per group file, drawn from a
                       pool of 20 distinct insertions, so that the
                       files meeting there (three or more) merge 17-19
                       alleles; every sample calls them diploid
      high_pl          that share of variant calls has PL values in
                       32,768-60,000, past the int16 range
      ploidy           every sample is of this ploidy (3-6) throughout,
                       as an autopolyploid crop's cohort is: variant
                       calls of that many alleles, reference blocks
                       `0/0/0/0` with ploidy + 1 PL values; with
                       phased_share its variant calls are phased too
                       (the first separator); not with triploid_every
    Each sample draws its cell from a pool of its own ploidy; a
    triploid sample stays triploid in the haploid stretch."""
    if ploidy != 2 and not 3 <= ploidy <= 6:
        raise ValueError(f"ploidy must be 2 (the default) or 3-6, got "
                         f"{ploidy}")
    if ploidy != 2 and triploid_every:
        raise ValueError("triploid_every needs the default ploidy 2")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    if not n_groups:
        n_groups = max(2, -(-n_samples // 125))
    n_groups = min(n_groups, n_samples)
    # one variant site per ~8 records; gaps filled by reference blocks
    n_sites = 2 * max(n_records // 8, 4)
    gaps = rng.integers(8, 400, n_sites)
    site_pos = 1 + np.cumsum(gaps)
    kinds = rng.choice(3, n_sites, p=[0.6, 0.2, 0.2])
    if not deletions:
        kinds[kinds == 2] = 0
    sites = np.stack([site_pos, kinds], axis=1)
    genome = "".join(BASES[rng.integers(0, 4, int(site_pos[-1]) + 8)])
    pools = {"ref": _cell_pool(rng, 512, 2, True),
             3: _cell_pool(rng, 2048, 3, False),
             4: _cell_pool(rng, 2048, 4, False)}
    bounds = [int(x) for x in np.linspace(0, n_samples, n_groups + 1)]
    group_recs, region = [], 0
    for g in range(n_groups):
        recs, last = _group_lines(rng, genome, sites,
                                  bounds[g + 1] - bounds[g], n_records,
                                  pools)
        group_recs.append(recs)
        region = max(region, int(last) - 1)
    # the options' draws come from a generator of their own, so the
    # default cohort's draws stay as they were
    xrng = np.random.default_rng([seed, 1])
    sample_ploidy = np.full(n_samples, ploidy)
    if triploid_every:
        sample_ploidy[triploid_every - 1::triploid_every] = 3
    haploid = np.zeros(n_samples, dtype=bool)
    if haploid_stretch:
        haploid[1::2] = sample_ploidy[1::2] == 2
    variant_keys = [3, 4]
    extra = [1] * haploid_stretch + [3] * bool(triploid_every)
    for p in extra + [ploidy] * (ploidy != 2):
        pools["ref", p] = _cell_pool(xrng, 512, 2, True, p)
        for key in (3, 4):
            pools[key, p] = _cell_pool(xrng, 512, key, False, p)
            variant_keys.append((key, p))
    if hotspots:
        insertions = sorted({"".join(BASES[xrng.integers(
            0, 4, int(xrng.integers(1, 7)))]) for _ in range(64)})[:20]
        lo = 2 * region // 3 + 1
        hot = {s: _hotspot_alleles(n_groups, len(insertions), xrng)
               for s in _hotspot_sites(group_recs, lo, region + 1,
                                       hotspots, xrng)}
        for n in sorted({len(a) + 2 for per in hot.values() for a in per}):
            pools["hot", n] = _cell_pool(xrng, 256, n, False)
            variant_keys.append(("hot", n))
        group_recs = [_insert_hotspots(
            recs, genome, {s: per[g] for s, per in hot.items()},
            insertions, bounds[g + 1] - bounds[g], xrng, pools)
            for g, recs in enumerate(group_recs)]
    if phased_share:            # the variant pools of the base ploidy
        for k in variant_keys:
            if k in (3, 4) or k[0] == "hot" or k[1] == ploidy != 2:
                pools[k] = _phase_pool(xrng, pools[k], phased_share)
    if high_pl:
        for k in variant_keys:
            pools[k] = _high_pl_pool(xrng, pools[k], high_pl)
    stretch = (region // 3, 2 * region // 3)     # 0-based columns
    vcfs, callsets = [], {}
    starts = set()
    for g, recs in enumerate(group_recs):
        names = [f"S{i}" for i in range(bounds[g], bounds[g + 1])]
        p_all = sample_ploidy[bounds[g]:bounds[g + 1]]
        p_mid = np.where(haploid[bounds[g]:bounds[g + 1]], 1, p_all)
        lines = []
        for pos, _, key, prefix, pick in recs:
            cells = pools[key][pick]
            if not (isinstance(key, tuple) and key[0] == "hot"):
                p_rec = (p_mid if stretch[0] <= pos - 1 < stretch[1]
                         else p_all)
                for j in np.nonzero(p_rec != 2)[0]:
                    other = pools[key, int(p_rec[j])]
                    cells[j] = other[pick[j] % len(other)]
            lines.append(prefix + "\t".join(cells))
        starts.update(int(rec[0]) for rec in recs)
        path = os.path.join(out_dir, f"group{g}.g.vcf")
        with open(path, "w") as f:
            f.write("\n".join(_HEADER) + "\n")
            f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                    + "\t".join(names) + "\n")
            f.write("\n".join(lines) + "\n")
        vcfs.append(path)
        for j, nm in enumerate(names):
            callsets[nm] = {"row_idx": bounds[g] + j, "idx_in_file": j,
                            "filename": path}
    starts = sorted(starts)
    head_hi = starts[min(300, len(starts)) - 1] - 1
    vid_path = os.path.join(out_dir, "vid.json")
    cs_path = os.path.join(out_dir, "callsets.json")
    ws_path = os.path.join(out_dir, "ws")
    array = "cohort"
    vid = _VID
    if phased_share:
        vid = json.loads(json.dumps(_VID))
        vid["fields"]["GT"]["length"] = "PP"
    with open(vid_path, "w") as f:
        json.dump(vid, f)
    with open(cs_path, "w") as f:
        json.dump({"callsets": callsets}, f)
    fasta = os.path.join(out_dir, "ref.fa")
    with open(fasta, "w") as f:
        f.write(">1\n")
        f.writelines(genome[i:i + 60] + "\n"
                     for i in range(0, len(genome), 60))
    loader = os.path.join(out_dir, "loader.json")
    with open(loader, "w") as f:
        json.dump({"column_partitions": [{"begin": 0, "workspace": ws_path,
                                          "array_name": array}],
                   "callset_mapping_file": cs_path,
                   "vid_mapping_file": vid_path,
                   "treat_deletions_as_intervals": True}, f)

    def query_json(name, lo, hi):
        path = os.path.join(out_dir, name)
        with open(path, "w") as f:
            json.dump({"workspace": ws_path, "array_name": array,
                       "query_column_ranges": [
                           {"range_list": [{"low": lo, "high": hi}]}],
                       "vid_mapping_file": vid_path,
                       "callset_mapping_file": cs_path,
                       "attributes": []}, f)
        return path

    return Cohort(dir=out_dir, vcfs=vcfs, vid=vid_path, callsets=cs_path,
                  loader=loader, query=query_json("query.json", 0, region),
                  query_head=query_json("query_head.json", 0, head_hi),
                  workspace=ws_path, array=array, n_samples=n_samples,
                  region=region, head_interval=(0, head_hi), fasta=fasta)
