"""Seeded synthetic gVCF cohorts with their configuration files (numpy
only).

`write_cohort(out_dir, n_samples, n_records, seed)` writes a cohort of
`n_samples` samples split over a few multi-sample gVCF files ("groups";
samples of one group share its record layout, as in a joint-called
batch), and the vid, callset-mapping, loader and query JSON that import
it with either package's `vcf2gdb` and query it with either
package's `gdb_query`.  Modelled on
`genomicsdb_tpu.tools.scaling_bench._write_cohort`.

The drawn genome is written beside the cohort as a FASTA (contig `1`),
so reference-base lookups (the REF of a record clipped at a query
boundary) have a reference to read.

Each group's records tile the same region: reference blocks (`END=`) of
group-specific lengths around variant sites drawn from one shared pool,
so groups that carry the same site with different ALT alleles merge
into multi-allelic records.  Sites are bi-allelic SNVs, tri-allelic
SNVs and multi-base deletions (spanning-deletion records in the
combine).  Variant records carry INFO BaseQRankSum (float median), MQ0
(int median), RAW_MQ (ordered float sum) and DP.
"""

from __future__ import annotations

import json
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


def _cell_pool(rng, n: int, n_alleles: int, ref_block: bool) -> np.ndarray:
    """n distinct sample-column strings for records of `n_alleles`
    alleles (NON_REF included): GT:AD:DP:GQ:MIN_DP:PL."""
    g = n_alleles * (n_alleles + 1) // 2
    dp = rng.integers(1, 99, n)
    gq = rng.integers(0, 99, n)
    pl = rng.integers(0, 999, (n, g))
    cells = []
    for i in range(n):
        if ref_block:
            pl_i = [0] + pl[i, 1:].tolist()
            cells.append(f"0/0:.:{dp[i]}:{gq[i]}:{max(dp[i] - 3, 0)}:"
                         + ",".join(map(str, pl_i)))
            continue
        a1 = int(rng.integers(0, n_alleles - 1))
        a2 = int(rng.integers(a1, n_alleles - 1))
        ad = rng.integers(0, 60, n_alleles).tolist()
        ad[-1] = 0
        cells.append(f"{a1}/{a2}:{','.join(map(str, ad))}:{dp[i]}:"
                     f"{gq[i]}:.:{','.join(map(str, pl[i]))}")
    return np.array(cells, dtype=object)


def _group_lines(rng, genome: str, sites, group_samples: int,
                 n_records: int, pools) -> tuple:
    """Record lines of one group: variant sites (a random half of the
    shared pool) with reference blocks tiling the gaps."""
    lines = []
    pos = 1                                  # 1-based, next uncovered
    keep = rng.random(len(sites)) < 0.5
    for site, kind in sites[keep]:
        if len(lines) >= n_records:
            break
        # reference blocks up to the site
        while pos < site and len(lines) < n_records:
            end = min(site - 1, pos + int(rng.integers(4, 60)))
            pick = rng.integers(0, len(pools["ref"]), group_samples)
            lines.append(f"1\t{pos}\t.\t{genome[pos - 1]}\t<NON_REF>\t.\t"
                         f".\tEND={end}\tGT:AD:DP:GQ:MIN_DP:PL\t"
                         + "\t".join(pools["ref"][pick]))
            pos = end + 1
        if len(lines) >= n_records:
            break
        ref = genome[site - 1]
        others = [b for b in "ACGT" if b != ref]
        if kind == 2:                        # multi-base deletion
            ref = genome[site - 1:site + 2]
            alt = f"{genome[site - 1]},<NON_REF>"
            pool = pools[3]
            span = 3
        elif kind == 1:                      # tri-allelic SNV
            a, b = rng.choice(others, 2, replace=False)
            alt = f"{a},{b},<NON_REF>"
            pool = pools[4]
            span = 1
        else:                                # bi-allelic SNV
            alt = f"{rng.choice(others)},<NON_REF>"
            pool = pools[3]
            span = 1
        info = (f"BaseQRankSum={rng.normal():.3f};"
                f"DP={int(rng.integers(10, 9999))};"
                f"MQ0={int(rng.integers(0, 9))};"
                f"RAW_MQ={rng.random() * 1e5:.2f}")
        pick = rng.integers(0, len(pool), group_samples)
        lines.append(f"1\t{site}\t.\t{ref}\t{alt}\t.\t.\t{info}\t"
                     "GT:AD:DP:GQ:MIN_DP:PL\t" + "\t".join(pool[pick]))
        pos = site + span
    return lines, pos - 1


def write_cohort(out_dir: str, n_samples: int, n_records: int,
                 seed: int = 0, n_groups: int = 0,
                 deletions: bool = True) -> Cohort:
    """Write the cohort and its JSON configuration under `out_dir`.
    `n_records` is the record count of each group's file; `n_groups`
    (default: about one group per 125 samples, at least 2) sets how
    many files the samples are spread over; `deletions=False` turns the
    deletion sites into bi-allelic SNVs (a cohort without spanning
    deletions)."""
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
    vcfs, callsets, region = [], {}, 0
    starts = set()
    for g in range(n_groups):
        names = [f"S{i}" for i in range(bounds[g], bounds[g + 1])]
        lines, last = _group_lines(rng, genome, sites, len(names),
                                   n_records, pools)
        starts.update(int(ln.split("\t", 2)[1]) for ln in lines)
        region = max(region, int(last) - 1)
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
    with open(vid_path, "w") as f:
        json.dump(_VID, f)
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
