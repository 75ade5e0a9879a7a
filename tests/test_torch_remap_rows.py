"""The port's `combine_step(remap_rows=...)` (the PL/AD/GT remaps of the
general step restricted to given rows) against genomicsdb_tpu's,
output by output, and on a cohort with a 17-allele site (past the CUDA
kernel's 16-allele gate, so its blocks take the general step): the
restriction to the store block's variant rows equals the unrestricted
step there, and the port's writer text (which takes no restriction)
equals the JAX block engine's with its CPU-device restriction on
(`GENOMICSDB_TPU_VARROWS` 1) and off (0)."""

import contextlib
import io
import json
import os
import random

import numpy as np
import pytest
import torch

from genomicsdb_tpu.ops import combine_step as JC
from genomicsdb_tpu.tools import gdb_query as jax_gdb_query
from genomicsdb_tpu_torch.ops import combine_step as TC
from genomicsdb_tpu_torch.ops import fused_combine as FC
from genomicsdb_tpu_torch.ops.store_block import store_to_block
from genomicsdb_tpu_torch.query.driver import make_query_config
from genomicsdb_tpu_torch.tools import gdb_query as torch_gdb_query
from genomicsdb_tpu_torch.tools import vcf2gdb

from test_torch_combine_step import compare_outputs, make_blocks

CASES = {
    "diploid": dict(S=8, C=64, R=4096, seed=21),
    "wide_alleles_m20": dict(S=5, C=40, R=2048, seed=3, m=20),
    "mixed_phased_pmax3": dict(S=4, C=48, R=4096, seed=17, ploidy=3,
                               mixed=True, phased=True),
}


@pytest.mark.parametrize("med", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_remap_rows_matches_jax(case, med):
    """Every third record (padded with row 0 to a bucket of 16 or more,
    as the writer pads) and, optionally, a med_rows restriction."""
    kw = CASES[case]
    jblk, tblk = make_blocks(**kw)
    B = jblk.live.shape[0]
    rows = np.arange(0, B, 3)
    bucket = 16
    while bucket < len(rows):
        bucket *= 2
    remap_rows = np.zeros(bucket, np.int32)
    remap_rows[:len(rows)] = rows
    med_rows = np.arange(1, B, 2).astype(np.int32) if med else None
    flags = dict(max_merged=kw.get("m", 4), ploidy=kw.get("ploidy", 2),
                 gt_phase=kw.get("phased", False),
                 mixed_ploidy=kw.get("mixed", False))
    ref = JC.combine_step(*JC.block_to_args(jblk), med_rows=med_rows,
                          remap_rows=remap_rows, **flags)
    got = TC.combine_step(*TC.block_to_tensors(tblk, "cpu"),
                          med_rows=med_rows, remap_rows=remap_rows, **flags)
    assert got["pl"].shape[0] == bucket and got["live"].shape[0] == B
    compare_outputs(ref, got)


VID = {
    "fields": {
        "PASS": {"vcf_field_class": ["FILTER"], "type": "int"},
        "GT": {"vcf_field_class": ["FORMAT"], "type": "int", "length": "P"},
        "AD": {"vcf_field_class": ["FORMAT"], "type": "int", "length": "R"},
        "DP": {"vcf_field_class": ["FORMAT", "INFO"], "type": "int"},
        "GQ": {"vcf_field_class": ["FORMAT"], "type": "int"},
        "MIN_DP": {"vcf_field_class": ["FORMAT"], "type": "int"},
        "PL": {"vcf_field_class": ["FORMAT"], "type": "int", "length": "G"},
        "END": {"vcf_field_class": ["INFO"], "type": "int"},
    },
    "contigs": {"1": {"length": 249250621, "tiledb_column_offset": 0}},
}
HEADER = [
    "##fileformat=VCFv4.1",
    '##ALT=<ID=NON_REF,Description="n">',
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="g">',
    '##FORMAT=<ID=AD,Number=.,Type=Integer,Description="a">',
    '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="d">',
    '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="q">',
    '##FORMAT=<ID=MIN_DP,Number=1,Type=Integer,Description="m">',
    '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="p">',
    '##INFO=<ID=END,Number=1,Type=Integer,Description="e">',
    "##contig=<ID=1,length=249250621>",
]
N_FILES, PER_FILE, SITE = 5, 2, 2001


def _cell(rng, n_alleles, ref_block):
    g = n_alleles * (n_alleles + 1) // 2
    if ref_block:
        return (f"0/0:.:{rng.randint(1, 60)}:{rng.randint(0, 99)}:"
                f"{rng.randint(0, 40)}:0," + ",".join(
                    str(rng.randint(0, 999)) for _ in range(g - 1)))
    ad = ",".join(str(rng.randint(0, 60)) for _ in range(n_alleles - 1))
    return (f"0/{rng.randint(1, n_alleles - 2)}:{ad},0:"
            f"{rng.randint(10, 99)}:{rng.randint(10, 99)}:.:"
            + ",".join(str(rng.randint(0, 999)) for _ in range(g)))


def write_many_allele_cohort(d):
    """N_FILES files of PER_FILE samples: reference blocks, a bi-allelic
    SNV every ~150 bases, and at column SITE - 1 each file's own three
    insertions, so the site merges REF + 15 ALTs + NON_REF = 17 alleles.
    Returns (loader, query) paths."""
    rng = random.Random(5)
    callsets = {}
    for f in range(N_FILES):
        names = [f"F{f}S{j}" for j in range(PER_FILE)]
        lines = []
        pos = 1
        while pos < 4000:
            if pos == SITE:
                alts = [("C" + "ACGT"[f % 4] * (f // 4 + 1) + "ACG"[k]
                         + "T" * k) for k in range(3)]
                lines.append(f"1\t{pos}\t.\tC\t{','.join(alts)},<NON_REF>"
                             "\t.\t.\t.\tGT:AD:DP:GQ:MIN_DP:PL\t"
                             + "\t".join(_cell(rng, 5, False)
                                         for _ in names))
                pos += 1
            elif rng.random() < 0.1 and pos + 1 != SITE:
                lines.append(f"1\t{pos}\t.\tC\tA,<NON_REF>\t.\t.\t.\t"
                             "GT:AD:DP:GQ:MIN_DP:PL\t"
                             + "\t".join(_cell(rng, 3, False)
                                         for _ in names))
                pos += 1
            else:
                end = pos + rng.randint(5, 150)
                if pos < SITE <= end:
                    end = SITE - 1
                lines.append(f"1\t{pos}\t.\tC\t<NON_REF>\t.\t.\tEND={end}\t"
                             "GT:AD:DP:GQ:MIN_DP:PL\t"
                             + "\t".join(_cell(rng, 2, True)
                                         for _ in names))
                pos = end + 1
        path = os.path.join(d, f"file{f}.g.vcf")
        with open(path, "w") as fh:
            fh.write("\n".join(HEADER) + "\n#CHROM\tPOS\tID\tREF\tALT\tQUAL"
                     "\tFILTER\tINFO\tFORMAT\t" + "\t".join(names) + "\n")
            fh.write("\n".join(lines) + "\n")
        for j, nm in enumerate(names):
            callsets[nm] = {"row_idx": f * PER_FILE + j, "idx_in_file": j,
                            "filename": path}
    paths = {n: os.path.join(d, n) for n in
             ("vid.json", "callsets.json", "loader.json", "query.json")}
    ws = os.path.join(d, "ws")
    docs = {
        "vid.json": VID,
        "callsets.json": {"callsets": callsets},
        "loader.json": {"column_partitions": [
            {"begin": 0, "workspace": ws, "array_name": "a"}],
            "callset_mapping_file": paths["callsets.json"],
            "vid_mapping_file": paths["vid.json"],
            "treat_deletions_as_intervals": True},
        "query.json": {"workspace": ws, "array_name": "a",
                       "query_column_ranges": [{"range_list": [
                           {"low": 0, "high": 5000}]}],
                       "vid_mapping_file": paths["vid.json"],
                       "callset_mapping_file": paths["callsets.json"],
                       "attributes": []},
    }
    for name, doc in docs.items():
        with open(paths[name], "w") as fh:
            json.dump(doc, fh)
    return paths["loader.json"], paths["query.json"]


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def test_general_path_text_with_and_without_the_restriction(tmp_path,
                                                            monkeypatch):
    loader, query = write_many_allele_cohort(str(tmp_path))
    vcf2gdb.main([loader])
    argv = ["-j", query, "--produce-Broad-GVCF"]

    # the restriction on the store's block: its variant rows, padded
    args = torch_gdb_query._build_parser().parse_args(argv)
    _, qp, vid, store = torch_gdb_query.load_context(args, 0)
    blk, meta = store_to_block(store, make_query_config(qp, vid),
                               interval=(0, 5000), return_meta=True)
    assert not FC.kernel_takes(blk, blk.inv_bs.shape[2], blk.ploidy, False)
    var = np.nonzero(~meta.is_ref_block_only)[0]
    assert 0 < len(var) < blk.live.shape[0]
    rows = np.zeros(1 << max(4, (len(var) - 1).bit_length()), np.int32)
    rows[:len(var)] = var
    flags = dict(max_merged=blk.inv_bs.shape[2], ploidy=blk.ploidy,
                 gt_phase=meta.plan.gt_phase)
    t = TC.block_to_tensors(blk, "cpu")
    full = TC.combine_step(*t, **flags)
    part = TC.combine_step(*t, remap_rows=rows, **flags)
    for k, v in full.items():
        want = v[rows] if k in ("pl", "ad", "gt", "gq", "dp_format",
                                "min_dp") else v
        assert torch.equal(want.view(torch.int32) if want.is_floating_point()
                           else want,
                           part[k].view(torch.int32)
                           if part[k].is_floating_point() else part[k]), k

    # the writer's text against the JAX block engine's, restricted or not
    monkeypatch.setenv("GENOMICSDB_TPU_SERVING_INDEX", "0")
    seen = []
    step = FC.combine_step

    def spy(*args, **kw):
        seen.append(kw.get("remap_rows"))
        return step(*args, **kw)

    monkeypatch.setattr(FC, "combine_step", spy)
    text = _run(torch_gdb_query.main, argv + ["--device", "cpu"])
    assert seen and all(r is None for r in seen), seen
    lines = text.splitlines()
    site = [ln for ln in lines if ln.split("\t")[1] == str(SITE)]
    assert len(site) == 1 and site[0].split("\t")[4].count(",") == 15
    assert len(lines) > 100
    for varrows in ("0", "1"):
        monkeypatch.setenv("GENOMICSDB_TPU_VARROWS", varrows)
        assert _run(jax_gdb_query.main, argv + ["--engine", "block"]) == text
