"""The port's driver entry points (`genomicsdb_tpu_torch.graft_entry`)
against the repository root's `__graft_entry__`: `entry()`'s combine
step on the CPU equals the JAX entry's output for output, and
`dryrun_multichip(2)` runs two gloo CPU rank processes whose mesh text
equals the JAX sequential engine's on the same files (the four-rank
dryrun runs on the card, in chip_smoke.py)."""

import os

import pytest
import torch

import __graft_entry__ as jax_entry
from genomicsdb_tpu.core.config import QueryParams
from genomicsdb_tpu.core.vid import VidMapper
from genomicsdb_tpu.query import driver as jax_driver
from genomicsdb_tpu.store.import_pipeline import import_callsets
from genomicsdb_tpu_torch import graft_entry as TG
from genomicsdb_tpu_torch.tools.genome_bench import write_vid

from test_torch_combine_step import compare_outputs


def test_entry_matches_the_jax_entry():
    jfn, jargs = jax_entry.entry()
    fn, args = TG.entry(device="cpu")
    assert all(t.device.type == "cpu" for t in args)
    compare_outputs(jfn(*jargs), fn(*args))


def test_entry_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="not available"):
        TG.entry()
    with pytest.raises(RuntimeError, match="not available"):
        TG.dryrun_multichip(2)


def test_dryrun_multichip_two_cpu_ranks(tmp_path):
    rep = TG.dryrun_multichip(2, device="cpu")
    assert rep["ranks"] == 2 and rep["mesh"] == "1x2"
    assert rep["backend"] == "gloo" and rep["device"] == "cpu"
    # the JAX sequential engine on the same cohort and vid files
    path = tmp_path / "cohort.vcf"
    path.write_text("\n".join(TG.DRYRUN_VCF) + "\n")
    write_vid(str(tmp_path / "vid.json"))
    vid = VidMapper.from_files(str(tmp_path / "vid.json"))
    vid.parse_callsets({"callsets": {
        s: {"row_idx": i, "idx_in_file": i, "filename": str(path)}
        for i, s in enumerate(["S0", "S1"])}})
    store = import_callsets(vid)
    qp = QueryParams()
    qp.scan_full = True
    qp.attributes = []
    want = jax_driver.run_vcf_query(
        store, jax_driver.make_query_config(qp, vid), qp, vid)
    assert want and rep["text"] == want
