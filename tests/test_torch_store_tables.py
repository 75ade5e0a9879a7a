"""A store's derived tables (`genomicsdb_tpu_torch.store.columnar.Tables`)
on the CPU: one entry per table, replaced when its key changes, each
build timed as `rebuild.<table>` and counted in `store_rebuilds`, and a
block whose slabs are not its layout's arrays checked and uploaded
again."""

import numpy as np
import pytest

from genomicsdb_tpu_torch.core import profile
from genomicsdb_tpu_torch.core.config import QueryParams
from genomicsdb_tpu_torch.core.vid import VidMapper
from genomicsdb_tpu_torch.ops import fused_combine as FC
from genomicsdb_tpu_torch.ops.combine_step import block_to_tensors
from genomicsdb_tpu_torch.ops.store_block import store_to_block
from genomicsdb_tpu_torch.query import driver
from genomicsdb_tpu_torch.store import workspace as ws
from genomicsdb_tpu_torch.store.columnar import Tables
from genomicsdb_tpu_torch.testing import write_cohort
from genomicsdb_tpu_torch.tools import vcf2gdb


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    c = write_cohort(str(tmp_path_factory.mktemp("cohort")), 8, 60, seed=3)
    vcf2gdb.main([c.loader])
    return c


@pytest.fixture
def tracing(monkeypatch):
    monkeypatch.setattr(profile, "ENABLED", True)
    profile.clear()
    yield
    profile.clear()


class Builds:
    """build functions that count their calls."""

    def __init__(self):
        self.n = 0

    def __call__(self, value):
        def build():
            self.n += 1
            return value
        return build


def same_key(cohort):
    t, b = Tables(), Builds()
    assert t.get("events", (1, 2), b("a")) == "a"
    assert t.get("events", (1, 2), b("b")) == "a"
    assert b.n == 1


def new_key(cohort):
    t, b = Tables(), Builds()
    t.get("dense_layout", ("x",), b(1))
    assert t.get("dense_layout", ("y",), b(2)) == 2
    assert t.held["dense_layout"] == (("y",), 2)
    assert t.get("dense_layout", ("x",), b(3)) == 3      # replaced
    # arrays in a key compare by identity, never by value
    a = np.zeros(4)
    t.get("slab_upload", ("cpu", (a,)), b(4))
    assert t.get("slab_upload", ("cpu", (a,)), b(5)) == 4
    assert t.get("slab_upload", ("cpu", (a.copy(),)), b(6)) == 6
    assert b.n == 5


def per_field(cohort):
    t, b = Tables(), Builds()
    t.get(("eff_valid", "GT"), (), b("gt"))
    t.get(("eff_valid", "PL"), (), b("pl"))
    assert t.get(("eff_valid", "GT"), (), b("no")) == "gt"
    assert t.get(("eff_valid", "PL"), (), b("no")) == "pl"
    assert b.n == 2


def counts_and_spans(cohort):
    t, b = Tables(), Builds()
    n0 = profile.COUNTS.store_rebuilds
    t.get("gt_bad", (), b(1))
    t.get("gt_bad", (), b(2))
    t.get(("string_codes", "REF"), (), b(3))
    t.get(("string_codes", "ALT"), (), b(4))
    t.get("events", (0,), b(5))
    t.get("events", (1,), b(6))
    names = [s.name for s in profile.spans()]
    assert names == ["rebuild.gt_bad", "rebuild.string_codes",
                     "rebuild.string_codes", "rebuild.events",
                     "rebuild.events"]
    assert profile.COUNTS.store_rebuilds - n0 == b.n == 5


def other_slabs(cohort):
    """A block from the store: its slab upload and range checks are held
    and reused; a block whose slabs are other arrays gets neither."""
    store = ws.open_array(cohort.workspace, cohort.array)
    qc = driver.make_query_config(
        QueryParams.from_file(cohort.query, 0),
        VidMapper.from_files(cohort.vid, cohort.callsets))
    blk = store_to_block(store, qc, pad_cells_to=8)
    assert blk.tables is store.tables
    first = block_to_tensors(blk, "cpu")
    assert FC._narrow_inputs_ok(blk)
    n0 = profile.COUNTS.store_rebuilds
    again = block_to_tensors(blk, "cpu")
    assert FC._narrow_inputs_ok(blk)
    assert profile.COUNTS.store_rebuilds == n0
    assert all(x is y for x, y in zip(first[:12], again[:12]))
    blk.pl = blk.pl.copy()
    blk.pl[0, 0, 0] = 100_000
    other = block_to_tensors(blk, "cpu")
    assert other[0] is not first[0] and int(other[0][0, 0, 0]) == 100_000
    assert not FC._narrow_inputs_ok(blk)
    assert profile.COUNTS.store_rebuilds == n0 + 2
    names = [s.name for s in profile.spans()]
    assert names.count("rebuild.slab_upload") == 2
    assert names.count("rebuild.range_check") == 2


@pytest.mark.parametrize("case", [same_key, new_key, per_field,
                                  counts_and_spans, other_slabs],
                         ids=lambda f: f.__name__)
def test_one_entry_per_table_replaced_when_its_key_changes(case, cohort,
                                                           tracing):
    case(cohort)
