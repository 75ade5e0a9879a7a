"""The frozen cohort generator writes the same bytes it always has."""

import glob
import hashlib

import pytest

from gdb_bench.cohort import write_cohort

PINNED = {
    2: "686216c5fbc4942a8b1decdfee14bafa18efb6c8be8e8976f4a961f6b16bb065",
    4: "4e275309368090ec92af0b7b8e32699790b92299ccf14f7429402168bcd1ddac",
}


@pytest.mark.parametrize("ploidy", sorted(PINNED))
def test_generator_digest(tmp_path, ploidy):
    write_cohort(str(tmp_path), 40, 120, seed=2 ** 31 + 5, ploidy=ploidy)
    h = hashlib.sha256()
    for p in sorted(glob.glob(str(tmp_path / "group*.g.vcf"))) \
            + [str(tmp_path / "ref.fa")]:
        with open(p, "rb") as f:
            h.update(f.read())
    assert h.hexdigest() == PINNED[ploidy]
