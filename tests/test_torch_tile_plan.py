"""The CUDA kernel's host-side plan and tables on the CPU.

The kernel (csrc/fused_gather_remap.cu) runs only on the card; what it is
handed is computed here and checked here: the tile plan for every gated
(M, ploidy, mixed, form) fits shared memory, its tiles cover B x S with
no gap or overlap and its genotype chunks cover G_out; the term table
and the diploid closed form give the canonical genotype index of every
genotype; the Python plan and the kernel's `Plan` struct list the same
fields in the same order; the ctypes binding matches the C signature.
"""

import math
import os
import re

import numpy as np
import pytest
import torch

from genomicsdb_tpu_torch.ops import _kernel_build as KB
from genomicsdb_tpu_torch.ops import fused_combine as FC
from genomicsdb_tpu_torch.ops.cell_block import genotype_combo_table

CU = os.path.join(KB.CSRC_DIR, "fused_gather_remap.cu")
FORMS = {"wide": (False, False), "narrow": (True, False),
         "narrow_scalars": (True, True)}
SHAPES = ((1, 1), (37, 5), (300, 130))      # (B, S), ragged on purpose


def _tiles(plan, B, S):
    """(b0, b1, s0, s1) of every tile, in the kernel's order (tile t is
    records tile t / n_ts, samples tile t % n_ts)."""
    for t in range(plan.n_tiles):
        tbi, tsi = divmod(t, plan.n_ts)
        b0, s0 = tbi * plan.tb, tsi * plan.ts
        yield b0, min(b0 + plan.tb, B), s0, min(s0 + plan.ts, S)


def _g_chunks(plan, G_out):
    """(g0, g1) of every PL chunk (chunk c starts at c * gc)."""
    return [(c * plan.gc, min((c + 1) * plan.gc, G_out))
            for c in range(plan.n_chunks)]


def _check_plan(plan, B, S, G_out):
    assert plan.smem <= FC.SMEM_MAX == 232448
    assert 1 <= plan.grid <= max(plan.n_tiles * plan.n_chunks, 1)
    assert plan.tb == 1 << plan.log2_tb
    assert plan.tb * plan.ts == 1 << plan.log2_nbs <= FC.THREADS
    # tiles: every (record, sample) exactly once
    seen = np.zeros((B, S), np.int32)
    for b0, b1, s0, s1 in _tiles(plan, B, S):
        assert b0 < b1 <= B and s0 < s1 <= S
        seen[b0:b1, s0:s1] += 1
    assert (seen == 1).all()
    # genotype chunks: [0, G_out) in order, no gap or overlap; a row is
    # cut only when a tile holds one sample
    chunks = _g_chunks(plan, G_out)
    assert len(chunks) == plan.n_chunks
    assert chunks[0][0] == 0 and chunks[-1][1] == G_out
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(g0 < g1 for g0, g1 in chunks)
    if plan.n_chunks > 1:
        assert plan.ts == 1
    # shared-memory sections: 16-byte aligned and inside the total
    for name in FC.PLAN_FIELDS:
        if name.startswith(("off_", "lut_")) and name not in ("lut_row",
                                                              "lut_bytes"):
            assert getattr(plan, name) % 16 == 0, name
    for kind in ("ad", "gt", "sc", "w", "pl"):
        slot = getattr(plan, "slot_" + kind)
        assert slot % 16 == 0 and 16 << getattr(plan, "l2u_" + kind) >= slot
    assert plan.off_lut + 2 * plan.lut_bytes <= plan.off_hdr
    assert plan.off_pl + plan.tb * plan.slot_pl == plan.smem


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("ploidy", range(1, FC.MAX_PLOIDY + 1))
@pytest.mark.parametrize("M", range(1, FC.MAX_MERGED + 1))
def test_tile_plan_fits_and_covers(M, ploidy, mixed, form):
    narrow, scalars = FORMS[form]
    G_out = len(genotype_combo_table(M, ploidy))
    gt_w = 2 * ploidy - 1 if mixed else ploidy
    for B, S in SHAPES:
        plan = FC.tile_plan(B, S, M, G_out, gt_w, 1, 1, 1, mixed=mixed,
                            narrow=narrow, narrow_scalars=scalars)
        _check_plan(plan, B, S, G_out)
        # staging slots hold a whole run at any offset modulo 16
        ev = 2 if narrow else 4
        assert plan.slot_pl >= plan.ts * plan.gc * ev + 15
        assert plan.slot_ad >= plan.ts * M * ev + 15
        assert plan.slot_gt >= plan.ts * gt_w * ev + 15


def test_tile_plan_main_path_and_largest_rows():
    """The main path's launch (1,024 records x 1,000 samples, m 4,
    diploid, narrow) takes whole 8 x 32 tiles within the preferred
    budget; a mixed block at m 16, ploidy up to 3 takes whole rows
    within it too; m 16, ploidy 6 splits PL into genotype chunks of
    32 x 1 tiles."""
    main = FC.tile_plan(1024, 1000, 4, 10, 2, 1, 1, 1, mixed=False,
                        narrow=True, narrow_scalars=True)
    assert (main.tb, main.ts, main.n_chunks) == (8, 32, 1)
    assert main.smem <= FC.SMEM_TARGET
    assert main.n_tiles == 128 * 32
    for narrow in (False, True):
        mixed = FC.tile_plan(3215, 32, 16, 816, 5, 1, 1, 1, mixed=True,
                             narrow=narrow, narrow_scalars=narrow)
        assert mixed.n_chunks == 1 and mixed.smem <= FC.SMEM_TARGET
        _check_plan(mixed, 3215, 32, 816)
    big = FC.tile_plan(100, 7, 16, 54264, 11, 1, 1, 1, mixed=True,
                       narrow=False, narrow_scalars=False)
    assert (big.tb, big.ts) == (32, 1) and big.n_chunks > 1
    _check_plan(big, 100, 7, 54264)
    assert FC.tile_plan(0, 5, 4, 10, 2, 1, 1, 1, mixed=False, narrow=False,
                        narrow_scalars=False).n_tiles == 0


@pytest.mark.parametrize("ploidy", range(1, FC.MAX_PLOIDY + 1))
def test_term_table_gives_the_canonical_genotype_index(ploidy):
    """sum_i term[i][a_i] over a genotype's ascending alleles is its
    row in the canonical enumeration (the general path's index), and
    the diploid path's enumeration g = k (k + 1) / 2 + j and index
    lo + hi (hi + 1) / 2 agree with it."""
    tables = FC.combo_tables(FC.MAX_MERGED, ploidy, False)
    term = tables[FC._HEADER_INTS:FC._HEADER_INTS
                  + FC.MAX_PLOIDY * FC.TERM_ROWS].reshape(
                      FC.MAX_PLOIDY, FC.TERM_ROWS)
    assert term[5, 63] == math.comb(68, 6) < 2**31 // 6
    combos = genotype_combo_table(FC.MAX_MERGED, ploidy)
    idx = sum(term[i, combos[:, i]] for i in range(ploidy))
    np.testing.assert_array_equal(idx, np.arange(len(combos)))
    if ploidy == 2:
        g = [k * (k + 1) // 2 + j for k in range(FC.MAX_MERGED)
             for j in range(k + 1)]
        assert [tuple(r) for r in combos] == [
            (j, k) for k in range(FC.MAX_MERGED) for j in range(k + 1)]
        lo, hi = combos[:, 0], combos[:, 1]
        np.testing.assert_array_equal(lo + hi * (hi + 1) // 2, g)


@pytest.mark.parametrize("mixed", [False, True])
def test_combo_tables_header(mixed):
    """Each ploidy the launch needs has one word per genotype: allele
    q in bits 4q..4q+3, the largest allele in bits 24..27."""
    M, ploidy = 16, 3
    t = FC.combo_tables(M, ploidy, mixed)
    for p in range(1, FC.MAX_PLOIDY + 1):
        off, n = t[2 * p:2 * p + 2]
        if p == ploidy or (mixed and p < ploidy):
            combos = genotype_combo_table(M, p)
            assert n == len(combos)
            words = t[off:off + n]
            np.testing.assert_array_equal(
                np.stack([(words >> (4 * q)) & 15 for q in range(p)], 1),
                combos)
            np.testing.assert_array_equal(words >> 24, combos.max(axis=1))
        else:
            assert n == 0
    assert len(t) == FC._HEADER_INTS + FC.MAX_PLOIDY * FC.TERM_ROWS + sum(
        len(genotype_combo_table(M, p))
        for p in (range(1, ploidy + 1) if mixed else (ploidy,)))


def test_device_tables_are_uploaded_once():
    cpu = torch.device("cpu")
    a = FC._device_tables(4, 2, False, cpu)
    assert FC._device_tables(4, 2, False, cpu) is a
    assert FC._device_tables(4, 2, True, cpu) is not a
    np.testing.assert_array_equal(a.numpy(), FC.combo_tables(4, 2, False))


def _c_struct_fields(src, name):
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            assert decl.startswith("int "), decl
            fields += [f.strip() for f in decl[4:].split(",")]
    return tuple(fields)


def test_plan_fields_match_the_kernel_struct():
    with open(CU) as f:
        src = f.read()
    assert _c_struct_fields(src, "Plan") == FC.PLAN_FIELDS
    plan = FC.tile_plan(64, 64, 4, 10, 2, 1, 1, 1, mixed=False,
                        narrow=True, narrow_scalars=True)
    arr = plan.as_array()
    assert arr.dtype == np.int32 and len(arr) == len(FC.PLAN_FIELDS)
    assert arr[FC.PLAN_FIELDS.index("smem")] == plan.smem


def test_binding_matches_the_c_signature():
    with open(CU) as f:
        src = f.read()
    sig = re.search(r'extern "C" int gdb_fused_gather_remap\((.*?)\)\s*\{',
                    src, re.S).group(1)
    params = [p.strip() for p in sig.split(",")]

    class Lib:
        class gdb_fused_gather_remap:
            pass

        class gdb_cuda_error_string:
            pass

    KB._bind(Lib)
    argtypes = Lib.gdb_fused_gather_remap.argtypes
    assert len(argtypes) == len(params)
    for p, t in zip(params, argtypes):
        kind = p.rsplit(" ", 1)[0]
        want = {"long long": KB.ctypes.c_longlong, "int": KB.ctypes.c_int}
        assert t is want.get(kind, KB.ctypes.c_void_p), p
