"""The CUDA kernel's host-side plan and tables on the CPU.

The kernel (csrc/fused_gather_remap.cu) runs only on the card; what it is
handed is computed here and checked here: the tile plan for every gated
(M, ploidy, mixed, form) fits shared memory, its tiles cover B x S with
no gap or overlap and its genotype chunks cover G_out; the term table
and the diploid closed form give the canonical genotype index of every
genotype; the Python plan and the kernel's `Plan` struct list the same
fields in the same order; the ctypes binding matches the C signature;
the Python mirror of the kernel's `dispatch` (`instantiation`) picks
the instantiation the .cu's text picks, for every launch the kernel
takes; every one-pass plan of ploidy 3-6 gives each of the polyploid
family's 256 threads a run of genotypes.
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
CUH = os.path.join(KB.CSRC_DIR, "fused_gather_remap.cuh")
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


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("ploidy", [1, 2])
def test_ploidy2_plans_take_whole_rows(ploidy, mixed, form):
    """Every launch of the register-bound families (ploidy <= 2, mixed
    or not, M <= 16) stages whole PL rows: one pass of G_out genotypes,
    as the kernel's `dispatch` requires of the ploidy <= 2 family; the
    route cohort's largest mixed launch among them."""
    narrow, scalars = FORMS[form]
    gt_w = 2 * ploidy - 1 if mixed else ploidy
    for M in range(1, FC.MAX_MERGED + 1):
        G_out = len(genotype_combo_table(M, ploidy))
        assert G_out <= 136
        for B, S in SHAPES + ((1031, 1000),):
            plan = FC.tile_plan(B, S, M, G_out, gt_w, 1, 1, 1, mixed=mixed,
                                narrow=narrow, narrow_scalars=scalars)
            _check_plan(plan, B, S, G_out)
            assert (plan.n_chunks, plan.gc) == (1, G_out)
            assert (plan.lut_inv > plan.lut_gtl) == mixed   # the GT-length row


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
    with open(CUH) as f:
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


def _c_dispatch(src):
    """The .cu's `dispatch` body as a Python function of (ploidy, mixed,
    M, n_chunks): (family, bound on M, bound on the ploidy or 0) of the
    instantiation it launches, or None where it refuses the launch.
    Each line of the body is one of `if (cond) {`, `}`, `[if (cond)]
    return launch<VT, ST, kFamily, kM[, kP]>(a, p, st);` or `[if (cond)]
    return cudaErrorInvalidValue;`."""
    body = re.search(r"cudaError_t dispatch\(const Args& a, const Plan& p, "
                     r"cudaStream_t st\) \{\n(.*?)\n\}\n", src,
                     re.S).group(1)
    families = {"kGeneral": "general", "kDiploid": "diploid",
                "kPloidy2": "ploidy2", "kPolyploid": "polyploid"}

    def cond(c):
        c = c.replace("&&", " and ").replace("||", " or ")
        c = re.sub(r"!(?!=)", " not ", c)
        return re.sub(r"\b[ap]\.", "", c)

    def ret(r):
        m = re.fullmatch(r"return launch<VT, ST, (\w+), (\d+)(?:, (\d+))?>"
                         r"\(a, p, st\);", r)
        if m:
            return (f"return ({families[m.group(1)]!r}, {m.group(2)}, "
                    f"{m.group(3) or 0})")
        assert r == "return cudaErrorInvalidValue;", r
        return "return None"

    lines, depth = ["def dispatch(ploidy, mixed, M, n_chunks):"], 1
    for line in body.splitlines():
        line = re.sub(r"//.*", "", line).strip()
        if not line:
            continue
        if line == "}":
            depth -= 1
            continue
        m = re.fullmatch(r"if \((.*)\) \{", line)
        if m:
            lines.append("    " * depth + f"if {cond(m.group(1))}:")
            depth += 1
            continue
        m = re.fullmatch(r"if \((.*?)\) (return .*)", line)
        if m:
            lines.append("    " * depth + f"if {cond(m.group(1))}: "
                         + ret(m.group(2)))
        else:
            lines.append("    " * depth + ret(line))
    assert depth == 1
    scope = {}
    exec("\n".join(lines), scope)
    return scope["dispatch"]


def test_instantiation_mirrors_the_kernel_dispatch():
    """`fused_combine.instantiation` picks, for every launch the kernel
    takes, the instantiation the .cu's `dispatch` launches: diploid
    non-mixed launches keep their three instantiations, every launch of
    ploidy <= 2 that is mixed, and every haploid one, takes the ploidy
    <= 2 family at the same bounds on M; ploidy 3-6 in one PL pass the
    polyploid family at M <= 8 or 16, built for ploidy 3, 4 or 6 (5
    runs as 6), and in genotype chunks the general one; a ploidy <= 2
    launch in more than one PL pass is refused."""
    with open(CU) as f:
        dispatch = _c_dispatch(f.read())
    seen = set()
    for ploidy in range(1, FC.MAX_PLOIDY + 1):
        for mixed in (False, True):
            for M in range(1, FC.MAX_MERGED + 1):
                for n_chunks in (1, 2):
                    got = FC.instantiation(ploidy, mixed, M, n_chunks)
                    want = dispatch(ploidy, mixed, M, n_chunks)
                    bound = 4 if M <= 4 else 8 if M <= 8 else 16
                    if ploidy == 2 and not mixed:
                        assert got == ("diploid", bound)
                    elif ploidy <= 2:
                        assert got == ("ploidy2", bound)
                        if n_chunks > 1:
                            assert want is None
                            continue
                    elif n_chunks == 1:
                        assert got == ("polyploid", 8 if M <= 8 else 16)
                        assert want[2] == {3: 3, 4: 4}.get(ploidy, 6)
                    else:
                        assert got == ("general", 0)
                    assert want[:2] == got
                    seen.add(want)
    assert seen == {(f, m, 0) for f in ("diploid", "ploidy2")
                    for m in (4, 8, 16)} | {("general", 0, 0)} | {
        ("polyploid", m, p) for m in (8, 16) for p in (3, 4, 6)}


def test_instantiations_are_built_once_each():
    """Every instantiation `dispatch` launches is built by exactly one
    family's source (`GDB_FGR_<FAMILY>(GDB_FGR_DEFINE)`), from the
    header's lists, and declared `extern` for the other units."""
    with open(CUH) as f:
        hdr = f.read()
    lists = dict(re.findall(r"#define GDB_FGR_(\w+)\(X\) (.*?)\n(?!\s)",
                            hdr.replace("\\\n", " "), re.S))
    built = []
    for src in KB.sources():
        with open(src) as f:
            text = f.read()
        for fam in re.findall(r"^GDB_FGR_(\w+)\(GDB_FGR_DEFINE\)$", text,
                              re.M):
            built += re.findall(r"X\((\w+), (\d+), (\d+)\)", lists[fam])
        if os.path.basename(src) != "fused_gather_remap.cu":
            assert "dispatch" not in text
    assert len(built) == len(set(built)) == 13
    for fam in lists:
        if fam not in ("FORM", "FORMS", "DEFINE", "EXTERN"):
            assert f"GDB_FGR_{fam}(GDB_FGR_EXTERN)" in hdr
    with open(CU) as f:
        dispatch = _c_dispatch(f.read())
    families = {"diploid": "kDiploid", "ploidy2": "kPloidy2",
                "general": "kGeneral", "polyploid": "kPolyploid"}
    for ploidy in range(1, FC.MAX_PLOIDY + 1):
        for mixed in (False, True):
            for M in range(1, FC.MAX_MERGED + 1):
                for n_chunks in (1, 2):
                    want = dispatch(ploidy, mixed, M, n_chunks)
                    if want is not None:
                        fam, m, p = want
                        assert (families[fam], str(m), str(p)) in built


def _fake_prepare(n_chunks):
    """A stand-in for `_prepare`: a bound launch that runs nothing, with
    its plan's PL passes."""
    def prepare(*args, **kw):
        launch = lambda: None           # noqa: E731
        launch.n_chunks = n_chunks
        return {}, launch
    return prepare


def test_launch_counts_the_ploidy2_instantiation(monkeypatch):
    """`_launch` counts a launch of the ploidy <= 2 instantiation, mixed
    or haploid, in `ploidy2_launches`, and no other (a bound launch
    that runs nothing stands in for the kernel)."""
    monkeypatch.setattr(FC, "_prepare", _fake_prepare(1))
    fg = FC.fused_gather_remap
    for ploidy, mixed, counted in ((2, False, 0), (2, True, 1),
                                   (1, False, 1), (1, True, 1),
                                   (3, True, 0), (6, False, 0)):
        before = (fg.launches, fg.ploidy2_launches)
        FC._launch(max_merged=8, ploidy=ploidy, gt_phase=False,
                   mixed=mixed, narrow=True, narrow_scalars=True)
        assert (fg.launches, fg.ploidy2_launches) == (
            before[0] + 1, before[1] + counted)


@pytest.mark.parametrize("n_chunks", [1, 3])
def test_launch_counts_the_polyploid_instantiation(monkeypatch, n_chunks):
    """`_launch` counts a launch of ploidy 3-6 in one PL pass, mixed or
    not, in `polyploid_launches`; one in genotype chunks (the general
    family) and launches of ploidy <= 2 are not counted there."""
    monkeypatch.setattr(FC, "_prepare", _fake_prepare(n_chunks))
    fg = FC.fused_gather_remap
    # (ploidy, mixed, counted as polyploid, counted as ploidy <= 2)
    for ploidy, mixed, poly, p2 in ((2, False, 0, 0), (2, True, 0, 1),
                                    (1, False, 0, 1), (3, True, 1, 0),
                                    (3, False, 1, 0), (4, False, 1, 0),
                                    (5, True, 1, 0), (6, False, 1, 0)):
        if n_chunks > 1 and ploidy <= 2:
            continue                    # refused by the kernel
        before = (fg.launches, fg.polyploid_launches, fg.ploidy2_launches)
        FC._launch(max_merged=7, ploidy=ploidy, gt_phase=False,
                   mixed=mixed, narrow=False, narrow_scalars=False)
        assert (fg.launches, fg.polyploid_launches, fg.ploidy2_launches) \
            == (before[0] + 1, before[1] + poly * (n_chunks == 1),
                before[2] + p2)


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("ploidy", [3, 4, 5, 6])
def test_polyploid_plans_keep_every_thread_busy(ploidy, mixed, form):
    """Every one-pass plan of ploidy 3-6 (the polyploid family's) over a
    block of at least 256 (record, sample) pairs splits each pair's PL
    row among 256 / (tile pairs) threads so that every thread of the
    block has a run of at least one genotype, at every M: the tetraploid
    1,000-sample launch (M 7, 210 genotypes) among them.  Rows that do
    not fit take genotype chunks (the general family)."""
    narrow, scalars = FORMS[form]
    gt_w = 2 * ploidy - 1 if mixed else ploidy
    one_pass = 0
    for M in range(1, FC.MAX_MERGED + 1):
        G_out = len(genotype_combo_table(M, ploidy))
        for B, S in ((1030, 1000), (300, 130), (64, 8), (1000, 4), (16, 16)):
            plan = FC.tile_plan(B, S, M, G_out, gt_w, 1, 1, 1, mixed=mixed,
                                narrow=narrow, narrow_scalars=scalars)
            if B * S < 100_000:          # the coverage check is per element
                _check_plan(plan, B, S, G_out)
            if plan.n_chunks > 1:
                assert FC.instantiation(ploidy, mixed, M, plan.n_chunks) \
                    == ("general", 0)
                continue
            one_pass += 1
            assert plan.gc == G_out
            nbs = plan.tb * plan.ts
            parts = FC.THREADS // nbs
            run = -(-G_out // parts)
            assert parts * nbs == FC.THREADS
            assert (parts - 1) * run < G_out       # the last run not empty
            # the polyploid term table fits the general family's header
            # and term table (6 rows of 65 ints)
            assert plan.off_cell - plan.off_hdr >= 4 * 6 * 65
    assert one_pass >= 5 * 7
    if ploidy == 4 and not mixed:
        plan = FC.tile_plan(1030, 1000, 7, 210, 4, 1, 1, 1, mixed=False,
                            narrow=narrow, narrow_scalars=scalars)
        assert plan.n_chunks == 1
