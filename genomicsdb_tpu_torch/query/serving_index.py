"""Materialized combined-record serving index on the port (counterpart
of `genomicsdb_tpu.query.serving_index`).

The reference's main serving consumer is the GATK/Spark split pattern:
thousands of small interval queries against one immutable store — one
split per (partition x query block), each read through a fresh
GenomicsDBQueryStream (spark/GenomicsDBInputFormat.java:65,
reader/GenomicsDBQueryStream.java:38).  The reference recomputes the
combine for every split.  Here the full-store combined output (text
lines + encoded BCF2 records) is materialized ONCE per (store, query
signature) and each interval query is served by SLICING the
materialization; only records clipped by the interval boundaries are
recomputed through the live engine.

Correctness rests on a locality property of the combine: an emitted
record's bytes depend only on the cells live at its start column
(scan_and_operate / handle_gvcf_ranges semantics,
query_variants.cc:296-332), never on the query interval — EXCEPT where
the interval boundary cuts a live cell (the intersect-at-begin sweep
clips the head record to start at the query begin, and a gVCF range is
clipped at the query end).  A boundary position p is a *clean break*
when no queried-row cell spans it (no cell with col < p <= eff_end); on
a clean break the two sides are independent, so:

  * head: if lo is clean, index records with start >= lo serve as-is;
    else the engine recomputes [lo, s_k - 1] where s_k is the first
    clean record start > lo.
  * tail: if hi+1 is clean, no index record is clipped at hi; else the
    engine recomputes [s_t, hi] where s_t is the last clean record
    start <= hi.

Any interval with no usable clean break falls back to the engine
entirely.  Served + recomputed bytes are byte-identical to a direct
engine query (tests/test_torch_serving_index.py).

Every call into the block engine (the index build, block-engine edge
recomputes) takes the torch `device` it combines on and the driver's
`pack` keyword; the default edge engine is the sequential one, on the
host.  The per-store cache's counters are guarded by a lock: server
threads run queries side by side.
"""

from __future__ import annotations

import os
import threading
from typing import Iterator, List, Optional

import numpy as np

#: stores larger than this (cells) are never indexed (memory bound:
#: text + BCF2 materialization is roughly 2.5x the raw cell payload)
DEFAULT_MAX_CELLS = 32 * 1024 * 1024
#: build on the Nth query with the same signature
BUILD_AFTER_QUERIES = 2

_tls = threading.local()
# guards every store's _serving_idx_cache entries (check-then-act on the
# query counter and the building flag); the build itself runs unlocked
_CACHE_LOCK = threading.Lock()


def enabled() -> bool:
    if getattr(_tls, "bypass", False):
        return False
    return os.environ.get("GENOMICSDB_TPU_SERVING_INDEX", "1") \
        not in ("0", "false")


class _Bypass:
    """Engine recomputes (edges, index build) must run the LIVE engine:
    any inner lookup on this thread serves the direct path."""

    def __enter__(self):
        self._prev = getattr(_tls, "bypass", False)
        _tls.bypass = True

    def __exit__(self, *exc):
        _tls.bypass = self._prev


def max_cells() -> int:
    return int(os.environ.get("GENOMICSDB_TPU_SERVING_CACHE_CELLS",
                              DEFAULT_MAX_CELLS))


class ServingIndex:
    """Full-store combined output of one query signature, sliceable by
    column interval."""

    __slots__ = ("text_blob", "line_offs", "bcf_blob", "bcf_offs",
                 "starts", "_cols", "_prefmax", "_bcf_lock")

    def __init__(self, text_blob: bytes, line_offs: np.ndarray,
                 bcf_blob: Optional[bytes],
                 bcf_offs: Optional[np.ndarray],
                 starts: np.ndarray,
                 cols_sorted: np.ndarray, prefmax_end: np.ndarray):
        self.text_blob = text_blob
        self.line_offs = line_offs          # int64 [n+1]; line i =
        # text_blob[line_offs[i]:line_offs[i+1]-1] (trailing newline)
        self.bcf_blob = bcf_blob            # concatenated BCF2 records
        self.bcf_offs = bcf_offs            # int64 [n+1]
        self.starts = starts                # int64 [n] flattened col
        self._cols = cols_sorted            # queried-row cell cols
        self._prefmax = prefmax_end         # prefix-max eff_end
        self._bcf_lock = threading.Lock()

    # -- boundary analysis ------------------------------------------------
    def clean(self, p: int) -> bool:
        """True when no queried-row cell spans the boundary just before
        `p` (col < p <= eff_end)."""
        i = int(np.searchsorted(self._cols, p, side="left"))
        return i == 0 or int(self._prefmax[i - 1]) < p

    def plan(self, lo: int, hi: int):
        """Segments serving [lo, hi] in column order:

          ('slice', a, b)  — index records [a, b) verbatim;
          ('edge', i, new_lo, new_hi, elo, ehi) — index record i with
            its start clipped to new_lo and/or its gVCF range clipped
            to end at new_hi (None = that side unclipped); when the
            record is not patch-safe (_patched_line returns None) the
            live engine recomputes [elo, ehi] instead.

        Every record start is a sweep event in ANY query interval that
        contains it, so an index record with start in [lo, hi] renders
        byte-identically inside [lo, hi] — unless its gVCF range is
        clipped at hi.  At most two records are clipped: the head (a
        cell spans lo => the query emits a clipped record AT lo) and
        the tail (a cell spans hi+1 => the last record is clipped at
        hi).  A record starting exactly at lo serves verbatim even when
        other cells span lo: the query's intersect-at-begin sweep sees
        the same live set the full scan saw at that event column."""
        starts = self.starts
        segs: list = []
        if self.clean(lo):
            a = int(np.searchsorted(starts, lo, side="left"))
        else:
            h = int(np.searchsorted(starts, lo, side="right")) - 1
            a = h + 1
            new_lo = lo if h < 0 or lo != int(starts[h]) else None
            if h < 0:
                return [("edge", h, None, None, lo, hi)]  # engine only
            if a >= len(starts) or int(starts[a]) > hi:
                # the whole query falls inside record h's range
                new_hi = hi if not self.clean(hi + 1) else None
                if new_lo is None and new_hi is None:
                    return [("slice", h, h + 1)]
                return [("edge", h, new_lo, new_hi, lo, hi)]
            if new_lo is None:
                a = h                       # record h serves verbatim
            else:
                segs.append(("edge", h, new_lo, None,
                             lo, int(starts[a]) - 1))
        b = int(np.searchsorted(starts, hi, side="right"))
        tail = None
        if not self.clean(hi + 1) and b - 1 >= a:
            t = b - 1
            b -= 1
            tail = ("edge", t, None, hi, int(starts[t]), hi)
        if b > a:
            segs.append(("slice", a, b))
        if tail is not None:
            segs.append(tail)
        return segs

    def _patched_line(self, i: int, new_lo: Optional[int],
                      new_hi: Optional[int], ref_base) -> Optional[bytes]:
        """Index record i's text line clipped to [new_lo, new_hi], or
        None when the record cannot be clipped by patching.

        A boundary-clipped combine record differs from the unclipped
        record ONLY in POS (head), REF (head: the reference base at the
        shifted start — 'N' placeholder semantics,
        vcf_writer.py:498-502 / broad_combined_gvcf.cc:824-830) and the
        INFO END= value (tail): the merged fields depend on the live
        cell set, which is identical.  That holds only when no
        non-reference allele is live — a spanning deletion rewrites
        ALT/GT/PL (handle_deletions, broad_combined_gvcf.cc:912-1078) —
        so the patch is attempted only when ALT is exactly <NON_REF>;
        anything else falls back to the live engine."""
        if i < 0:
            return None
        ln = self.text_blob[int(self.line_offs[i]):
                            int(self.line_offs[i + 1]) - 1]
        parts = ln.split(b"\t", 8)
        if len(parts) < 8 or parts[4] != b"<NON_REF>":
            return None
        info = parts[7].split(b";")
        e_idx = next((j for j, t in enumerate(info)
                      if t.startswith(b"END=")), None)
        if e_idx is None:
            return None
        s = int(self.starts[i])
        pos = int(parts[1])
        end = int(info[e_idx][4:])
        pos_f, end_f = pos, end
        if new_lo is not None and new_lo != s:
            pos_f = pos + (new_lo - s)
            parts[1] = b"%d" % pos_f
            base = "N" if ref_base is None \
                else ref_base(parts[0].decode(), pos_f - 1)
            parts[3] = base.encode()
        if new_hi is not None:
            end_f = min(end, pos + (new_hi - s))
        if end_f == pos_f:
            # 1-position record: END is not rendered
            # (vcf_writer.py:526 emits END= only when end > start)
            del info[e_idx]
            parts[7] = b";".join(info) if info else b"."
        elif end_f != end:
            info[e_idx] = b"END=%d" % end_f
            parts[7] = b";".join(info)
        return b"\t".join(parts)

    # -- serving ----------------------------------------------------------
    def ensure_bcf(self, hd, n_sample: int) -> bool:
        """Lazily encode the materialized text to concatenated BCF2
        record bytes under header dict `hd` (one encoding per index —
        the signature pins the header source, so hd is stable).  Server
        threads arriving together encode once."""
        with self._bcf_lock:
            if self.bcf_blob is not None:
                return True
            from ..runtime import native_loader as nl
            from ..vcf.bcf import _encode_record, _native_type_codes
            res = None
            if os.environ.get("GENOMICSDB_TPU_NO_NATIVE", "") in ("", "0"):
                codes = _native_type_codes(hd)
                res = nl.bcf_encode_records(
                    self.text_blob, self.line_offs, hd.contigs, hd.strings,
                    codes[0], codes[1], n_sample)
            if res is None:
                recs = []
                offs = np.empty(len(self.starts) + 1, dtype=np.int64)
                offs[0] = 0
                for i in range(len(self.starts)):
                    ln = self.text_blob[self.line_offs[i]:
                                        self.line_offs[i + 1] - 1]
                    recs.append(_encode_record(ln.decode(), hd, n_sample))
                    offs[i + 1] = offs[i] + len(recs[-1])
                res = (b"".join(recs), offs)
            # offsets first: a reader tests bcf_blob, then reads both
            self.bcf_offs = res[1]
            self.bcf_blob = res[0]
            return True

    def serve_bcf(self, lo: int, hi: int, engine_bytes_fn,
                  ref_base=None, encode_lines_fn=None) \
            -> Optional[Iterator[bytes]]:
        """BCF2 record bytes for [lo, hi]; None => caller falls back to
        the live engine.  Boundary-clipped records are patched from the
        index text and encoded via encode_lines_fn(lines) -> bytes;
        engine_bytes_fn(lo, hi) -> bytes recomputes an edge
        sub-interval when patching does not apply."""
        if self.bcf_blob is None:
            return None
        segs = self.plan(lo, hi)

        def gen():
            for seg in segs:
                if seg[0] == "slice":
                    _, a, b = seg
                    yield self.bcf_blob[int(self.bcf_offs[a]):
                                        int(self.bcf_offs[b])]
                    continue
                _, i, nl, nh, elo, ehi = seg
                chunk = None
                if encode_lines_fn is not None:
                    ln = self._patched_line(i, nl, nh, ref_base)
                    if ln is not None:
                        chunk = encode_lines_fn([ln.decode()])
                if chunk is None:
                    chunk = engine_bytes_fn(elo, ehi)
                if chunk:
                    yield chunk
        return gen()

    def serve_text(self, lo: int, hi: int, engine_lines_fn,
                   ref_base=None) -> Optional[Iterator[str]]:
        """Record lines (no trailing newline) for [lo, hi]; None =>
        engine fallback.  Boundary-clipped records are patched from the
        index text; engine_lines_fn(lo, hi) recomputes an edge
        sub-interval when patching does not apply."""
        segs = self.plan(lo, hi)

        def gen():
            for seg in segs:
                if seg[0] == "slice":
                    _, a, b = seg
                    blob = self.text_blob[int(self.line_offs[a]):
                                          int(self.line_offs[b]) - 1]
                    yield blob.decode()
                    continue
                _, i, nl, nh, elo, ehi = seg
                ln = self._patched_line(i, nl, nh, ref_base)
                if ln is not None:
                    yield ln.decode()
                else:
                    yield from engine_lines_fn(elo, ehi)
        return gen()

    def nbytes(self) -> int:
        return (len(self.text_blob)
                + (len(self.bcf_blob) if self.bcf_blob else 0)
                + self.starts.nbytes + self.line_offs.nbytes
                + (self.bcf_offs.nbytes if self.bcf_offs is not None
                   else 0)
                + self._cols.nbytes + self._prefmax.nbytes)


def _parse_starts(blob: bytes, line_offs: np.ndarray, vid) -> np.ndarray:
    """Flattened start column per record line (CHROM + POS parsed from
    the rendered text — the text is the authority)."""
    n = len(line_offs) - 1
    arr = np.frombuffer(blob, np.uint8)
    tabs = np.flatnonzero(arr == 9)
    # first/second tab of line i: tabs sorted; searchsorted per line
    t1_idx = np.searchsorted(tabs, line_offs[:-1], side="left")
    t1 = tabs[t1_idx]
    t2 = tabs[t1_idx + 1]
    starts = np.empty(n, dtype=np.int64)
    offs = line_offs
    # contig offsets recur; memoize per contig name
    coff = {}
    for i in range(n):
        chrom = blob[offs[i]:t1[i]]
        off = coff.get(chrom)
        if off is None:
            off = coff[chrom] = vid.flatten_position(chrom.decode(), 1)
        starts[i] = off + int(blob[t1[i] + 1:t2[i]]) - 1
    return starts


def sub_query(qp, vid, qc, lo: int, hi: int):
    """(sub_qp, sub_qc) cloned from (qp, qc) restricted to one column
    interval."""
    from ..core.config import QueryParams
    from .driver import make_query_config
    sub_qp = QueryParams()
    sub_qp.__dict__.update(qp.__dict__)
    sub_qp.scan_full = False
    sub_qp.column_ranges = [[(lo, hi)]]
    sub_qc = make_query_config(sub_qp, vid)
    sub_qc.rows_to_query = list(qc.rows_to_query)
    return sub_qp, sub_qc


def engine_record_lines(store, qc, qp, vid, device,
                        reference_path: Optional[str],
                        lo: int, hi: int, pack=None) -> List[str]:
    """Record lines of one sub-interval through the live engine (edge
    recompute).  Edge regions are at most ONE record, where the
    sequential engine (host) costs less than a block-engine round trip
    (GENOMICSDB_TPU_SERVING_EDGE_ENGINE=block runs the block engine on
    `device` instead); the two engines are byte-identical."""
    from .driver import iter_vcf_query_block, run_vcf_query
    sub_qp, sub_qc = sub_query(qp, vid, qc, lo, hi)
    with _Bypass():
        if os.environ.get("GENOMICSDB_TPU_SERVING_EDGE_ENGINE",
                          "sequential") != "block":
            text = run_vcf_query(store, sub_qc, sub_qp, vid,
                                 template_path=None,
                                 reference_path=reference_path)
            return [ln for ln in text.splitlines() if ln]
        out: List[str] = []
        for chunk in iter_vcf_query_block(
                store, sub_qc, sub_qp, vid, device, template_path=None,
                reference_path=reference_path, coalesce=True, pack=pack):
            out.extend(ln for ln in chunk.split("\n") if ln)
        return out


def make_ref_base(ref_genome):
    """callable(contig, pos0) -> REF base at a shifted record start,
    with the engine's exact semantics (vcf_writer.py:498-502: reference
    base when legal, else 'N').  None ref genome -> None (the patch
    path then emits the 'N' placeholder)."""
    if ref_genome is None:
        return None

    def rb(contig: str, pos0: int) -> str:
        b = ref_genome.base_at(contig, pos0)
        return b if b in ("A", "T", "G", "C") else "N"
    return rb


def encode_lines_bcf(lines: List[str], hd, n_sample: int) -> bytes:
    """Concatenated BCF2 record bytes for rendered text lines."""
    from ..vcf.bcf import _encode_blob_native, _encode_record
    if not lines:
        return b""
    blob = ("\n".join(lines) + "\n").encode()
    if len(blob) == sum(len(ln) for ln in lines) + len(lines):
        arr = np.frombuffer(blob, np.uint8)
        offs = np.empty(len(lines) + 1, np.int64)
        offs[0] = 0
        offs[1:] = np.flatnonzero(arr == 10) + 1
        enc = _encode_blob_native(blob, offs, hd, n_sample)
        if enc is not None:
            return enc
    return b"".join(_encode_record(ln, hd, n_sample) for ln in lines)


def engine_bcf_bytes(store, qc, qp, vid, device, reference_path, hd,
                     n_sample: int, lo: int, hi: int, pack=None) -> bytes:
    """Concatenated BCF2 record bytes of one edge sub-interval."""
    lines = engine_record_lines(store, qc, qp, vid, device, reference_path,
                                lo, hi, pack=pack)
    return encode_lines_bcf(lines, hd, n_sample)


def build_index(store, qc, qp, vid, device, reference_path: Optional[str],
                pack=None) -> Optional[ServingIndex]:
    """Materialize the full-store combined record TEXT for this query
    signature through the block engine on `device` (the BCF2 encoding
    attaches lazily via ensure_bcf).  Returns None when the store is
    empty."""
    from .driver import iter_vcf_query_block

    if store.num_cells == 0:
        return None
    rows = qc.rows_to_query
    sel = np.isin(store.row, rows)
    cols = store.col[sel]
    ends = store.eff_end[sel]
    if len(cols) == 0:
        return None
    order = np.argsort(cols, kind="stable")
    cols_sorted = np.ascontiguousarray(cols[order])
    prefmax = np.maximum.accumulate(ends[order])
    lo, hi = int(cols_sorted[0]), int(prefmax[-1])
    sub_qp, sub_qc = sub_query(qp, vid, qc, lo, hi)
    parts: List[bytes] = []
    with _Bypass():
        for chunk in iter_vcf_query_block(
                store, sub_qc, sub_qp, vid, device, template_path=None,
                reference_path=reference_path, coalesce=True, pack=pack):
            b = chunk.encode()
            if b:
                parts.append(b)
    if not parts:
        return None
    text_blob = b"\n".join(parts) + b"\n"
    arr = np.frombuffer(text_blob, np.uint8)
    nl_pos = np.flatnonzero(arr == 10)
    line_offs = np.empty(len(nl_pos) + 1, dtype=np.int64)
    line_offs[0] = 0
    line_offs[1:] = nl_pos + 1

    starts = _parse_starts(text_blob, line_offs, vid)
    if np.any(np.diff(starts) < 0):       # must be sorted for slicing
        return None
    return ServingIndex(text_blob, line_offs, None, None,
                        starts, cols_sorted, prefmax)


def signature(qc, qp, template_path, reference_path) -> tuple:
    return (tuple(qc.rows_to_query), tuple(qc.attributes),
            qp.produce_GT_field, qp.produce_FILTER_field,
            qp.sites_only_query,
            qp.produce_GT_with_min_PL_value_for_spanning_deletions,
            qp.max_diploid_alt_alleles_that_can_be_genotyped,
            template_path, reference_path)


def lookup(store, sig: tuple, build_fn):
    """Per-store signature-keyed cache with a query counter: the index
    is built (synchronously, by build_fn) on the BUILD_AFTER_QUERIESth
    query of one signature.  Returns the ServingIndex or None.

    A `building` flag makes the build non-reentrant: build_fn itself
    runs the full-store query through the live engine, whose inner
    lookups (same signature) must serve the direct path — and a second
    server thread arriving mid-build does the same instead of starting
    a duplicate build.  The counter and the flag change under
    _CACHE_LOCK; build_fn runs outside it."""
    if not enabled() or store.num_cells > max_cells():
        return None
    with _CACHE_LOCK:
        cache = getattr(store, "_serving_idx_cache", None)
        if cache is None:
            cache = store._serving_idx_cache = {}
        entry = cache.get(sig)
        if entry is None:
            cache[sig] = [1, None, False]
            return None
        if entry[1] is not None:
            return entry[1]
        if entry[2]:                  # build in progress (or re-entered)
            return None
        entry[0] += 1
        if entry[0] < BUILD_AFTER_QUERIES:
            return None
        entry[2] = True
    try:
        idx = build_fn()
    except BaseException:
        with _CACHE_LOCK:
            entry[2] = False
        raise
    with _CACHE_LOCK:
        entry[2] = False
        entry[1] = idx
        if idx is None:
            entry[0] = -(1 << 30)     # unbuildable: stop retrying
    return idx


def lookup_for_query(store, qc, qp, vid, device, template_path,
                     reference_path, pack=None):
    """Signature + lookup + build in one call (the driver/stream entry
    point); a build runs the block engine on `device`."""
    if not enabled():
        return None
    sig = signature(qc, qp, template_path, reference_path)
    return lookup(store, sig, lambda: build_index(
        store, qc, qp, vid, device, reference_path, pack=pack))
