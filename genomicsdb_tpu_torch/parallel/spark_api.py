"""Spark-style input-format layer (pure Python, pyspark optional); the
port's copy of `genomicsdb_tpu.parallel.spark_api`, whose combined-VCF
task takes the torch device of the block engine.

The reference's Spark integration (SURVEY.md 2.7:
spark/GenomicsDBInputFormat.java:65 getSplits — one split per
(column partition x query block); GenomicsDBRecordReader wrapping
GenomicsDBFeatureReader; Scala GenomicsDBRDD/GenomicsDBContext).

Here the same decomposition is plain Python so any distributed runner
(pyspark, multiprocessing, ray, torch.distributed) can map over the splits;
`build_rdd` wires it to a real SparkContext when pyspark is installed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

from ..core.config import ImportParams, QueryParams, INT64_MAX


@dataclass(frozen=True)
class InputSplit:
    """One unit of distributed query work (GenomicsDBInputSplit)."""
    rank: int                      # column-partition index
    partition_begin: int
    partition_end: int             # inclusive; INT64_MAX-2 = unbounded
    query_begin: int               # query block clamped to the partition
    query_end: int

    @property
    def interval(self) -> Tuple[int, int]:
        return (self.query_begin, self.query_end)


def get_splits(ip: Optional[ImportParams], qp: QueryParams,
               query_block_size: int = 0) -> List[InputSplit]:
    """One split per (column partition x query block)
    (GenomicsDBInputFormat.getSplits).

    query blocks come from qp.column_ranges (all ranks' ranges); with
    query_block_size > 0 each range is further chopped into fixed-size
    blocks for finer parallelism."""
    if ip is not None and ip.column_partitions:
        parts = []
        for r in range(len(ip.column_partitions)):
            b, e = ip.partition_bounds(r)
            parts.append((r, b, e if e is not None else INT64_MAX - 2))
    else:
        parts = [(0, 0, INT64_MAX - 2)]
    ranges: List[Tuple[int, int]] = []
    for rank_ranges in (qp.column_ranges or [[(0, INT64_MAX - 2)]]):
        ranges.extend(rank_ranges)
    if not ranges:
        ranges = [(0, INT64_MAX - 2)]
    blocks: List[Tuple[int, int]] = []
    for lo, hi in ranges:
        if query_block_size and query_block_size > 0:
            b = lo
            while b <= hi:
                blocks.append((b, min(b + query_block_size - 1, hi)))
                b += query_block_size
        else:
            blocks.append((lo, hi))
    splits: List[InputSplit] = []
    for rank, pb, pe in parts:
        for lo, hi in blocks:
            qlo, qhi = max(lo, pb), min(hi, pe)
            if qlo <= qhi:
                splits.append(InputSplit(rank, pb, pe, qlo, qhi))
    return splits


def open_split_store(split: InputSplit, ip: Optional[ImportParams],
                     vid):
    """Open the split's partition: the PERSISTED workspace array named
    by the loader's column partition when it exists (the reference
    executors read HDFS-resident TileDB arrays, run_spark_hdfs.py),
    else import live from the loader's callsets."""
    if ip is not None and ip.column_partitions:
        parts = sorted(ip.column_partitions,
                       key=lambda p: int(p["begin"]))
        if split.rank < len(parts):
            part = parts[split.rank]
            w = ip.resolve(part.get("workspace", "")) \
                if part.get("workspace") else ""
            a = part.get("array_name") or part.get("array") or ""
            from ..store import workspace as ws
            if w and a and ws.is_workspace(w) and ws.array_exists(w, a):
                return ws.open_array(w, a)
    if ip is not None:
        from ..query import driver
        return driver.build_store_from_loader(ip, vid, split.rank)
    return None


def render_split_vcf(split: InputSplit, qp: QueryParams, vid,
                     ip: Optional[ImportParams],
                     with_header: bool = False, device="cuda"):
    """Executor task: this split's slice of the combined VCF as text
    lines (the reference's per-executor GenomicsDBRecordReader +
    htsjdk rendering), combined by the block engine on the torch
    `device` ("cuda" raises where no card is visible).  Gathering the
    per-split lists in split order reproduces the single-process query
    byte for byte."""
    from ..device import resolve_device
    from ..query import driver
    store = open_split_store(split, ip, vid)
    sub = QueryParams()
    sub.__dict__.update(qp.__dict__)
    sub.scan_full = False
    sub.column_ranges = [[split.interval]]
    qc = driver.make_query_config(sub, vid)
    template = sub.resolve(sub.vcf_header_filename) \
        if with_header and sub.vcf_header_filename else None
    if template is None and with_header and ip is not None \
            and ip.vcf_header_filename:
        template = ip.resolve(ip.vcf_header_filename)
    refg = sub.resolve(sub.reference_genome) if sub.reference_genome \
        else (ip.resolve(ip.reference_genome)
              if ip and ip.reference_genome else None)
    text = driver.run_vcf_query_block(store, qc, sub, vid,
                                      resolve_device(device),
                                      template_path=template,
                                      reference_path=refg)
    return [ln for ln in text.split("\n") if ln]


class RecordReader:
    """Iterates one split's records (GenomicsDBRecordReader): opens the
    split's partition store and yields (contig, pos_1based, Variant)."""

    def __init__(self, split: InputSplit, qp: QueryParams, vid,
                 store=None, ip: Optional[ImportParams] = None):
        from ..query import driver
        from ..query.stream import FeatureReader
        self.split = split
        if store is None:
            store = open_split_store(split, ip, vid)
        if store is None:
            raise ValueError("RecordReader needs a store or ImportParams")
        qc = driver.make_query_config(qp, vid)
        self._reader = FeatureReader(store, qc, vid)
        self._vid = vid

    def __iter__(self) -> Iterator:
        from ..query.scan import scan_variants
        for variant in scan_variants(self._reader.store, self._reader.qc,
                                     self.split.interval):
            loc = self._vid.get_contig_location(variant.start)
            yield (loc[0], loc[1] + 1, variant)


def read_split(split: InputSplit, qp: QueryParams, vid,
               ip: Optional[ImportParams] = None, store=None) -> list:
    """Materialize one split (the map function shipped to executors)."""
    return list(RecordReader(split, qp, vid, store=store, ip=ip))


def _read_split_task(split: InputSplit, qp: QueryParams, vid,
                     ip: Optional[ImportParams]) -> list:
    """Module-level executor task (lambdas don't survive stdlib
    pickling to executor processes; a partial of this does — and works
    identically under pyspark's cloudpickle)."""
    return read_split(split, qp, vid, ip=ip)


def build_rdd(sc, ip: ImportParams, qp: QueryParams, vid,
              query_block_size: int = 0):
    """GenomicsDBRDD: parallelize splits over a SparkContext.

    `sc` is a live pyspark SparkContext when pyspark is installed, or
    parallel.local_spark.LocalSparkContext — a process-isolated
    executor implementing the same RDD API subset — where it is not.
    Each executor re-opens its split's partition via the loader config
    (the reference's per-executor GenomicsDBRecordReader pattern,
    spark/GenomicsDBInputFormat.java:65)."""
    import functools
    splits = get_splits(ip, qp, query_block_size)
    task = functools.partial(_read_split_task, qp=qp, vid=vid, ip=ip)
    return sc.parallelize(splits, len(splits)).flatMap(task)
