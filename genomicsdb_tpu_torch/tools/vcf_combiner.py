"""One-shot gVCF combiner (docker/vcf_combiner appliance equivalent).

Auto-generates vid/callset mappings from the input headers, imports, and
writes the combined gVCF — no hand-written configs needed.

Usage:
  python -m genomicsdb_tpu_torch.tools.vcf_combiner \
      [--reference ref.fasta.gz] [--output out.vcf] [--produce-GT] \
      in1.vcf.gz in2.vcf.gz ...
"""

from __future__ import annotations

import argparse
import sys

from ..core.config import QueryParams
from ..core.vid import VidMapper
from ..query import driver as qdriver
from ..store.import_pipeline import import_callsets
from .generate_config import generate_callsets, generate_vid
from ..vcf.reader import VCFFile


def combine(paths, reference=None, produce_GT=False, out=sys.stdout,
            template_path=None):
    headers = []
    for p in paths:
        vcf = VCFFile(p)
        headers.append(vcf.header)
        vcf.close()
    vid = VidMapper()
    vid.parse_vid(generate_vid(headers))
    vid.parse_callsets(generate_callsets(list(paths)))
    store = import_callsets(vid)
    qp = QueryParams()
    qp.scan_full = True
    qp.attributes = []
    qp.produce_GT_field = produce_GT
    qc = qdriver.make_query_config(qp, vid)
    text = qdriver.run_vcf_query(
        store, qc, qp, vid,
        template_path=template_path or paths[0],
        reference_path=reference)
    out.write(text)


def main(argv=None):
    p = argparse.ArgumentParser(prog="vcf_combiner")
    p.add_argument("inputs", nargs="+")
    p.add_argument("--reference", default=None)
    p.add_argument("--output", "-o", default="-")
    p.add_argument("--produce-GT", action="store_true")
    p.add_argument("--template-header", default=None)
    args = p.parse_args(argv)
    out = sys.stdout if args.output == "-" else open(args.output, "w")
    combine(args.inputs, reference=args.reference,
            produce_GT=args.produce_GT, out=out,
            template_path=args.template_header)
    if out is not sys.stdout:
        out.close()


if __name__ == "__main__":
    main()
