"""The CLI's host-only SAM/BAM tools and faidx: ``sort``, ``view``,
``flagstat``, ``idxstats``, ``markdup``, ``stats``, ``bedcov``, ``depth``,
``fastq``, ``faidx`` and ``merge``, which ``tpufm_torch.cli`` registers
(``add_parsers``).

    python -m tpufm_torch.cli sort IN.sam|IN.bam [--output OUT.bam]
    python -m tpufm_torch.cli view IN [REGION] [--no-header] [--output OUT]
    python -m tpufm_torch.cli flagstat|idxstats IN
    python -m tpufm_torch.cli markdup IN [--output OUT.bam|OUT.sam]
    python -m tpufm_torch.cli stats IN [--output OUT]
    python -m tpufm_torch.cli bedcov IN REGIONS.bed [--output OUT]
    python -m tpufm_torch.cli depth IN [REGION] [-a] [--output OUT]
    python -m tpufm_torch.cli fastq IN [--output OUT] [-1 FQ1 -2 FQ2]
    python -m tpufm_torch.cli faidx REF.fa [REGION ...] [--output OUT]
    python -m tpufm_torch.cli merge OUT.bam IN [IN ...]

Counterparts of tpufm/cli.py:1507-1870 (``_parse_region`` :1688, parsers
:2216-2310): the same arguments, files, standard output and exit texts.
SAM or BAM input is told apart by its magic (``read_sam_or_bam``); a REGION
is ``chr`` or ``chr:beg-end``, 1-based inclusive. None of them touches the
card, so none takes --device.
"""

from __future__ import annotations

import os
import sys

from tpufm_torch.host import faidx
from tpufm_torch.host.bam import read_sam_or_bam
from tpufm_torch.host.bam_index import (
    IndexedBam,
    bedcov,
    decode_record,
    depth,
    fastq_records,
    flagstat,
    idxstats,
    markdup,
    read_bed,
    sam_stats,
    write_bam_indexed,
)


def cmd_sort(args):
    """Coordinate-sort alignments and write a query-ready BAM + .bai —
    the `samtools sort && samtools index` step, in one command
    (host/bam_index.py)."""
    out = args.output or (args.input.rsplit(".", 1)[0] + ".sorted.bam")
    try:
        write_bam_indexed(out, read_sam_or_bam(args.input))
    except ValueError as e:  # e.g. RNAME without @SQ, QUAL/SEQ mismatch
        sys.exit(f"cannot sort {args.input}: {e}")
    print(f"wrote {out} + {out}.bai")


def cmd_markdup(args):
    """Mark PCR/optical duplicates (samtools-markdup-style): primary
    mapped records sharing a template key — (ref, unclipped 5' pos,
    strand) plus the mate's (ref, pos, strand) for proper pairs — are
    grouped; the highest-QUAL record keeps its flags, the rest gain
    0x400. Output is a sorted, indexed BAM (or SAM with an .sam
    --output). `stats`/`depth`/`flagstat` then exclude the marked
    records automatically."""
    text = read_sam_or_bam(args.input)
    header = [l for l in text.splitlines() if l.startswith("@")]
    records = [l.split("\t") for l in text.splitlines()
               if l and not l.startswith("@")]
    marked, n = markdup(records)
    out_text = "\n".join(header + ["\t".join(f) for f in marked]) + "\n"
    out = args.output or (args.input.rsplit(".", 1)[0] + ".markdup.bam")
    if out.endswith(".sam"):
        with open(out, "w") as fp:
            fp.write(out_text)
        print(f"wrote {out} ({n} duplicates marked)")
    else:
        try:
            write_bam_indexed(out, out_text)
        except ValueError as e:
            sys.exit(f"cannot write {out}: {e}")
        print(f"wrote {out} + {out}.bai ({n} duplicates marked)")


def cmd_merge(args):
    """Merge SAM/BAM files into one coordinate-sorted, indexed BAM —
    the scatter-gather companion to per-shard alignment (each shard
    aligns its read slice, merge produces the query-ready whole). All
    inputs must agree on the @SQ contig dictionary (same names, same
    order, same lengths); @PG/@RG lines are deduplicated in first-seen
    order and record order within a coordinate is stable by input."""
    sq_ref: list[str] | None = None
    header_out: list[str] = []
    seen_hdr: set[str] = set()
    records: list[str] = []
    for path in args.inputs:
        text = read_sam_or_bam(path)
        sq = [l for l in text.splitlines() if l.startswith("@SQ")]
        if sq_ref is None:
            sq_ref = sq
        elif sq != sq_ref:
            sys.exit(f"{path}: @SQ dictionary differs from {args.inputs[0]}"
                     " — merge needs identical contigs in identical order")
        for line in text.splitlines():
            if not line:
                continue
            if line.startswith("@"):
                # drop @HD: inputs may disagree on SO:, and sort_sam_text
                # emits a single fresh SO:coordinate one
                if line not in seen_hdr and not line.startswith("@HD"):
                    seen_hdr.add(line)
                    header_out.append(line)
            else:
                records.append(line)
    if sq_ref is None or not args.inputs:
        sys.exit("merge needs at least one input")
    text = "\n".join(header_out + records) + "\n"
    try:
        write_bam_indexed(args.output, text)
    except ValueError as e:
        sys.exit(f"cannot merge: {e}")
    print(f"wrote {args.output} + {args.output}.bai "
          f"({len(records)} records from {len(args.inputs)} inputs)")


def cmd_view(args):
    """Print alignments as SAM text; with a REGION ('chr' or
    'chr:beg-end', 1-based inclusive like samtools), use the .bai to
    inflate only the bgzf members holding candidate records."""
    dest = open(args.output, "w") if args.output else sys.stdout
    if args.region:
        if not os.path.exists(args.input + ".bai"):
            sys.exit(
                f"{args.input}.bai not found — region queries need the "
                "index; create it with `tpufm sort`"
            )
        ib = IndexedBam(args.input)
        contig, beg, end = _parse_region(args.region)
        if contig not in ib.ref_names:
            sys.exit(f"{contig!r} is not a contig of {args.input} "
                     f"(has: {', '.join(ib.ref_names[:8])}"
                     + ("..." if len(ib.ref_names) > 8 else "") + ")")
        if end is None:
            end = ib.ref_lengths[ib.ref_names.index(contig)]
        if not args.no_header:
            dest.write(ib.header_text)
        for rec in ib.query(contig, beg, end):
            dest.write("\t".join(decode_record(rec, ib.ref_names)) + "\n")
    else:
        text = read_sam_or_bam(args.input)
        if args.no_header:
            text = "".join(l for l in text.splitlines(keepends=True)
                           if not l.startswith("@"))
        dest.write(text)
    if args.output:
        dest.close()


def cmd_flagstat(args):
    """samtools-flagstat-style counters over a SAM/BAM file."""
    records = [l.split("\t") for l in read_sam_or_bam(args.input).splitlines()
               if l and not l.startswith("@")]
    c = flagstat(records)
    print(f"{c['total']} in total ({c['secondary']} secondary)")
    print(f"{c['primary']} primary")
    print(f"{c['mapped']} mapped")
    print(f"{c['primary_mapped']} primary mapped")
    print(f"{c['paired']} paired in sequencing")
    print(f"{c['read1']} read1")
    print(f"{c['read2']} read2")
    print(f"{c['proper']} properly paired")


def cmd_idxstats(args):
    """samtools-idxstats-style per-contig counts over a SAM/BAM file:
    one 'name\\tlength\\t#mapped\\t#unmapped' row per @SQ contig plus the
    trailing '*' row for unplaced reads."""
    text = read_sam_or_bam(args.input)
    header = "".join(l for l in text.splitlines(keepends=True)
                     if l.startswith("@"))
    records = [l.split("\t") for l in text.splitlines()
               if l and not l.startswith("@")]
    for name, length, n_mapped, n_unmapped in idxstats(header, records):
        print(f"{name}\t{length}\t{n_mapped}\t{n_unmapped}")


def cmd_stats(args):
    """samtools-stats-style summary over a SAM/BAM file: the SN section
    plus RL (read length) and IS (insert size) histograms, in the
    grep-able 'SN\\tname:\\tvalue' line format downstream QC expects."""
    records = (l.split("\t")
               for l in read_sam_or_bam(args.input).splitlines()
               if l and not l.startswith("@"))
    s = sam_stats(records)
    dest = open(args.output, "w") if args.output else sys.stdout
    print("# subset of `samtools stats`: SN + RL + IS sections; filter "
          "like `tpufm stats f.bam | grep ^SN | cut -f 2-`", file=dest)
    for name, value in s["sn"]:
        print(f"SN\t{name}:\t{value}", file=dest)
    for length, count in s["rl"].items():
        print(f"RL\t{length}\t{count}", file=dest)
    for size, count in s["is"].items():
        print(f"IS\t{size}\t{count}", file=dest)
    if args.output:
        dest.close()


def _parse_region(region: str):
    """'chr' or 'chr:beg-end' (1-based inclusive, samtools style) ->
    (contig, beg0, end_or_None) half-open."""
    if ":" not in region:
        return region, 0, None
    contig, span = region.rsplit(":", 1)
    try:
        b, e = span.split("-")
        beg, end = int(b) - 1, int(e)
    except ValueError:
        sys.exit(f"bad region {region!r}; use chr:beg-end "
                 "(1-based inclusive)")
    beg = max(beg, 0)  # samtools clamps a 1-based beg of 0
    if end <= beg:
        sys.exit(f"empty region {region!r} (end < beg)")
    return contig, beg, end


def cmd_bedcov(args):
    """samtools-bedcov-style per-region coverage sums: every original
    BED column echoed back with the region's coverage sum appended.
    Indexed BAMs answer each region from the .bai; SAM/plain BAM run ONE
    full scan, bucketed per contig, shared across all regions."""
    try:
        rows = read_bed(args.bed)
    except ValueError as e:
        sys.exit(str(e))
    regions = [(c, b, e) for c, b, e, _ in rows]
    with open(args.input, "rb") as fp:
        is_bam = fp.read(4) == b"\x1f\x8b\x08\x04"
    if is_bam and os.path.exists(args.input + ".bai"):
        ib = IndexedBam(args.input)
        names = set(ib.ref_names)
        header = ib.header_text

        def fetch(contig, beg, end):
            return [decode_record(r, ib.ref_names)
                    for r in ib.query(contig, beg, end)]
    else:
        text = read_sam_or_bam(args.input)
        header = "".join(l for l in text.splitlines(keepends=True)
                         if l.startswith("@"))
        by_contig: dict[str, list] = {}
        for l in text.splitlines():
            if l and not l.startswith("@"):
                f = l.split("\t")
                by_contig.setdefault(f[2], []).append(f)
        names = {f[3:] for l in header.splitlines() if l.startswith("@SQ")
                 for f in l.split("\t") if f.startswith("SN:")}

        def fetch(contig, beg, end):
            # depth() clips the contig's bucket to the region window
            return by_contig.get(contig, [])
    bad = [c for c, _, _ in regions if c not in names]
    if bad:
        sys.exit(f"{bad[0]!r} is not a contig of {args.input}")
    dest = open(args.output, "w") if args.output else sys.stdout
    for (_, _, _, fields), (_c, _b, _e, total) in zip(
        rows, bedcov(header, fetch, regions)
    ):
        dest.write("\t".join(fields) + f"\t{total}\n")
    if args.output:
        dest.close()


def cmd_depth(args):
    """Per-position coverage, samtools-depth semantics (skip unmapped/
    secondary/qcfail/dup; only M/=/X cover). With a REGION and an
    indexed BAM, only the bgzf members holding candidate records are
    inflated; otherwise the whole file is scanned."""
    region = _parse_region(args.region) if args.region else None
    with open(args.input, "rb") as fp:
        is_bam = fp.read(4) == b"\x1f\x8b\x08\x04"
    if region and is_bam and os.path.exists(args.input + ".bai"):
        ib = IndexedBam(args.input)
        contig, beg, end = region
        if contig not in ib.ref_names:
            sys.exit(f"{contig!r} is not a contig of {args.input}")
        if end is None:
            end = ib.ref_lengths[ib.ref_names.index(contig)]
        region = (contig, beg, end)
        header = ib.header_text
        records = [decode_record(r, ib.ref_names)
                   for r in ib.query(contig, beg, end)]
    else:
        text = read_sam_or_bam(args.input)
        header = "".join(l for l in text.splitlines(keepends=True)
                         if l.startswith("@"))
        records = [l.split("\t") for l in text.splitlines()
                   if l and not l.startswith("@")]
        if region:
            # parse @SQ SN values exactly — a substring match would let
            # any prefix of a real contig name pass (e.g. 'c' vs 'cA')
            sq_names = {f[3:] for l in header.splitlines() if l.startswith("@SQ")
                        for f in l.split("\t") if f.startswith("SN:")}
            if region[0] not in sq_names:
                sys.exit(f"{region[0]!r} is not a contig of {args.input}")
    dest = open(args.output, "w") if args.output else sys.stdout
    for name, pos1, d in depth(header, records, region=region,
                               all_positions=args.all):
        dest.write(f"{name}\t{pos1}\t{d}\n")
    if args.output:
        dest.close()


def cmd_fastq(args):
    """Export reads from SAM/BAM back to FASTQ (sequencer orientation:
    minus-strand records are reverse-complemented; secondary/
    supplementary records are skipped). With -1/-2, paired reads route
    to the two files and unpaired reads to --output/stdout; otherwise
    everything goes to one stream with /1 //2 name suffixes on mates."""
    if (args.r1 is None) != (args.r2 is None):
        sys.exit("-1 and -2 must be given together")  # before opening outputs
    records = (l.split("\t") for l in read_sam_or_bam(args.input).splitlines()
               if l and not l.startswith("@"))
    dest = open(args.output, "w") if args.output else sys.stdout
    f1 = open(args.r1, "w") if args.r1 else None
    f2 = open(args.r2, "w") if args.r2 else None
    n = [0, 0, 0]  # single, read1, read2
    for name, flag, seq, qual in fastq_records(records):
        if f1 is not None and flag & 0x1:
            out, suffix = (f1, "") if flag & 0x40 else (f2, "")
            n[1 if flag & 0x40 else 2] += 1
        else:
            suffix = ("/1" if flag & 0x40 else "/2") if flag & 0x1 else ""
            out = dest
            n[0] += flag & 0x1 == 0
            if flag & 0x1:
                n[1 if flag & 0x40 else 2] += 1
        out.write(f"@{name}{suffix}\n{seq}\n+\n{qual}\n")
    for fp in (f1, f2, dest if args.output else None):
        if fp:
            fp.close()
    print(f"{n[0]} singletons, {n[1]} read1, {n[2]} read2", file=sys.stderr)


def cmd_faidx(args):
    """Index a FASTA (writes <input>.fai, the samtools faidx format);
    with REGIONs, print the requested subsequences as FASTA instead
    (building the .fai on demand)."""
    if not args.regions:
        try:
            rows = faidx.build_fai(args.input)
        except ValueError as e:
            sys.exit(str(e))
        print(f"wrote {args.input}.fai ({len(rows)} sequences)")
        return
    try:
        if not os.path.exists(args.input + ".fai"):
            faidx.build_fai(args.input)
        fai = faidx.load_fai(args.input)
    except ValueError as e:
        sys.exit(str(e))
    dest = open(args.output, "w") if args.output else sys.stdout
    for region in args.regions:
        contig, beg, end = _parse_region(region)
        try:
            seq = faidx.fetch(args.input, contig, beg, end, fai=fai)
        except KeyError as e:
            sys.exit(str(e.args[0]))
        # samtools echoes the region as the header and wraps at 60
        dest.write(f">{region}\n")
        for off in range(0, len(seq), 60):
            dest.write(seq[off : off + 60].decode("latin-1") + "\n")
    if args.output:
        dest.close()


def add_parsers(sub) -> None:
    """Register the commands on the CLI's subparsers (tpufm/cli.py:2216-2310)."""
    so = sub.add_parser("sort", help="coordinate-sort SAM/BAM -> indexed BAM (+ .bai)")
    so.add_argument("input", help="SAM or BAM (detected by magic)")
    so.add_argument("--output", default=None, help="output BAM (default <input>.sorted.bam)")
    so.set_defaults(fn=cmd_sort)

    vw = sub.add_parser("view", help="print SAM text; REGION uses the .bai index")
    vw.add_argument("input", help="SAM or BAM")
    vw.add_argument("region", nargs="?", default=None,
                    help="'chr' or 'chr:beg-end' (1-based inclusive); needs <input>.bai from `sort`")
    vw.add_argument("--no-header", action="store_true")
    vw.add_argument("--output", default=None)
    vw.set_defaults(fn=cmd_view)

    fs = sub.add_parser("flagstat", help="alignment flag counters")
    fs.add_argument("input", help="SAM or BAM")
    fs.set_defaults(fn=cmd_flagstat)

    ix = sub.add_parser("idxstats", help="per-contig mapped/unmapped counts (SAM or BAM)")
    ix.add_argument("input", help="SAM or BAM")
    ix.set_defaults(fn=cmd_idxstats)

    md = sub.add_parser("markdup", help="mark duplicate templates (samtools markdup)")
    md.add_argument("input", help="SAM or BAM")
    md.add_argument("--output", default=None,
                    help="output path (.sam for SAM; default <input>.markdup.bam, sorted + indexed)")
    md.set_defaults(fn=cmd_markdup)

    st = sub.add_parser("stats", help="samtools-stats-style summary (SN + RL + IS sections)")
    st.add_argument("input", help="SAM or BAM")
    st.add_argument("--output", default=None)
    st.set_defaults(fn=cmd_stats)

    bc = sub.add_parser("bedcov", help="per-BED-region coverage sums (samtools bedcov)")
    bc.add_argument("input", help="SAM or BAM")
    bc.add_argument("bed", help="BED3+ file of regions")
    bc.add_argument("--output", default=None)
    bc.set_defaults(fn=cmd_bedcov)

    dp = sub.add_parser("depth", help="per-position coverage (samtools depth semantics)")
    dp.add_argument("input", help="SAM or BAM")
    dp.add_argument("region", nargs="?", default=None,
                    help="'chr' or 'chr:beg-end' (1-based inclusive); with <input>.bai, only "
                         "candidate bgzf members are inflated")
    dp.add_argument("-a", "--all", action="store_true", help="also print zero-depth positions")
    dp.add_argument("--output", default=None)
    dp.set_defaults(fn=cmd_depth)

    fq = sub.add_parser("fastq", help="export reads from SAM/BAM back to FASTQ")
    fq.add_argument("input", help="SAM or BAM")
    fq.add_argument("--output", default=None, help="FASTQ for unpaired reads (default stdout)")
    fq.add_argument("-1", dest="r1", default=None, metavar="FQ1", help="route read1 of pairs here (needs -2)")
    fq.add_argument("-2", dest="r2", default=None, metavar="FQ2", help="route read2 of pairs here (needs -1)")
    fq.set_defaults(fn=cmd_fastq)

    fa = sub.add_parser("faidx", help="index a FASTA (.fai) / fetch regions from it")
    fa.add_argument("input", help="plain (uncompressed) FASTA")
    fa.add_argument("regions", nargs="*",
                    help="'chr' or 'chr:beg-end' (1-based inclusive); prints FASTA instead of "
                         "writing the index")
    fa.add_argument("--output", default=None)
    fa.set_defaults(fn=cmd_faidx)

    mg = sub.add_parser("merge", help="merge SAM/BAMs into one sorted, indexed BAM")
    mg.add_argument("output", help="output .bam (a .bai is written too)")
    mg.add_argument("inputs", nargs="+", help="SAM or BAM inputs")
    mg.set_defaults(fn=cmd_merge)
