"""Host side of the port: what runs around the device search.

Counterparts of tpufm's jax-free host modules, carried here so that the
port needs nothing of the tpufm package:

  tpufm_torch.host.index        — IndexConfig, KStepFMIndex, build_index,
                                  derive_tail (tpufm/config.py,
                                  tpufm/index/builder.py)
  tpufm_torch.host.suffix_array — SA-IS (csrc/sais.cpp) and numpy doubling
  tpufm_torch.host.formats      — .fmi, .npz and .tpufm index files (and
                                  .tpufm stores of locate tables), read
                                  and written
  tpufm_torch.host.seqio        — 2-bit encoding, FASTA/FASTQ reads, their
                                  names, qualities and sizes, sampled reads
                                  and read pairs, .res results
  tpufm_torch.host.oracle       — plain numpy backward search, the ground
                                  truth the device search is held against
  tpufm_torch.host.locate       — sampled-SA locate tables (build_locate)
                                  and the numpy locate oracle
                                  (tpufm/index/locate.py)
  tpufm_torch.host.contigs      — the multi-FASTA record map
                                  (tpufm/io/contigs.py)
  tpufm_torch.host.align        — edit re-alignment for CIGARs
                                  (tpufm/utils/align.py)
  tpufm_torch.host.sam          — SAM records, single, edit and paired
                                  (tpufm/io/sam.py; the native record
                                  emitter csrc/samemit.cpp)
  tpufm_torch.host.bam          — BAM and bgzf, written and read
                                  (tpufm/io/bam.py)

Every array is numpy and bit-identical to tpufm's (and every SAM and BAM
byte); the tests hold each function against its tpufm counterpart.
"""
