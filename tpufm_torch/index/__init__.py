"""Index construction on the device, mirroring tpufm/index/:

  tpufm_torch.index.sa_device      — the suffix array by prefix doubling,
                                     one device-wide sort a round
                                     (tpufm/index/sa_device.py)
  tpufm_torch.index.builder_device — the k-step index and the locate tables
                                     from that sort, the tables by K7
                                     (csrc/build_tables.cu)
                                     (tpufm/index/builder_device.py)
  tpufm_torch.index.sa_sharded      — the suffix array sorted over a mesh
                                     of shards (tpufm/index/sa_sharded.py)
  tpufm_torch.index.builder_sharded — the index and the locate tables from
                                     that sort, K7 on each shard's rows
                                     (tpufm/index/builder_sharded.py)

The host builders stay in tpufm_torch.host; both give the same bits.
"""
