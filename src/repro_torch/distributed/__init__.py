"""The sharded pub/sub plane of the PyTorch port (``stream_sharding``):
streams partitioned into shards that are emulated on one device."""
