# Durability (PyTorch port of repro.ckpt): the CRC32-framed write-ahead
# journal of the mutable store and the manifest-verified snapshots that it
# and the trainer save.
