# Durability for the mutable store (PyTorch port of repro.ckpt): the
# CRC32-framed write-ahead journal and the manifest-verified snapshots.
