# Hand-written Hopper kernels (CUDA C++ in ../csrc/), each beside its
# plain PyTorch version and a launch counter: page_search (bottom tier),
# kary_search (top tier past 256 pages), page_scan (range scans and group
# prefixes) and cdf_search (nucleus sampling); nitrogen_codegen generates
# one kernel a NitroGen index, its separators as literals. ops.py holds the
# layout helpers and the sampler's topp_search.
