# Hand-written Hopper kernels (CUDA C++ in ../csrc/), each beside its
# plain PyTorch version and a launch counter: page_search (bottom tier) and
# kary_search (top tier past 256 pages). ops.py holds the layout helpers.
